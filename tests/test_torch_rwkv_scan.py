"""The port's ``rwkv_scan`` (plain version, and the wrapper on CPU tensors)
vs the JAX reference's ``_rwkv_scan_core`` and its Pallas ``rwkv_scan`` in
interpret mode, on the reference test's cases (``tests/test_kernels.py``),
the decode shape (S = 1) and head dims that are not a power of two (12,
48); input validation; the kernel's layout (``scan_plan``) and a plain
model of its order of operations; and the CUDA kernel vs its plain version
(on the card only).

Tolerances: against the reference, ``atol=1e-4`` (the reference test's own,
kernel vs scan). The kernel's order of operations and, on the card, the
kernel vs the plain version within ``1e-5 * max(1, max|plain|)``: the
kernel splits the columns over CTAs, sums each column in row groups, adds
the bonus term once a step (v_j times sum_i r_i u_i k_i) and nvcc
contracts into FMAs, so the two agree to float32 rounding, not bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import rwkv_scan as j_rwkv_scan
from repro.models.layers import _rwkv_scan_core
from repro_torch.kernels import rwkv_scan as trwkv

ATOL = 1e-4
CARD_RTOL = 1e-5
CASES = [(2, 17, 3, 8), (1, 64, 2, 16), (2, 1, 3, 8), (3, 1, 2, 16),
         (2, 9, 2, 12), (1, 5, 2, 48)]


def _inputs(b, s, h, hd, seed=3):
    """The reference test's distributions, drawn with numpy: normal r, k,
    v; w = exp(-clip(exp(N), 0, 5)); u = 0.1 N; state0 = 0.3 N."""
    rng = np.random.default_rng(seed)
    r, k, v, x = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.clip(np.exp(x), 0, 5)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("b,s,h,hd", CASES)
def test_plain_and_wrapper_match_reference(b, s, h, hd):
    ins = _inputs(b, s, h, hd)
    out_r, st_r = (np.asarray(a) for a in
                   _rwkv_scan_core(*(jnp.asarray(a) for a in ins)))
    out_p, st_p = (np.asarray(a) for a in
                   j_rwkv_scan(*(jnp.asarray(a) for a in ins),
                               interpret=True))
    t_ins = [torch.from_numpy(a) for a in ins]
    for fn in (trwkv.rwkv_scan_plain, trwkv.rwkv_scan):
        out, st = fn(*t_ins)
        assert out.dtype == st.dtype == torch.float32
        assert out.shape == (b, s, h, hd) and st.shape == (b, h, hd, hd)
        for want_o, want_s in ((out_r, st_r), (out_p, st_p)):
            np.testing.assert_allclose(out.numpy(), want_o, atol=ATOL)
            np.testing.assert_allclose(st.numpy(), want_s, atol=ATOL)


def test_wrapper_upcasts_and_reads_strided_inputs():
    """bf16 inputs are upcast before any arithmetic, and [B, S, H, hd] views
    of a wider array (strided in S) give the contiguous result."""
    b, s, h, hd = 2, 9, 2, 8
    ins = [torch.from_numpy(a) for a in _inputs(b, s, h, hd, seed=5)]
    bf = [t.to(torch.bfloat16) for t in ins]
    out, st = trwkv.rwkv_scan(*bf)
    want_o, want_s = trwkv.rwkv_scan_plain(*(t.float() for t in bf))
    assert out.dtype == torch.float32
    assert torch.equal(out, want_o) and torch.equal(st, want_s)
    wide = torch.cat(ins[:4], dim=-1)        # [B, S, H, 4*hd]
    views = [wide[..., i * hd:(i + 1) * hd] for i in range(4)]
    assert not views[1].is_contiguous()
    out, st = trwkv.rwkv_scan(*views, *ins[4:])
    want_o, want_s = trwkv.rwkv_scan_plain(*ins)
    assert torch.equal(out, want_o) and torch.equal(st, want_s)


@pytest.mark.parametrize("bad", ["rank", "k_shape", "u_shape", "s0_shape",
                                 "int_dtype"])
def test_wrapper_validates_inputs(bad):
    b, s, h, hd = 1, 4, 2, 8
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(b, s, h, hd))
    if bad == "rank":
        r = r[0]
    elif bad == "k_shape":
        k = k[:, :3]
    elif bad == "u_shape":
        u = u[:1]
    elif bad == "s0_shape":
        s0 = s0[..., :4]
    else:
        v = v.to(torch.int32)
    with pytest.raises(ValueError, match="rwkv_scan"):
        trwkv.rwkv_scan(r, k, v, w, u, s0)


def test_scan_plan_covers_every_head_dim():
    """Every hd gets one of the layouts the kernel is built for: (row
    groups, rows a lane) = (1, 4), (1, 8), (2, 8), (4, 8), (8, 8), (8, 12)
    or (8, 16), 8 x 16 in panels past 128 rows; warps of ``32 / groups``
    column groups of 4 columns, two warps a CTA; panels that cover the
    head, with less than a chunk a row group of padding."""
    built = {(1, 4), (1, 8), (2, 8), (4, 8), (8, 8), (8, 12), (8, 16)}
    for hd in range(1, 300):
        groups, rows, nct, warps, cols, panels = trwkv.scan_plan(hd)
        assert (groups, rows // groups) in built
        assert (nct, warps) == (trwkv.COLS_PER_LANE, trwkv.WARPS_PER_CTA)
        assert cols == warps * (32 // groups) * nct
        if panels > 1:
            assert (groups, rows) == (8, 128)
        assert rows * panels >= hd > rows * (panels - 1)
        assert (panels == 1) == (hd <= trwkv.PANEL)
        if hd <= trwkv.PANEL:
            assert rows - hd < 4 * groups


def _kernel_order_model(r, k, v, w, u, s0):
    """The CUDA kernel's order of operations in plain PyTorch: each CTA's
    column slice on its own; per panel of rows, per step, each row group's
    sum of r_i S_ij over its float4 chunks (chunk q * groups + g), the
    groups met by xor-butterfly, then v_j times the bonus scalar sum_i
    r_i u_i k_i over the panel's rows added; panels accumulate into out.
    Rows and columns past hd are zero."""
    b, s, h, hd = r.shape
    groups, rows, _, _, cols, panels = trwkv.scan_plan(hd)
    hp, cp = rows * panels, -(-hd // cols) * cols

    def pad(x, n):
        return torch.nn.functional.pad(x, (0, n - x.shape[-1]))

    rp, kp, wp = (pad(x, hp) for x in (r, k, w))
    vp, up = pad(v, cp), pad(u, hp)
    st0 = torch.nn.functional.pad(s0, (0, cp - hd, 0, hp - hd))
    out = torch.zeros((b, s, h, cp))
    s_t = torch.zeros((b, h, hp, cp))
    lanes = torch.arange(groups)
    for c0 in range(0, cp, cols):
        for i0 in range(0, hp, rows):
            st = st0[:, :, i0:i0 + rows, c0:c0 + cols].clone()
            for t in range(s):
                rr, kk, ww = (x[:, t, :, i0:i0 + rows] for x in (rp, kp, wp))
                vv = vp[:, t, :, c0:c0 + cols]
                prod = rr[..., None] * st                  # [b, h, rows, cols]
                part = prod.reshape(b, h, -1, groups, 4, cols).sum(dim=4)
                part = part.sum(dim=2)                     # [b, h, groups, cols]
                o = 1
                while o < groups:
                    part = part + part[:, :, lanes ^ o]
                    o *= 2
                bonus = (rr * kk * up[:, i0:i0 + rows]).sum(-1)  # [b, h]
                out[:, t, :, c0:c0 + cols] += (part[:, :, 0]
                                               + vv * bonus[..., None])
                st = ww[..., None] * st + kk[..., None] * vv[..., None, :]
            s_t[:, :, i0:i0 + rows, c0:c0 + cols] = st
    return out[..., :hd], s_t[:, :, :hd, :hd]


@pytest.mark.parametrize("hd", [4, 12, 48, 64, 96, 128, 160])
def test_kernel_order_model_matches_plain(hd):
    """The kernel's column split, row groups, hoisted bonus term and (at
    hd = 160) two panels of rows, modelled in plain PyTorch, agree with
    ``rwkv_scan_plain`` within 1e-5 * max(1, max|plain|)."""
    ins = [torch.from_numpy(a) for a in _inputs(2, 9, 2, hd, seed=hd)]
    got = _kernel_order_model(*ins)
    want = trwkv.rwkv_scan_plain(*ins)
    for g, wnt in zip(got, want):
        tol = CARD_RTOL * max(1.0, float(wnt.abs().max()))
        assert float((g - wnt).abs().max()) <= tol


def test_wrapper_refuses_other_devices(monkeypatch):
    """On the meta device (the dry run) the wrapper gives the outputs'
    shapes and runs neither the kernel nor the plain version; inputs that
    need a gradient are refused there too."""
    def refuse(*_a, **_k):
        raise AssertionError("ran on meta")
    monkeypatch.setattr(trwkv, "rwkv_scan_plain", refuse)
    monkeypatch.setattr(trwkv, "_library", refuse)
    ins = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 2, 8)]
    out, state = trwkv.rwkv_scan(*ins)
    assert out.device.type == state.device.type == "meta"
    assert out.shape == (1, 2, 2, 8) and state.shape == (1, 2, 8, 8)
    assert out.dtype == state.dtype == torch.float32
    ins[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        trwkv.rwkv_scan(*ins)


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version (on the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", CASES + [
    (2, 33, 4, 32), (2, 300, 4, 64),
    *((b, s, 2, hd) for hd, b in ((12, 2), (48, 2), (96, 1), (128, 1))
      for s in (1, 17)),
    (1, 17, 2, 13), (1, 17, 2, 160), (1, 40, 2, 300)])
def test_kernel_matches_plain_on_card(b, s, h, hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    ins = [torch.from_numpy(a).cuda() for a in _inputs(b, s, h, hd)]
    before = trwkv.rwkv_scan.launches
    out, st = trwkv.rwkv_scan(*ins)
    want_o, want_s = trwkv.rwkv_scan_plain(*ins)
    torch.cuda.synchronize()
    assert trwkv.rwkv_scan.launches == before + 1
    for got, want in ((out, want_o), (st, want_s)):
        tol = CARD_RTOL * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= tol
    again = trwkv.rwkv_scan(*ins)
    assert torch.equal(again[0], out) and torch.equal(again[1], st)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [12, 64, 160])
def test_kernel_reads_unaligned_inputs_on_card(hd):
    """Views that cannot be copied 16 bytes at a time (one float off
    alignment: the inputs, and the state): within the same tolerance of
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    b, s, h = 2, 21, 2
    ins = [torch.from_numpy(a).cuda() for a in _inputs(b, s, h, hd, seed=7)]
    want = trwkv.rwkv_scan_plain(*ins)
    wide = torch.zeros((b, s, h, 4 * hd + 1), device="cuda")
    for i in range(4):
        wide[..., 1 + i * hd:1 + (i + 1) * hd] = ins[i]
    views = [wide[..., 1 + i * hd:1 + (i + 1) * hd] for i in range(4)]
    flat = torch.zeros(ins[5].numel() + 1, device="cuda")
    flat[1:] = ins[5].flatten()
    s0_off = flat[1:].view(ins[5].shape)        # contiguous, 4 bytes off
    runs = [trwkv.rwkv_scan(*views, *ins[4:]),
            trwkv.rwkv_scan(*ins[:5], s0_off)]
    torch.cuda.synchronize()
    for got in runs:
        for g, wnt in zip(got, want):
            tol = CARD_RTOL * max(1.0, float(wnt.abs().max()))
            assert float((g - wnt).abs().max()) <= tol
