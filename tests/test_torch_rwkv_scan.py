"""The port's ``rwkv_scan`` (plain version, and the wrapper on CPU tensors)
vs the JAX reference's ``_rwkv_scan_core`` and its Pallas ``rwkv_scan`` in
interpret mode, on the reference test's cases (``tests/test_kernels.py``)
and the decode shape (S = 1); input validation; and the CUDA kernel vs its
plain version (on the card only).

Tolerances: against the reference, ``atol=1e-4`` (the reference test's own,
kernel vs scan). On the card, kernel vs plain version within
``1e-5 * max(1, max|plain|)``: the kernel sums each column in row groups
and nvcc contracts into FMAs, so the two agree to float32 rounding, not
bitwise.
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
CASES = [(2, 17, 3, 8), (1, 64, 2, 16), (2, 1, 3, 8), (3, 1, 2, 16)]


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
                                 "int_dtype", "head_dim"])
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
    elif bad == "int_dtype":
        v = v.to(torch.int32)
    else:
        r, k, v, w, u, s0 = (torch.from_numpy(a)
                             for a in _inputs(b, s, h, 12))
    with pytest.raises(ValueError, match="rwkv_scan"):
        trwkv.rwkv_scan(r, k, v, w, u, s0)


def test_wrapper_refuses_other_devices():
    ins = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 2, 8)]
    with pytest.raises(ValueError, match="no kernel for meta"):
        trwkv.rwkv_scan(*ins)


# ---------------------------------------------------------------------------
# the CUDA kernel vs its plain version (on the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", CASES + [(2, 33, 4, 32),
                                              (2, 300, 4, 64)])
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
