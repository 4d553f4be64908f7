"""The port's dense attention layers against the JAX reference, function
by function, on numpy inputs at smoke widths (head dim 16): ``apply_rope``;
``_sdpa`` at group sizes g = H / Hk of 1, 3 and 4 under every mask it
takes (none, causal, causal with a window, a query offset, explicit key
positions with unwritten slots); ``attention_fwd`` without a cache, with a
linear KV cache (one write that clamps at S_max - S, as
``dynamic_update_slice`` does) and with a ring buffer written past its
window (one write that wraps and clamps), each with and without the QKV
bias; ``swiglu_fwd`` and ``gelu_mlp_fwd`` (the tanh GELU); and the module
holders' parameter names and shapes against the reference's param trees,
which ``convert.lm_params_from_arrays`` relies on.

The reference runs eagerly (not under ``jit``). Tolerance ``atol=rtol=1e-4``
on every output and cache entry (float32; the port sums in another order),
the model tests' tolerance against the reference; cache positions and
lengths exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
from repro.configs import smoke_config as j_smoke
from repro.models.config import get_config as j_get
from repro_torch.configs import smoke_config
from repro_torch.models import layers as TL
from repro_torch.models.config import get_config

TOL = 1e-4
HD = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """(reference, port) smoke ``lm-100m`` configs with ``kw`` replaced."""
    return (dataclasses.replace(j_smoke(j_get("lm-100m")), **kw),
            dataclasses.replace(smoke_config(get_config("lm-100m")), **kw))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _params(rng, cfg, bias: bool) -> dict:
    """Attention weights as numpy, biases (if any) drawn nonzero."""
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    p = {"wq": rng.standard_normal((d, h, HD)) / np.sqrt(d),
         "wk": rng.standard_normal((d, hk, HD)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hk, HD)) / np.sqrt(d),
         "wo": rng.standard_normal((h, HD, d)) / np.sqrt(h * HD)}
    if bias:
        p.update(bq=0.1 * rng.standard_normal((h, HD)),
                 bk=0.1 * rng.standard_normal((hk, HD)),
                 bv=0.1 * rng.standard_normal((hk, HD)))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, HD)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    pos[0] = np.arange(7)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, want)
    _close(TL.rope_freqs(HD, theta), JL.rope_freqs(HD, theta), 1e-7)


# (sq, sk, causal, window, q_offset, kpos) per mask case
_MASKS = {
    "none": (5, 5, False, None, 0, None),
    "causal": (6, 6, True, None, 0, None),
    "window": (7, 7, True, 3, 0, None),
    "q_offset": (3, 9, True, None, 4, None),
    # a ring buffer of 8 slots after 11 tokens (slot j holds the latest
    # position = j mod 8) and a half-written one (-1: unwritten)
    "kpos": (2, 8, True, 5, 11, [8, 9, 10, 11, 12, 5, 6, 7]),
    "kpos_unwritten": (3, 8, True, None, 2, [0, 1, 2, 3, 4, -1, -1, -1]),
}


@pytest.mark.parametrize("mask", list(_MASKS))
@pytest.mark.parametrize("heads", [(4, 4), (12, 4), (4, 1)],
                         ids=["g1", "g3", "g4"])
def test_sdpa_matches_reference(mask, heads):
    sq, sk, causal, window, q_offset, kpos = _MASKS[mask]
    h, hk = heads
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, sq, h, HD)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, hk, HD)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    jk = tk = None
    if kpos is not None:
        jk, tk = _both(np.array(kpos, np.int32))
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kpos=jk,
                    **kw)
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), kpos=tk, **kw)
    assert got.shape == (2, sq, h, HD)
    _close(got, want)


def test_sdpa_fully_masked_row_matches_reference():
    """A query that sees no key (every slot unwritten): the -1e30 fill
    gives the reference's uniform average, not NaN."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 2, 4, HD)).astype(np.float32)
    k, v = (rng.standard_normal((1, 4, 2, HD)).astype(np.float32)
            for _ in range(2))
    kpos = np.full(4, -1, np.int32)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=True, window=None, kpos=jnp.asarray(kpos))
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), causal=True, window=None,
                   kpos=torch.from_numpy(kpos))
    assert bool(torch.isfinite(got).all())
    _close(got, want)
    _close(got[0, 0, 0], v[0, :, 0].mean(0))


def _ring(rng, b, s_max, hk, length):
    """A ring-buffer cache after ``length`` tokens: random k/v, each slot's
    position the latest p < length with p % s_max == slot (-1: none)."""
    slots = np.arange(s_max)
    pos = np.where(slots < length,
                   slots + s_max * ((length - 1 - slots) // s_max), -1)
    return {"k": rng.standard_normal((b, s_max, hk, HD)).astype(np.float32),
            "v": rng.standard_normal((b, s_max, hk, HD)).astype(np.float32),
            "pos": np.broadcast_to(pos.astype(np.int32), (b, s_max)).copy(),
            "length": length}


# (S, cache layout, S_max, length, window)
_CACHES = {
    "none": (9, None, 0, 0, None),
    "linear": (3, "linear", 12, 5, None),
    "linear_clamped": (4, "linear", 10, 8, None),    # writes at 6, not 8
    "ring_past_window": (1, "ring", 8, 19, 8),
    "ring_wraps_clamped": (3, "ring", 8, 14, 8),     # slot 6 + 3 > 8
}


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("case", list(_CACHES))
def test_attention_fwd_matches_reference(case, bias):
    s, layout, s_max, length, window = _CACHES[case]
    jcfg, tcfg = _cfgs(n_heads=6, n_kv_heads=2, attn_bias=bias)
    rng = np.random.default_rng(3)
    p = _params(rng, jcfg, bias)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(length, length + s, dtype=np.int32),
                          (2, s)).copy()
    jcache = tcache = None
    if layout == "ring":
        c = _ring(rng, 2, s_max, jcfg.n_kv_heads, length)
    elif layout == "linear":
        c = {"k": rng.standard_normal((2, s_max, 2, HD)).astype(np.float32),
             "v": rng.standard_normal((2, s_max, 2, HD)).astype(np.float32),
             "length": length}
    if layout:
        jcache = {k: (jnp.int32(v) if k == "length" else jnp.asarray(v))
                  for k, v in c.items()}
        tcache = {k: (v if k == "length" else torch.from_numpy(v))
                  for k, v in c.items()}
    want, wc = JL.attention_fwd({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
                                cache=jcache, causal=True, window=window)
    got, tc = TL.attention_fwd({k: torch.from_numpy(v) for k, v in
                                p.items()}, torch.from_numpy(x), tcfg,
                               pos=torch.from_numpy(pos), cache=tcache,
                               causal=True, window=window)
    _close(got, want)
    assert (tc is None) == (wc is None)
    if tc is not None:
        assert set(tc) == set(wc)
        assert tc["length"] == int(wc["length"]) == length + s
        for key in ("k", "v"):
            _close(tc[key], wc[key])
        if "pos" in tc:
            np.testing.assert_array_equal(tc["pos"].numpy(), wc["pos"])
        # the cache passed in is left as it was
        np.testing.assert_array_equal(tcache["k"].numpy(), c["k"])


def test_attention_module_runs_the_functional_forward():
    jcfg, tcfg = _cfgs(n_heads=4, n_kv_heads=2, attn_bias=True)
    attn = TL.Attention(tcfg, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 5, tcfg.d_model)).astype(np.float32))
    pos = torch.arange(5).expand(2, 5)
    out, cache = attn(x, pos, window=3)
    want, _ = TL.attention_fwd(dict(attn.named_parameters()), x, tcfg,
                               pos=pos, window=3)
    assert cache is None and torch.equal(out, want)


def test_swiglu_matches_reference():
    rng = np.random.default_rng(5)
    d, ff = 64, 96
    p = {"w_gate": rng.standard_normal((d, ff)) / 8,
         "w_up": rng.standard_normal((d, ff)) / 8,
         "w_down": rng.standard_normal((ff, d)) / 10}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = JL.swiglu_fwd({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x))
    got = TL.swiglu_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    _close(got, want)


def test_gelu_mlp_matches_reference_tanh_gelu():
    """``jax.nn.gelu`` defaults to the tanh approximation: the port matches
    it, and the exact (erf) GELU would not, on these inputs."""
    rng = np.random.default_rng(6)
    d, ff = 64, 96
    p = {"w1": rng.standard_normal((d, ff)) / 4,
         "b1": 0.5 * rng.standard_normal((ff,)),
         "w2": rng.standard_normal((ff, d)) / 3,
         "b2": 0.1 * rng.standard_normal((d,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    want = JL.gelu_mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    _close(TL.gelu_mlp_fwd(tp, xt), want)
    exact = torch.nn.functional.gelu(xt @ tp["w1"] + tp["b1"]) @ tp["w2"] \
        + tp["b2"]
    assert not np.allclose(exact.numpy(), np.asarray(want), atol=TOL,
                           rtol=TOL)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_module_parameters_carry_the_reference_names(bias):
    import jax
    jcfg, tcfg = _cfgs(n_heads=6, n_kv_heads=2, attn_bias=bias)
    key = jax.random.PRNGKey(0)
    d, ff = jcfg.d_model, jcfg.d_ff
    for ref, mod in ((JL.init_attention(key, jcfg, jnp.float32),
                      TL.Attention(tcfg, device="meta")),
                     (JL.init_swiglu(key, d, ff, jnp.float32),
                      TL.SwiGLU(d, ff, device="meta")),
                     (JL.init_gelu_mlp(key, d, ff, jnp.float32),
                      TL.GeluMLP(d, ff, device="meta"))):
        got = {n: tuple(p.shape) for n, p in mod.named_parameters()}
        assert got == {n: tuple(a.shape) for n, a in ref.items()}
        assert all(not p.requires_grad for p in mod.parameters())
