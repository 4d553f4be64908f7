"""The port's RWKV-6 serving path vs the JAX reference, at the smoke size
of ``rwkv6-7b`` (2 layers, d_model 64, 4 heads of 16, vocab 256), with the
reference's parameters carried across by ``convert.lm_params_from_arrays``
(the bonus ``u`` drawn nonzero, so that its term is exercised): the time
mix and channel mix with and without a cache, ``forward_logits`` against
both of the reference's cores (``RWKV_CHUNK`` 0 and 16), ``decode_step``
token by token from one and the same cache (``decode_cache_from_arrays``),
the port of ``test_decode_matches_parallel_forward``, ``greedy_generate``,
the full config's parameter count and the ``serve_lm`` command line.

Tolerances: against the reference, ``atol=rtol=1e-4`` on every output and
cache entry (float32 throughout; the sums run in another order, and the
reference's chunked core differs from its scan by up to 4.9e-7 on these
logits). The port against itself, decode vs parallel forward, keeps the
reference test's ``atol=rtol=2e-3``. Greedy tokens must equal the
reference's up to the first step of a row where the reference's top-2
logit margin is at most ten times the 1e-4 tolerance.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.model as JM
from repro.configs import smoke_config as j_smoke
from repro.models.config import get_config as j_get
from repro.train.serve_step import greedy_generate as j_greedy
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill_step)

TOL = 1e-4
PARALLEL_TOL = 2e-3
SRC = Path(__file__).resolve().parents[1] / "src"
J_CFG = j_smoke(j_get("rwkv6-7b"))
T_CFG = smoke_config(get_config("rwkv6-7b"))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def models():
    """(reference params, port LM) holding the same weights; every layer's
    ``u`` drawn as 0.1 N(0, 1) with numpy."""
    params = JM.init_params(J_CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    mixer = dict(params["body"][0]["mixer"])
    mixer["u"] = jnp.asarray(
        0.1 * rng.standard_normal(mixer["u"].shape).astype(np.float32))
    params["body"][0] = dict(params["body"][0], mixer=mixer)
    tree = jax.tree.map(np.asarray, params)
    return params, convert.lm_params_from_arrays(T_CFG, tree, device="cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, J_CFG.vocab, (b, s)).astype(np.int32)


def _ref_layer(params, li):
    return jax.tree.map(lambda a: a[li], params["body"][0])


def _random_cache(rng, b):
    """A reference-shaped decode cache (f32) filled with random values."""
    cache = JM.init_decode_cache(J_CFG, b, 16, jnp.float32)
    return jax.tree.map(lambda a: jnp.asarray(
        0.5 * rng.standard_normal(a.shape).astype(np.float32)), cache)


def test_params_carried_across(models):
    params, lm = models
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    assert all(not p.requires_grad for p in lm.parameters())
    for li in range(J_CFG.n_layers):
        ref = _ref_layer(params, li)
        blk = lm.blocks[li]
        _close(blk.mixer.wr, ref["mixer"]["wr"], 0)
        _close(blk.mixer.u, ref["mixer"]["u"], 0)
        _close(blk.ffn.wv, ref["ffn"]["wv"], 0)
        _close(blk.mixer.ln_x["scale"], ref["mixer"]["ln_x"]["scale"], 0)
    _close(lm.embed, params["embed"], 0)
    _close(lm.unembed, params["unembed"], 0)


@pytest.mark.parametrize("with_cache", [False, True])
@pytest.mark.parametrize("chunk", [0, 16])
def test_time_mix_matches_reference(models, monkeypatch, with_cache, chunk):
    monkeypatch.setattr(JL, "RWKV_CHUNK", chunk)
    params, lm = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 12, J_CFG.d_model)).astype(np.float32)
    layer = _ref_layer(params, 1)
    jcache = tcache = None
    if with_cache:
        jcache = _random_cache(rng, 2)["body"][0]["tm"]
        jcache = jax.tree.map(lambda a: a[1], jcache)
        tcache = {k: torch.from_numpy(np.array(v))
                  for k, v in jcache.items()}
    want, wc = JL.rwkv6_timemix_fwd(layer["mixer"], jnp.asarray(x), J_CFG,
                                    cache=jcache)
    got, tc = lm.blocks[1].mixer(torch.from_numpy(x), tcache)
    _close(got, want)
    assert (tc is None) == (wc is None)
    if with_cache:
        for key in ("x_prev", "state"):
            _close(tc[key], wc[key])


@pytest.mark.parametrize("with_cache", [False, True])
def test_channel_mix_matches_reference(models, with_cache):
    params, lm = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, J_CFG.d_model)).astype(np.float32)
    jcache = tcache = None
    if with_cache:
        prev = (0.5 * rng.standard_normal((2, J_CFG.d_model))
                ).astype(np.float32)
        jcache, tcache = {"x_prev": jnp.asarray(prev)}, {
            "x_prev": torch.from_numpy(prev)}
    want, wc = JL.rwkv6_channelmix_fwd(_ref_layer(params, 0)["ffn"],
                                       jnp.asarray(x), J_CFG, cache=jcache)
    got, tc = lm.blocks[0].ffn(torch.from_numpy(x), tcache)
    _close(got, want)
    if with_cache:
        _close(tc["x_prev"], wc["x_prev"])
    else:
        assert tc is None and wc is None


@pytest.mark.parametrize("chunk", [0, 16])
def test_forward_logits_matches_reference(models, monkeypatch, chunk):
    """Against the reference's sequential scan (0) and its chunked-parallel
    core (16, its default) on a sequence longer than one chunk."""
    monkeypatch.setattr(JL, "RWKV_CHUNK", chunk)
    params, lm = models
    toks = _tokens(2, 37)
    want = JM.forward_logits(params, jnp.asarray(toks), J_CFG)
    got = TM.forward_logits(lm, torch.from_numpy(toks), T_CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 37, J_CFG.vocab)
    _close(got, want)
    last = make_prefill_step(T_CFG)(lm, {"tokens": torch.from_numpy(toks)})
    _close(last, np.asarray(want)[:, -1])


def test_decode_step_matches_reference_token_by_token(models):
    """From one random cache, six single-token steps and then a 5-token
    cache-writing step: logits and every layer's cache entries."""
    params, lm = models
    jcache = _random_cache(np.random.default_rng(4), 2)
    tcache = convert.decode_cache_from_arrays(
        T_CFG, jax.tree.map(np.asarray, jcache), device="cpu")
    toks = _tokens(2, 11, seed=5)
    j_step = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, J_CFG))
    t_step = make_decode_step(T_CFG)
    for lo, hi in [(i, i + 1) for i in range(6)] + [(6, 11)]:
        want, jcache = j_step(params, jcache, jnp.asarray(toks[:, lo:hi]))
        got, tcache = t_step(lm, tcache, torch.from_numpy(toks[:, lo:hi]))
        _close(got, want)
        ref_layers = convert._unstack(jax.tree.map(np.asarray, jcache),
                                      T_CFG)
        assert len(tcache) == len(ref_layers) == T_CFG.n_layers
        for tl, jl in zip(tcache, ref_layers):
            _close(tl["tm"]["state"], jl["tm"]["state"])
            _close(tl["tm"]["x_prev"], jl["tm"]["x_prev"])
            _close(tl["cm"]["x_prev"], jl["cm"]["x_prev"])


def test_decode_matches_parallel_forward():
    """The port of ``tests/test_models.py::test_decode_matches_parallel_forward``
    for ``rwkv6-7b`` on the port's own random weights: token-by-token
    decode and a cache-writing prefill reproduce the parallel forward."""
    lm = TM.init_params(T_CFG, 0, device="cpu")
    s = 12
    tokens = torch.from_numpy(_tokens(2, s, seed=6))
    ref = TM.forward_logits(lm, tokens, T_CFG).numpy()
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    got = []
    for i in range(s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i: i + 1], T_CFG)
        got.append(logits.numpy()[:, 0])
    np.testing.assert_allclose(np.stack(got, axis=1), ref,
                               atol=PARALLEL_TOL, rtol=PARALLEL_TOL)
    cache0 = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                  device="cpu")
    whole, cache_w = TM.decode_step(lm, cache0, tokens, T_CFG)
    np.testing.assert_allclose(whole.numpy(), ref, atol=PARALLEL_TOL,
                               rtol=PARALLEL_TOL)
    for a, b in zip(cache, cache_w):
        np.testing.assert_allclose(a["tm"]["state"].numpy(),
                                   b["tm"]["state"].numpy(),
                                   atol=PARALLEL_TOL, rtol=PARALLEL_TOL)


def test_greedy_generate_matches_reference(models):
    params, lm = models
    prompt = _tokens(3, 8, seed=7)
    max_new = 10
    want = np.asarray(j_greedy(params, J_CFG, jnp.asarray(prompt), max_new,
                               8 + max_new + 1))
    # the reference's greedy loop written out, for its top-2 margins
    step = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, J_CFG))
    cache = JM.init_decode_cache(J_CFG, 3, 8 + max_new + 1, jnp.float32)
    for i in range(8):
        logits, cache = step(params, cache, jnp.asarray(prompt[:, i:i + 1]))
    margins, toks = [], []
    for _ in range(max_new):
        top2 = np.sort(np.asarray(logits)[:, -1], axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(jnp.int32)
        toks.append(np.asarray(tok)[:, 0])
        logits, cache = step(params, cache, tok)
    np.testing.assert_array_equal(np.stack(toks, axis=1), want)
    margins = np.stack(margins, axis=1)

    got = greedy_generate(lm, T_CFG, torch.from_numpy(prompt), max_new,
                          8 + max_new + 1)
    assert got.dtype == torch.int32 and got.shape == (3, max_new)
    checked = 0
    for row in range(3):
        low = np.nonzero(margins[row] <= 10 * TOL)[0]
        n = low[0] if low.size else max_new
        np.testing.assert_array_equal(got[row, :n].numpy(), want[row, :n])
        checked += n
    assert checked >= max_new        # the margins leave something to check


def test_count_params_full_config_on_meta():
    cfg = get_config("rwkv6-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.vocab,
            cfg.rwkv_head_dim) == (32, 4096, 64, 14336, 65536, 64)
    assert TM.count_params(cfg) == 7_534_944_256
    assert cfg.param_count() == cfg.active_param_count() == 7_534_944_256
    assert next(TM.init_params(cfg, device="meta").parameters()).is_meta


def test_serve_lm_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--smoke",
         "--arch", "rwkv6-7b", "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "arch=rwkv6-7b-smoke on cpu generated (4, 32) tokens" in proc.stdout
