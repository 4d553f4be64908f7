"""The port's dense attention LMs against the JAX reference, at the smoke
sizes of ``lm-100m``, ``qwen1.5-110b`` (QKV bias), ``command-r-35b`` and an
``("attn", "local_attn")`` pattern (``lm-100m`` widths, 2 kv heads of 4,
``local_window`` 8, 5 layers: two scanned periods and a tail layer), with
the reference's parameters carried across by
``convert.lm_params_from_arrays`` (QKV biases and norm scales drawn away
from their init values, so that they are exercised): ``forward_logits``
and the prefill step, ``decode_step`` token by token from a cache carried
across by ``convert.decode_cache_from_arrays`` (the ring buffer past its
window included) and a cache-writing step given its positions, the port's
decode against its own parallel forward, ``greedy_generate``, the four
full configs' parameter counts, and ``decode_step``'s positions for a
prompt of S > 1 tokens (the port asks for ``pos``; the reference rotates
every token of it alike).

The reference runs eagerly (not under ``jit``; its decode steps under
``jax.disable_jit``, op by op, which also unrolls its layer scan), except
in the greedy test, whose margins come from the reference's decode step
jitted as its own ``greedy_generate`` jits it. Tolerances: against the reference,
``atol=rtol=1e-4`` on logits and cache entries (float32, sums in another
order); decode against the parallel forward, ``atol=rtol=2e-3`` (the
reference test's); greedy tokens equal up to the first step of a row
whose top-2 logit margin is at most ten times 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as JM
from repro.configs import smoke_config as j_smoke
from repro.models.config import get_config as j_get
from repro.train.serve_step import greedy_generate as j_greedy
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train.serve_step import greedy_generate, make_prefill_step

TOL = 1e-4
PARALLEL_TOL = 2e-3
ARCHS = ["lm-100m", "qwen1.5-110b", "command-r-35b", "local"]
FULL = ["lm-100m", "qwen1.5-110b", "command-r-35b", "command-r-plus-104b"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    """(reference, port) smoke configs of ``arch``."""
    if arch == "local":
        local = dict(layer_pattern=("attn", "local_attn"))
        return tuple(dataclasses.replace(smoke(dataclasses.replace(
            get("lm-100m"), **local)), n_kv_heads=2)
            for smoke, get in ((j_smoke, j_get), (smoke_config, get_config)))
    return j_smoke(j_get(arch)), smoke_config(get_config(arch))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference cfg, port cfg, reference params, port LM) holding
    the same weights: the reference's init, every norm scale and QKV bias
    redrawn with numpy."""
    jcfg, tcfg = configs(request.param)
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)

    def redraw(path, a):
        name = jax.tree_util.keystr(path)
        if "'scale'" in name:
            return jnp.asarray(1 + 0.2 * rng.standard_normal(a.shape)
                               .astype(np.float32))
        if any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            return jnp.asarray(0.2 * rng.standard_normal(a.shape)
                               .astype(np.float32))
        return a

    params = jax.tree_util.tree_map_with_path(redraw, params)
    lm = convert.lm_params_from_arrays(
        tcfg, jax.tree.map(np.asarray, params), device="cpu")
    return request.param, jcfg, tcfg, params, lm


def test_params_carried_across(model):
    arch, jcfg, tcfg, params, lm = model
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(jcfg)
    assert all(not p.requires_grad for p in lm.parameters())
    want = convert.lm_arrays_by_name(tcfg, jax.tree.map(np.asarray, params))
    for name, p in lm.named_parameters():
        np.testing.assert_array_equal(p.numpy(), want[name])
    assert ("bq" in lm.blocks[0].mixer) == (arch == "qwen1.5-110b")
    kinds = [type(b.ffn).__name__ for b in lm.blocks]
    assert kinds == ["SwiGLU"] * tcfg.n_layers


def test_forward_logits_matches_reference(model):
    _, jcfg, tcfg, params, lm = model
    toks = _tokens(2, 19)                    # > local_window = 8
    want = JM.forward_logits(params, jnp.asarray(toks), jcfg)
    got = TM.forward_logits(lm, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 19, jcfg.vocab)
    _close(got, want)
    last = make_prefill_step(tcfg)(lm, {"tokens": torch.from_numpy(toks)})
    _close(last, np.asarray(want)[:, -1])


def _cache_equal(tcache, jcache, cfg):
    ref = convert._unstack(jax.tree.map(np.asarray, jcache), cfg)
    assert len(tcache) == len(ref) == cfg.n_layers
    for tl, jl in zip(tcache, ref):
        assert set(tl) == set(jl)
        assert tl["length"] == int(jl["length"])
        _close(tl["k"], jl["k"])
        _close(tl["v"], jl["v"])
        if "pos" in tl:
            np.testing.assert_array_equal(tl["pos"].numpy(), jl["pos"])


def test_decode_step_matches_reference_token_by_token(model):
    """Six steps in the reference, its cache carried across by
    ``decode_cache_from_arrays`` (lengths as host ints), then each
    package's single-token steps from there, past the local window, and a
    3-token cache-writing step given its positions: logits and every
    layer's cache."""
    _, jcfg, tcfg, params, lm = model
    b, max_len = 2, 20
    toks = _tokens(b, 16, seed=2)

    def jstep(c, t, pos=None):
        with jax.disable_jit():
            return JM.decode_step(params, c, t, jcfg, pos=pos)

    jcache = JM.init_decode_cache(jcfg, b, max_len, jnp.float32)
    for i in range(6):
        _, jcache = jstep(jcache, jnp.asarray(toks[:, i:i + 1]))
    tcache = convert.decode_cache_from_arrays(
        tcfg, jax.tree.map(np.asarray, jcache), device="cpu")
    _cache_equal(tcache, jcache, tcfg)
    assert all(type(c["length"]) is int and c["length"] == 6
               for c in tcache)
    for i in range(6, 13):
        want, jcache = jstep(jcache, jnp.asarray(toks[:, i:i + 1]))
        got, tcache = TM.decode_step(lm, tcache,
                                     torch.from_numpy(toks[:, i:i + 1]),
                                     tcfg)
        _close(got, want)
        _cache_equal(tcache, jcache, tcfg)
    pos = np.broadcast_to(np.arange(13, 16, dtype=np.int32), (b, 3)).copy()
    want, jcache = jstep(jcache, jnp.asarray(toks[:, 13:]),
                         jnp.asarray(pos))
    got, tcache = TM.decode_step(lm, tcache, torch.from_numpy(toks[:, 13:]),
                                 tcfg, pos=torch.from_numpy(pos))
    _close(got, want)
    _cache_equal(tcache, jcache, tcfg)


def test_decode_matches_parallel_forward(model):
    """The port of ``tests/test_models.py::test_decode_matches_parallel_forward``
    on the port alone: token-by-token decode, and a cache-writing prefill
    of 7 tokens given their positions followed by single-token steps,
    reproduce the parallel forward (past the local window)."""
    _, _, tcfg, _, lm = model
    s = 14
    tokens = torch.from_numpy(_tokens(2, s, seed=3))
    ref = TM.forward_logits(lm, tokens, tcfg).numpy()
    cache = TM.init_decode_cache(tcfg, 2, s + 2, torch.float32, device="cpu")
    got = []
    for i in range(s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i: i + 1], tcfg)
        got.append(logits.numpy()[:, 0])
    np.testing.assert_allclose(np.stack(got, axis=1), ref,
                               atol=PARALLEL_TOL, rtol=PARALLEL_TOL)
    cache = TM.init_decode_cache(tcfg, 2, s + 2, torch.float32, device="cpu")
    pos = torch.arange(7).expand(2, 7)
    whole, cache = TM.decode_step(lm, cache, tokens[:, :7], tcfg, pos=pos)
    rest = [whole.numpy()]
    for i in range(7, s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i: i + 1], tcfg)
        rest.append(logits.numpy())
    np.testing.assert_allclose(np.concatenate(rest, axis=1), ref,
                               atol=PARALLEL_TOL, rtol=PARALLEL_TOL)


def test_greedy_generate_matches_reference(model):
    _, jcfg, tcfg, params, lm = model
    prompt = _tokens(3, 6, seed=4)
    max_new, cache_len = 8, 6 + 8 + 1
    want = np.asarray(j_greedy(params, jcfg, jnp.asarray(prompt), max_new,
                               cache_len))
    # the reference's greedy loop written out, for its top-2 margins
    step = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jcfg))
    cache = JM.init_decode_cache(jcfg, 3, cache_len, jnp.float32)
    for i in range(6):
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

    got = greedy_generate(lm, tcfg, torch.from_numpy(prompt), max_new,
                          cache_len)
    assert got.dtype == torch.int32 and got.shape == (3, max_new)
    checked = 0
    for row in range(3):
        low = np.nonzero(margins[row] <= 10 * TOL)[0]
        n = low[0] if low.size else max_new
        np.testing.assert_array_equal(got[row, :n].numpy(), want[row, :n])
        checked += n
    assert checked >= max_new        # the margins leave something to check


@pytest.mark.parametrize("arch", FULL)
def test_count_params_full_config_on_meta(arch):
    cfg = get_config(arch)
    jcfg = j_get(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count()
    if arch == "lm-100m":
        assert n == 124_668_672
    assert next(TM.init_params(cfg, device="meta").parameters()).is_meta


def test_registered_archs_are_the_references():
    from repro.configs import ALL_ARCHS as J_ALL
    from repro_torch.configs import ALL_ARCHS
    assert set(ALL_ARCHS) == {"rwkv6-7b", "command-r-35b",
                              "command-r-plus-104b", "qwen1.5-110b",
                              "minicpm3-4b", "qwen2-vl-7b", "grok-1-314b",
                              "deepseek-v3-671b", "recurrentgemma-2b",
                              "whisper-tiny"}
    assert ALL_ARCHS == J_ALL
    assert "lm-100m" not in ALL_ARCHS


def test_decode_step_prompt_needs_positions():
    """With rope attention layers, a cache-writing step of S > 1 tokens
    without ``pos`` raises (the reference's default would rotate every
    token alike); one token, or explicit positions, decode."""
    _, tcfg = configs("lm-100m")
    lm = TM.init_params(tcfg, 0, device="cpu")
    cache = TM.init_decode_cache(tcfg, 2, 8, torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(2, 3, seed=5))
    with pytest.raises(ValueError, match="pass pos"):
        TM.decode_step(lm, cache, toks, tcfg)
    logits, _ = TM.decode_step(lm, cache, toks, tcfg,
                               pos=torch.arange(3).expand(2, 3))
    assert logits.shape == (2, 3, tcfg.vocab)
    logits, new = TM.decode_step(lm, cache, toks[:, :1], tcfg)
    assert new[0]["length"] == 1 and cache[0]["length"] == 0


def test_reference_rotates_a_prompt_alike():
    """The reference's ``decode_step`` with S > 1 and ``pos=None`` rotates
    every prompt token by the cache length (here 0) while its causal mask
    places token i at length + i: its logits are those of explicit
    positions all equal to the length, and not the parallel forward's."""
    jcfg, _ = configs("lm-100m")
    params = JM.init_params(jcfg, jax.random.PRNGKey(0))
    toks = jnp.asarray(_tokens(2, 5, seed=6))
    cache = JM.init_decode_cache(jcfg, 2, 8, jnp.float32)
    default, _ = JM.decode_step(params, cache, toks, jcfg)
    alike, _ = JM.decode_step(params, cache, toks, jcfg,
                              pos=jnp.zeros((2, 5), jnp.int32))
    parallel = JM.forward_logits(params, toks, jcfg)
    np.testing.assert_array_equal(np.asarray(default), np.asarray(alike))
    # the first token sits at position 0 either way; the later ones differ
    _close(np.asarray(default)[:, 0], np.asarray(parallel)[:, 0])
    assert not np.allclose(np.asarray(default)[:, 1:],
                           np.asarray(parallel)[:, 1:], atol=PARALLEL_TOL,
                           rtol=PARALLEL_TOL)
