"""The port's Multi-head Latent Attention against the JAX reference, at the
smoke size of ``minicpm3-4b`` (2 layers, d_model 64, 4 heads, MLA ranks
32 / 16, d_nope 16, d_rope 8, d_v 16), with the reference's parameters
(drawn with numpy in its shapes, norm scales away from 1), gradients,
optimizer state and decode caches carried across by ``convert``:

- ``init_mla``'s names and shapes; ``mla_fwd`` in its three cache cases:
  no cache, a cache-writing step of S > 1 tokens (the whole S_max latent
  expanded, queries at ``length`` + i, and one write that clamps at
  S_max - S), and a single-token step (the absorbed decode), with a
  float32 cache and with a bfloat16 one against float32 weights (the
  reference promotes there); ``_mla_absorbed_decode`` alone, unwritten
  cache slots holding values the mask must hide; the absorbed decode
  against the expanded one on the same cache (the port alone);
- ``forward_logits`` and the prefill step; ``decode_step`` token by token
  from a latent cache carried across by ``decode_cache_from_arrays``, then
  a cache-writing step given its positions (logits, ``latent``,
  ``k_rope``, ``length``); the port's decode against its own parallel
  forward (the port of ``tests/test_models.py::
  test_decode_matches_parallel_forward[minicpm3-4b]``);
- ``train_forward``'s loss and every gradient, remat on against off;
  ``apply_updates`` with int8 moments carried across by
  ``opt_state_from_arrays`` (the nested ``q_norm`` / ``kv_norm`` scales
  and the 3-axis weights decayed as the reference's stacked leaves); one
  ``make_train_step`` against the reference's;
- ``count_params`` of the full config (4,261,902,848), the registered
  configs, and both LM launchers on ``--arch minicpm3-4b``.

The reference runs eagerly (its decode steps under ``jax.disable_jit``,
its optimizer op by op, its train step jitted as its own tests run it).
Tolerances: ``atol=rtol=1e-4`` on layer outputs, logits and float32
caches (float32, sums in another order); with a bfloat16 cache,
``atol=rtol=1e-2`` on outputs (the probabilities and the latent round to
bfloat16, 2^-8 relative, at the same points in both; the matmuls over
them accumulate in another order) and the cache written equal;
``atol=rtol=1e-5`` between the absorbed and the expanded decode (the same
function in float32, reassociated); ``rtol=1e-5`` on losses, ``atol=1e-6,
rtol=1e-4`` on gradients, ``atol=1e-6`` on parameters after an optimizer
step, int8 codes and scales exactly; ``atol=2e-3`` on parameters after a
whole train step and on decode against the parallel forward (the
reference test's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.model as JM
from repro.configs import smoke_config as j_smoke
from repro.models.config import get_config as j_get
from repro.train import optimizer as JO
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve_lm as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO
from repro_torch.train.serve_step import make_prefill_step
from repro_torch.train.train_step import make_train_step

ARCH = "minicpm3-4b"
TOL = 1e-4
BF16_TOL = 1e-2
ABSORBED_TOL = 1e-5
PARALLEL_TOL = STEP_ATOL = 2e-3
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 21


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_CFG, T_CFG = j_smoke(j_get(ARCH)), smoke_config(get_config(ARCH))
M = T_CFG.mla


def _close(got, want, atol=TOL, rtol=None):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(
        0, J_CFG.vocab, (b, s)).astype(np.int32)


def _batch(rng, b, s):
    """tokens / labels / mask as numpy: labels the next token, a -1
    sentinel at position 5 (masked), the last position and a few more
    masked."""
    toks = rng.integers(0, J_CFG.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, 5] = -1
    mask = np.ones((b, s), np.float32)
    mask[:, [5, -1]] = 0.0
    mask[-1, 10:14] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def _params(rng):
    """A param tree of the reference's shapes drawn with numpy: the
    embedding and unembedding 0.02 N(0, 1), every norm scale (``q_norm``
    and ``kv_norm`` included) 1 + 0.2 N(0, 1), every other weight
    N(0, 1) / sqrt(fan-in)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(J_CFG, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "'embed'" in name or "'unembed'" in name:
            return jnp.asarray(0.02 * z)
        if "'scale'" in name:
            return jnp.asarray(1 + 0.2 * z)
        fan_in = (leaf.shape[1] * leaf.shape[2] if "'wo'" in name
                  else leaf.shape[1])                  # [L, fan-in, ...]
        return jnp.asarray(z / np.float32(np.sqrt(fan_in)))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, a batch, and its loss and gradients."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    batch = _batch(rng, 2, SEQ)
    loss, grads = jax.value_and_grad(lambda p: JM.train_forward(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, J_CFG))(params)
    return {"params": params, "np": _np(params), "batch": batch,
            "loss": float(loss), "grads": _np(grads)}


def _lm(ref, requires_grad=False):
    return convert.lm_params_from_arrays(
        T_CFG, ref["np"], device="cpu").requires_grad_(requires_grad)


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _layer0(ref):
    """Layer 0's MLA parameters: the reference's (a dict of jnp arrays) and
    the port's holder."""
    jp = jax.tree.map(lambda a: a[0], ref["params"]["body"][0]["mixer"])
    return jp, _lm(ref).blocks[0].mixer


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_mla_holder_matches_reference_init():
    """``layers.MLA`` holds ``init_mla``'s parameters under the reference's
    names and shapes (the norms nested, as ``q_norm.scale``), ``wo``
    drawn at scale 1/sqrt(H d_v)."""
    want = jax.eval_shape(lambda k: JL.init_mla(k, J_CFG, jnp.float32),
                          jax.random.PRNGKey(0))
    mla = TL.MLA(T_CFG, generator=torch.Generator().manual_seed(0))
    got = {n: tuple(p.shape) for n, p in mla.named_parameters()}
    flat = convert._flatten(want)
    assert got == {n: tuple(a.shape) for n, a in flat.items()}
    assert "q_norm" in mla and "kv_b" in mla and "bq" not in mla
    assert bool((mla.q_norm.scale == 1).all())
    h, dv = T_CFG.n_heads, M.d_v
    assert abs(float(mla.wo.std()) * np.sqrt(h * dv) - 1) < 0.1


def _mla_case(ref, s, length, dtype, seed):
    """Inputs of one ``mla_fwd`` call: x [2, s, d], positions length + i,
    and (with ``length`` not None) a cache of 12 slots holding ``length``
    tokens (random, the rest zero) in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, T_CFG.d_model)).astype(np.float32)
    off = 0 if length is None else length
    pos = np.broadcast_to(off + np.arange(s, dtype=np.int32), (2, s)).copy()
    if length is None:
        return x, pos, None, None
    lat = rng.standard_normal((2, 12, M.kv_rank)).astype(np.float32)
    kr = rng.standard_normal((2, 12, 1, M.d_rope)).astype(np.float32)
    lat[:, length:], kr[:, length:] = 0.0, 0.0
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = getattr(torch, dtype)
    jc = {"latent": jnp.asarray(lat, jd), "k_rope": jnp.asarray(kr, jd),
          "length": jnp.int32(length)}
    tc = {"latent": torch.from_numpy(lat).to(td),
          "k_rope": torch.from_numpy(kr).to(td), "length": length}
    return x, pos, jc, tc


# (S, cache length or None, cache dtype)
_CASES = {
    "no_cache": (9, None, "float32"),
    "prefill_cache": (4, 5, "float32"),
    "prefill_cache_clamped": (4, 10, "float32"),
    "decode": (1, 7, "float32"),
    "prefill_cache_bf16": (4, 5, "bfloat16"),
    "decode_bf16": (1, 7, "bfloat16"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_mla_fwd_matches_reference(ref, case):
    """``mla_fwd`` without a cache, writing 4 tokens into a cache of 12
    slots at length 5 (and at 10, where the write clamps to slot 8 while
    the queries stay at 10 + i, as ``dynamic_update_slice`` does), and one
    token at length 7 (the absorbed decode): output and new cache."""
    s, length, dtype = _CASES[case]
    jp, tp = _layer0(ref)
    x, pos, jc, tc = _mla_case(ref, s, length, dtype, seed=len(case))
    want, want_c = JL.mla_fwd(jp, jnp.asarray(x), J_CFG, pos=jnp.asarray(pos),
                              cache=jc)
    got, got_c = TL.mla_fwd(tp, torch.from_numpy(x), T_CFG,
                            pos=torch.from_numpy(pos), cache=tc)
    assert got.dtype == torch.float32 and got.shape == (2, s, T_CFG.d_model)
    tol = BF16_TOL if dtype == "bfloat16" else TOL
    _close(got, want, tol)
    if length is None:
        assert got_c is None and want_c is None
        return
    assert got_c["length"] == int(want_c["length"]) == length + s
    for key in ("latent", "k_rope"):
        assert got_c[key].dtype == tc[key].dtype
        if dtype == "bfloat16":
            # written from float32 projections rounded once to bfloat16
            np.testing.assert_allclose(
                got_c[key].to(torch.float32).numpy(),
                np.asarray(want_c[key].astype(jnp.float32)), rtol=2 ** -7,
                atol=TOL)
        else:
            _close(got_c[key], want_c[key])


def test_absorbed_decode_matches_reference(ref):
    """``_mla_absorbed_decode`` alone on a cache of 12 slots with every
    slot filled with random values and ``length`` 6: the slots past the
    new token's (6) must not count."""
    jp, tp = _layer0(ref)
    rng = np.random.default_rng(8)
    qn = rng.standard_normal((2, 1, T_CFG.n_heads, M.d_nope))
    qr = rng.standard_normal((2, 1, T_CFG.n_heads, M.d_rope))
    lat = rng.standard_normal((2, 12, M.kv_rank))
    kr = rng.standard_normal((2, 12, 1, M.d_rope))
    args = [a.astype(np.float32) for a in (qn, qr, lat, kr)]
    want = JL._mla_absorbed_decode(jp, *map(jnp.asarray, args), 6, J_CFG.mla)
    got = TL._mla_absorbed_decode(tp, *map(torch.from_numpy, args), 6, M)
    assert got.shape == (2, 1, T_CFG.n_heads, M.d_v)
    _close(got, want)
    lat[:, 7:] = 100.0
    args[2] = lat.astype(np.float32)
    again = TL._mla_absorbed_decode(tp, *map(torch.from_numpy, args), 6, M)
    _close(again, got, 0, 0)


def test_absorbed_decode_equals_expanded(ref):
    """The same single-token step through both of the port's paths: the
    absorbed decode and the expanded keys and values (the S > 1 branch on
    one token), on a cache written at length 9 of 12."""
    _, tp = _layer0(ref)
    x, pos, _, tc = _mla_case(ref, 1, 9, "float32", seed=9)
    q_nope, q_rope, latent, k_rope = TL.mla_project(
        tp, torch.from_numpy(x), T_CFG, torch.from_numpy(pos))
    lat_c = TL._write(tc["latent"], latent, 9)
    kr_c = TL._write(tc["k_rope"], k_rope, 9)
    absorbed = TL._mla_absorbed_decode(tp, q_nope, q_rope, lat_c, kr_c, 9, M)
    expanded = TL.mla_expanded(tp, q_nope, q_rope, lat_c, kr_c, 9, M)
    _close(absorbed, expanded, ABSORBED_TOL)
    out, _ = TL.mla_fwd(tp, torch.from_numpy(x), T_CFG,
                        pos=torch.from_numpy(pos), cache=tc)
    _close(out, torch.einsum("bshv,hvd->bsd", absorbed, tp.wo), 0, 0)


# ---------------------------------------------------------------------------
# the model: parameters, logits, decode
# ---------------------------------------------------------------------------

def test_params_carried_across(ref):
    lm = _lm(ref)
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    want = convert.lm_arrays_by_name(T_CFG, ref["np"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    assert "blocks.1.mixer.kv_norm.scale" in named
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    assert all(type(b.mixer).__name__ == "MLA" for b in lm.blocks)
    # the stacked body unstacks into the MLA names, layer by layer
    np.testing.assert_array_equal(
        named["blocks.1.mixer.q_norm.scale"].numpy(),
        ref["np"]["body"][0]["mixer"]["q_norm"]["scale"][1])


def test_forward_logits_and_prefill_match_reference(ref):
    lm = _lm(ref)
    toks = _tokens(2, 19, seed=1)
    want = JM.forward_logits(ref["params"], jnp.asarray(toks), J_CFG)
    got = TM.forward_logits(lm, torch.from_numpy(toks), T_CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 19, J_CFG.vocab)
    _close(got, want)
    last = make_prefill_step(T_CFG)(lm, {"tokens": torch.from_numpy(toks)})
    _close(last, np.asarray(want)[:, -1])


def test_decode_step_matches_reference_token_by_token(ref):
    """Four steps in the reference, its latent cache carried across by
    ``decode_cache_from_arrays`` (lengths as host ints), then each
    package's single-token steps (the absorbed decode) and a 3-token
    cache-writing step given its positions: logits and every layer's
    ``latent``, ``k_rope`` and ``length``."""
    lm = _lm(ref)
    b, max_len = 2, 12
    toks = _tokens(b, 10, seed=2)

    def jstep(c, t, pos=None):
        with jax.disable_jit():
            return JM.decode_step(ref["params"], c, jnp.asarray(t), J_CFG,
                                  pos=pos)

    jcache = JM.init_decode_cache(J_CFG, b, max_len, jnp.float32)
    for i in range(4):
        _, jcache = jstep(jcache, toks[:, i:i + 1])
    tcache = convert.decode_cache_from_arrays(T_CFG, _np(jcache),
                                              device="cpu")

    def cache_equal():
        ref_c = convert._unstack(_np(jcache), T_CFG)
        assert len(tcache) == len(ref_c) == T_CFG.n_layers
        for tl, jl in zip(tcache, ref_c):
            assert set(tl) == set(jl) == {"latent", "k_rope", "length"}
            assert type(tl["length"]) is int
            assert tl["length"] == int(jl["length"])
            assert tuple(tl["latent"].shape) == (b, max_len, M.kv_rank)
            assert tuple(tl["k_rope"].shape) == (b, max_len, 1, M.d_rope)
            _close(tl["latent"], jl["latent"])
            _close(tl["k_rope"], jl["k_rope"])

    cache_equal()
    for i in range(4, 7):
        want, jcache = jstep(jcache, toks[:, i:i + 1])
        got, tcache = TM.decode_step(lm, tcache,
                                     torch.from_numpy(toks[:, i:i + 1]),
                                     T_CFG)
        _close(got, want)
        cache_equal()
    pos = np.broadcast_to(np.arange(7, 10, dtype=np.int32), (b, 3)).copy()
    want, jcache = jstep(jcache, toks[:, 7:], jnp.asarray(pos))
    got, tcache = TM.decode_step(lm, tcache, torch.from_numpy(toks[:, 7:]),
                                 T_CFG, pos=torch.from_numpy(pos))
    _close(got, want)
    cache_equal()


def test_decode_matches_parallel_forward(ref):
    """The port of ``tests/test_models.py::test_decode_matches_parallel_
    forward[minicpm3-4b]`` on the port alone: token-by-token decode (the
    absorbed path), and a cache-writing prefill of 7 tokens given their
    positions followed by single-token steps, reproduce the parallel
    forward."""
    lm = _lm(ref)
    s = 14
    tokens = torch.from_numpy(_tokens(2, s, seed=3))
    want = TM.forward_logits(lm, tokens, T_CFG).numpy()
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    got = []
    for i in range(s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i:i + 1], T_CFG)
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    whole, cache = TM.decode_step(lm, cache, tokens[:, :7], T_CFG,
                                  pos=torch.arange(7).expand(2, 7))
    got = [whole.numpy()]
    for i in range(7, s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i:i + 1], T_CFG)
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)
    with pytest.raises(ValueError, match="pass pos"):
        TM.decode_step(lm, TM.init_decode_cache(T_CFG, 2, 8, torch.float32,
                                                device="cpu"),
                       tokens[:, :3], T_CFG)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_forward_loss_and_every_gradient_match_reference(ref):
    lm = _lm(ref, requires_grad=True)
    loss = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
    _close(loss, ref["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)
    lm_off = _lm(ref, requires_grad=True)
    loss_off = TM.train_forward(lm_off, _tb(ref["batch"]), T_CFG,
                                remat=False)
    loss_off.backward()
    assert torch.equal(loss.detach(), loss_off.detach())
    for name, p in lm_off.named_parameters():
        assert torch.equal(p.grad, named[name].grad), name


def test_apply_updates_int8_matches_reference(ref):
    """A first step, then the compared one, with int8 moments carried
    across by ``opt_state_from_arrays`` (the nested norms' moments
    included), on gradients small enough that the clip factor is exactly
    1: parameters, codes and scales. The norm scales decay as the
    reference's stacked [L, rank] leaves do."""
    rng = np.random.default_rng(6)
    params = ref["params"]

    def rand_tree():
        return jax.tree.map(lambda p: jnp.asarray(
            1e-3 * rng.standard_normal(p.shape).astype(np.float32)), params)

    j_cfg = JO.OptConfig(quantize_moments=True, **OPT)
    p1, st1, _ = JO.apply_updates(params, rand_tree(),
                                  JO.init_opt_state(params, j_cfg), j_cfg)
    g = rand_tree()
    p2, st2, want_m = JO.apply_updates(p1, g, st1, j_cfg)
    p1, st1, p2, st2 = _np(p1), _np(st1), _np(p2), _np(st2)

    lm = convert.lm_params_from_arrays(T_CFG, p1, device="cpu")
    state = convert.opt_state_from_arrays(T_CFG, st1, device="cpu")
    assert "blocks.0.mixer.q_norm.scale" in state["m"]
    grads = {n: torch.from_numpy(np.array(a)) for n, a in
             convert.lm_arrays_by_name(T_CFG, _np(g)).items()}
    stacked = TM.scanned_params(lm)
    assert "blocks.1.mixer.kv_norm.scale" in stacked
    _, new, metrics = TO.apply_updates(
        lm, grads, state, TO.OptConfig(quantize_moments=True, **OPT),
        stacked=stacked)
    assert int(new["step"]) == int(st2["step"]) == 2
    _close(metrics["grad_norm"], want_m["grad_norm"], 0, 1e-6)
    want_p = convert.lm_arrays_by_name(T_CFG, p2)
    for name, p in lm.named_parameters():
        _close(p, want_p[name], 1e-6, 0)
    for mom in ("m", "v"):
        wm = convert.lm_arrays_by_name(T_CFG, st2[mom])
        assert set(new[mom]) == set(wm)
        for name, got in new[mom].items():
            assert got["code"].dtype == torch.int8
            np.testing.assert_array_equal(got["code"].numpy(),
                                          wm[name]["code"])
            np.testing.assert_array_equal(got["scale"].numpy(),
                                          wm[name]["scale"])


def test_train_step_matches_reference(ref):
    """One ``make_train_step`` of 2 microbatches against the reference's
    jitted step from the same parameters: loss, gradient norm, every
    parameter after it."""
    rng = np.random.default_rng(7)
    micro = [_batch(rng, 2, SEQ) for _ in range(2)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    j_cfg = JO.OptConfig(**OPT)
    step = jax.jit(j_make_train_step(J_CFG, j_cfg))
    p, _, want_m = step(ref["params"], JO.init_opt_state(ref["params"],
                                                         j_cfg),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = TO.OptConfig(**OPT)
    lm = _lm(ref, requires_grad=True)
    lm, state, m = make_train_step(T_CFG, cfg)(
        lm, TO.init_opt_state(lm, cfg), _tb(batch))
    _close(m["loss"], want_m["loss"], 0, 1e-5)
    _close(m["grad_norm"], want_m["grad_norm"], 0, 1e-4)
    want = convert.lm_arrays_by_name(T_CFG, _np(p))
    for name, q in lm.named_parameters():
        _close(q, want[name], STEP_ATOL, 0)
    assert int(state["step"]) == 1


# ---------------------------------------------------------------------------
# the full config, launchers
# ---------------------------------------------------------------------------

def test_count_params_full_config_on_meta():
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab) == (
        62, 2560, 40, 73448)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == 4_261_902_848
    model = TM.init_params(cfg, device="meta")
    assert next(model.parameters()).is_meta
    assert tuple(model.blocks[0].mixer.kv_b.shape) == (256, 40, 128)


def test_launchers_on_cpu(capsys):
    """``launch/train.py`` and ``launch/serve_lm.py`` with ``--arch
    minicpm3-4b --smoke --device cpu``: two finite training steps, and
    generation at the serving launcher's defaults."""
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and out.strip().endswith("done")
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
    serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke on cpu generated (4, 32) tokens" in out
