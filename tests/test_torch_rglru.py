"""The port's RG-LRU block (Griffin) against the JAX reference, and
``recurrentgemma-2b`` at its smoke size (7 layers: two periods of
(rglru, rglru, local_attn) and a tail of one rglru layer; d_model 64,
4 heads, one kv head, window 8), with the reference's parameters drawn
with numpy in its shapes and carried across by ``convert``.

The reference's decay ``log a_t = -8 r_t softplus(lam)`` with its initial
``lam`` (4.3 to 8.0) leaves ``a_t`` below 3e-8, so the block barely
recurs and a wrong state carry would pass on those weights. Every test of
the block, the scan, the gradients and the decode therefore runs twice:
with the reference's ``lam`` (``"init"``) and with it negated
(``"recur"``, ``a_t`` about 0.9 to 0.9995), in both packages.

- ``init_rglru_block``'s names, shapes and dtypes; ``_rglru_scan``
  against a sequential float64 loop; ``rglru_block_fwd`` without and with
  a cache at S = 1 and S > 3; its gradients against ``jax.grad``;
- the smoke model: parameters carried across, ``forward_logits``,
  ``decode_step`` token by token against the reference's (caches carried
  across by ``decode_cache_from_arrays``; ``h``, ``conv`` and the ring
  buffers compared), decode against the port's parallel forward past the
  window (the ring wraps), ``train_forward``'s loss and every gradient,
  a train step of 2 microbatches with int8 moments (the port's step, then
  the reference's ``apply_updates`` op by op on the port's gradients:
  codes and scales exactly), and the weight decay that the reference's
  stacking gives (the 1-D leaves of the scanned periods decayed, the
  tail's not);
- the full config's count on the meta device (3,549,888,000), its layer
  kinds and groups, and both LM launchers on ``--arch recurrentgemma-2b``.

The reference's layer runs eagerly, its model's loss, gradients and
decode step jitted, its int8 optimizer op by op (under ``jit`` XLA
divides by 127 as a reciprocal multiply). Tolerances: the scan within
1e-6 x max(1, max|loop|); the block within 1e-5 x max(1, max|ref|)
(XLA's associative scan combines pairs in its own tree, so no order of
the port's matches it bitwise), its gradients within 1e-4 x max(1,
max|ref|), the model's too; logits and caches ``atol=rtol=1e-4``;
``rtol=1e-5`` on losses, ``atol=1e-6`` on parameters after an optimizer
step; decode against the parallel forward
``atol=rtol=2e-3`` (the reference test's).
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
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve_lm as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step

ARCH = "recurrentgemma-2b"
TOL = 1e-4
SCAN_RTOL = 1e-6
OUT_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4
PARALLEL_TOL = 2e-3
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 16
LAMS = ("init", "recur")


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
D = T_CFG.d_model
TAIL = T_CFG.n_layers - 1                 # the one unstacked (tail) layer


def _close(got, want, atol=TOL, rtol=None):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _scaled_close(got, want, rtol):
    """max |got - want| <= rtol * max(1, max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (err, scale)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _params(rng):
    """A param tree of the reference's shapes drawn with numpy: ``lam`` as
    the reference initialises it (``log(u^(1/8) / (1 - u^(1/8)))``, u ~
    U(0.9, 0.999)), the embedding and unembedding 0.02 N(0, 1), norm
    scales 1 + 0.2 N(0, 1), ``conv_w`` 0.5 N(0, 1), ``w_a`` and ``w_i``
    0.02 N(0, 1) (their init scales), ``b_a`` and ``b_i`` 0.1 N(0, 1),
    every other weight N(0, 1) / sqrt(fan-in)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(J_CFG, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "'lam'" in name:
            r = rng.uniform(0.9, 0.999, leaf.shape).astype(np.float32)
            r = r ** np.float32(1 / 8)
            return jnp.asarray(np.log(r / (1 - r)))
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        for key, scale in (("'embed'", 0.02), ("'unembed'", 0.02),
                           ("'conv_w'", 0.5), ("'w_a'", 0.02),
                           ("'w_i'", 0.02), ("'b_a'", 0.1), ("'b_i'", 0.1)):
            if key in name:
                return jnp.asarray(scale * z)
        if "'scale'" in name:
            return jnp.asarray(1 + 0.2 * z)
        shape = leaf.shape[1:] if "'body'" in name else leaf.shape
        fan_in = shape[0] * shape[1] if "'wo'" in name else shape[0]
        return jnp.asarray(z / np.float32(np.sqrt(fan_in)))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _recurring(params):
    """``params`` with every ``lam`` negated: ``a_t`` about 0.9-0.9995."""
    return jax.tree_util.tree_map_with_path(
        lambda path, a: -a if "'lam'" in jax.tree_util.keystr(path) else a,
        params)


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


# the reference's functions jitted (once for each shape of these tests):
# eagerly, its associative scan compiles op by op at every call
_j_scan = jax.jit(JL._rglru_scan)
_j_block = jax.jit(lambda p, x, c: JL.rglru_block_fwd(p, x, J_CFG, cache=c))
_j_logits = jax.jit(lambda p, t: JM.forward_logits(p, t, J_CFG))
_j_loss_grad = jax.jit(jax.value_and_grad(
    lambda p, b: JM.train_forward(p, b, J_CFG)))
_j_decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, J_CFG))


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters (both ``lam`` variants), a batch, and
    the recurring variant's loss and gradients."""
    rng = np.random.default_rng(0)
    base = _params(rng)
    params = {"init": base, "recur": _recurring(base)}
    batch = _batch(rng, 2, SEQ)
    loss, grads = _j_loss_grad(params["recur"], _jb(batch))
    return {"params": params,
            "np": {k: _np(v) for k, v in params.items()}, "batch": batch,
            "loss": float(loss), "grads": _np(grads)}


def _lm(ref, lam, requires_grad=False):
    return convert.lm_params_from_arrays(
        T_CFG, ref["np"][lam], device="cpu").requires_grad_(requires_grad)


def _layer0(ref, lam):
    """Layer 0's RG-LRU parameters: the reference's (a dict of jnp arrays)
    and the port's holder."""
    jp = jax.tree.map(lambda a: a[0], ref["params"][lam]["body"][0]["mixer"])
    return jp, _lm(ref, lam).blocks[0].mixer


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def test_rglru_holder_matches_reference_init():
    """``layers.RGLRU`` holds ``init_rglru_block``'s parameters under the
    reference's names, shapes and dtypes: ``lam`` float32 from U(0.9,
    0.999) as there (so that sigmoid(lam)^8 lies in that range), the
    biases float32 zeros, ``w_a`` at scale 0.02, ``conv_w`` at 0.5; on
    the meta device only the shapes."""
    want = jax.eval_shape(
        lambda k: JL.init_rglru_block(k, J_CFG, jnp.bfloat16),
        jax.random.PRNGKey(0))
    blk = TL.RGLRU(T_CFG, torch.bfloat16,
                   generator=torch.Generator().manual_seed(0))
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[-1])
           for n, p in blk.named_parameters()}
    assert got == {n: (tuple(a.shape), str(a.dtype))
                   for n, a in want.items()}
    lam = blk.lam.to(torch.float64)
    u = torch.sigmoid(lam) ** 8
    assert bool((u >= 0.9 - 1e-6).all() and (u <= 0.999 + 1e-6).all())
    assert float(u.std()) > 0.01
    assert bool((blk.b_a == 0).all() and (blk.b_i == 0).all())
    assert abs(float(blk.w_a.float().std()) / 0.02 - 1) < 0.1
    assert abs(float(blk.conv_w.float().std()) / 0.5 - 1) < 0.3
    meta = TL.RGLRU(T_CFG, device="meta")
    assert meta.lam.is_meta and meta.lam.dtype == torch.float32


def _scan_loop(xt, a, h0):
    """h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) x_t in float64."""
    h = h0.astype(np.float64)
    out = np.zeros(xt.shape, np.float64)
    for t in range(xt.shape[1]):
        at = a[:, t].astype(np.float64)
        h = at * h + np.sqrt(np.maximum(1 - at * at, 1e-12)) * xt[:, t]
        out[:, t] = h
    return out


@pytest.mark.parametrize("s", [1, 5, 64])
@pytest.mark.parametrize("lam", LAMS)
def test_rglru_scan_matches_sequential_loop(s, lam):
    """``_rglru_scan`` (the doubling scan) and the reference's associative
    scan against a sequential loop, from a nonzero ``h0``: decays of the
    recurring kind (0.9-0.9995), or of the reference's initial kind
    (e^-64 to 1e-8: the prefix products underflow to 0, harmlessly)."""
    rng = np.random.default_rng(s)
    xt = rng.standard_normal((2, s, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    if lam == "recur":
        a = rng.uniform(0.9, 0.9995, (2, s, 8)).astype(np.float32)
    else:
        a = np.exp(-rng.uniform(18.0, 64.0, (2, s, 8))).astype(np.float32)
    want = _scan_loop(xt, a, h0)
    got, last = TL._rglru_scan(*map(torch.from_numpy, (xt, a, h0)))
    assert got.shape == (2, s, 8) and got.dtype == torch.float32
    _scaled_close(got, want, SCAN_RTOL)
    assert torch.equal(last, got[:, -1])
    j_got, _ = _j_scan(*map(jnp.asarray, (xt, a, h0)))
    _scaled_close(np.asarray(j_got), want, SCAN_RTOL)


def _block_case(s, cached, seed):
    """x [2, s, d], and with ``cached`` a cache of a random state and conv
    rows (float32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    if not cached:
        return x, None
    return x, {"h": rng.standard_normal((2, D)).astype(np.float32),
               "conv": rng.standard_normal((2, 3, D)).astype(np.float32)}


# (S, with a cache)
_CASES = {"no_cache": (9, False), "no_cache_one": (1, False),
          "cache_decode": (1, True), "cache_prefill": (5, True)}


@pytest.mark.parametrize("lam", LAMS)
@pytest.mark.parametrize("case", list(_CASES))
def test_rglru_block_matches_reference(ref, case, lam):
    """``rglru_block_fwd`` without a cache and with one (a decode step and
    a 5-token step, which keeps the last 3 rows of its padded input):
    output and new cache."""
    s, cached = _CASES[case]
    jp, tp = _layer0(ref, lam)
    x, c = _block_case(s, cached, seed=len(case))
    want, want_c = _j_block(
        jp, jnp.asarray(x),
        None if c is None else jax.tree.map(jnp.asarray, c))
    got, got_c = TL.rglru_block_fwd(
        tp, torch.from_numpy(x), T_CFG,
        cache=None if c is None else jax.tree.map(torch.from_numpy, c))
    assert got.dtype == torch.float32 and got.shape == (2, s, D)
    _scaled_close(got, want, OUT_RTOL)
    if c is None:
        assert got_c is None and want_c is None
        return
    assert got_c["h"].dtype == torch.float32
    _scaled_close(got_c["h"], want_c["h"], OUT_RTOL)
    np.testing.assert_array_equal(got_c["conv"].numpy(),
                                  np.asarray(want_c["conv"]))


@pytest.mark.parametrize("lam", LAMS)
def test_rglru_block_gradients_match_reference(ref, lam):
    """Gradients of sum(out * w) + sum(h_T * w_h) through a 6-token step
    from a cache, with respect to the input, the cached state and conv
    rows and every parameter, against ``jax.grad``."""
    jp, tp = _layer0(ref, lam)
    x, c = _block_case(6, True, seed=11)
    rng = np.random.default_rng(12)
    w = rng.standard_normal((2, 6, D)).astype(np.float32)
    w_h = rng.standard_normal((2, D)).astype(np.float32)

    def j_loss(p, x, c):
        out, nc = JL.rglru_block_fwd(p, x, J_CFG, cache=c)
        return jnp.sum(out * w) + jnp.sum(nc["h"] * w_h)

    jc = jax.tree.map(jnp.asarray, c)
    want = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2)))(
        jp, jnp.asarray(x), jc)
    tp.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tc = {k: torch.from_numpy(v).requires_grad_(True) for k, v in c.items()}
    out, nc = TL.rglru_block_fwd(tp, tx, T_CFG, cache=tc)
    (torch.sum(out * torch.from_numpy(w))
     + torch.sum(nc["h"] * torch.from_numpy(w_h))).backward()
    for name, p in tp.named_parameters():
        assert p.grad is not None, name
        _scaled_close(p.grad, want[0][name], GRAD_SCALE_TOL)
    _scaled_close(tx.grad, want[1], GRAD_SCALE_TOL)
    for key in ("h", "conv"):
        _scaled_close(tc[key].grad, want[2][key], GRAD_SCALE_TOL)
    if lam == "recur":
        # the state carries: h0 reaches the output
        assert float(tc["h"].grad.abs().max()) > 1e-2


# ---------------------------------------------------------------------------
# the model: parameters, logits, decode
# ---------------------------------------------------------------------------

def test_params_carried_across(ref):
    lm = _lm(ref, "init")
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    want = convert.lm_arrays_by_name(T_CFG, ref["np"]["init"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    kinds = [type(b.mixer).__name__ for b in lm.blocks]
    assert kinds == ["RGLRU", "RGLRU", "Attention"] * 2 + ["RGLRU"]
    assert T_CFG.layer_kinds[-1] == "rglru"
    np.testing.assert_array_equal(
        named["blocks.4.mixer.lam"].numpy(),
        ref["np"]["init"]["body"][1]["mixer"]["lam"][1])
    np.testing.assert_array_equal(
        named[f"blocks.{TAIL}.mixer.w_out"].numpy(),
        ref["np"]["init"]["tail"][0]["mixer"]["w_out"])


@pytest.mark.parametrize("lam", LAMS)
def test_forward_logits_match_reference(ref, lam):
    toks = np.random.default_rng(1).integers(0, J_CFG.vocab, (2, 19)).astype(
        np.int32)
    want = _j_logits(ref["params"][lam], jnp.asarray(toks))
    got = TM.forward_logits(_lm(ref, lam), torch.from_numpy(toks), T_CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 19, J_CFG.vocab)
    _close(got, want)


@pytest.mark.parametrize("lam", LAMS)
def test_decode_step_matches_reference_token_by_token(ref, lam):
    """Four steps in the reference, its cache carried across by
    ``decode_cache_from_arrays``, then eight single-token steps in each
    package, past the window of 8 (the ring buffers wrap): logits and
    every layer's cache (``h``, ``conv``; ``k``, ``v``, ``pos``,
    ``length``)."""
    lm = _lm(ref, lam)
    jparams = ref["params"][lam]
    b, max_len = 2, 14
    toks = np.random.default_rng(2).integers(0, J_CFG.vocab, (b, 12)).astype(
        np.int32)
    jcache = JM.init_decode_cache(J_CFG, b, max_len, jnp.float32)
    for i in range(4):
        _, jcache = _j_decode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
    tcache = convert.decode_cache_from_arrays(T_CFG, _np(jcache),
                                              device="cpu")

    def cache_equal():
        ref_c = convert._unstack(_np(jcache), T_CFG)
        assert len(tcache) == len(ref_c) == T_CFG.n_layers
        for kind, tl, jl in zip(T_CFG.layer_kinds, tcache, ref_c):
            assert set(tl) == set(jl)
            if kind == "rglru":
                assert tl["h"].dtype == torch.float32
                _close(tl["h"], jl["h"])
                _close(tl["conv"], jl["conv"])
            else:
                assert tl["length"] == int(jl["length"])
                assert tuple(tl["k"].shape) == (b, T_CFG.local_window, 1,
                                                T_CFG.head_dim)
                np.testing.assert_array_equal(tl["pos"].numpy(), jl["pos"])
                _close(tl["k"], jl["k"])
                _close(tl["v"], jl["v"])

    cache_equal()
    for i in range(4, 12):
        want, jcache = _j_decode(jparams, jcache,
                                 jnp.asarray(toks[:, i:i + 1]))
        got, tcache = TM.decode_step(lm, tcache,
                                     torch.from_numpy(toks[:, i:i + 1]),
                                     T_CFG)
        _close(got, want)
        cache_equal()
    assert int(tcache[2]["pos"].min()) == 4       # every slot rewritten


@pytest.mark.parametrize("lam", LAMS)
def test_decode_matches_parallel_forward(ref, lam):
    """The port of ``tests/test_models.py::test_decode_matches_parallel_
    forward[recurrentgemma-2b]`` on the port alone, at 14 tokens past the
    window of 8: token-by-token decode, and a cache-writing prefill of 8
    tokens (the window: a prefill must not wrap) given their positions
    followed by single-token steps, reproduce the parallel forward."""
    lm = _lm(ref, lam)
    s = 14
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, J_CFG.vocab, (2, s)).astype(np.int32))
    want = TM.forward_logits(lm, tokens, T_CFG).numpy()
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    got = []
    for i in range(s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i:i + 1], T_CFG)
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)
    w = T_CFG.local_window
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    whole, cache = TM.decode_step(lm, cache, tokens[:, :w], T_CFG,
                                  pos=torch.arange(w).expand(2, w))
    got = [whole.numpy()]
    for i in range(w, s):
        logits, cache = TM.decode_step(lm, cache, tokens[:, i:i + 1], T_CFG)
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_forward_loss_and_every_gradient_match_reference(ref):
    """With the recurring ``lam``: the loss and every gradient (the tail's
    included; within 1e-4 x max(1, max|ref|): through the recurrence the
    embedding's gradient gathers rounding of 7e-6 of its scale), remat on
    against off."""
    lm = _lm(ref, "recur", requires_grad=True)
    loss = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
    _close(loss, ref["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _scaled_close(p.grad, want[name], GRAD_SCALE_TOL)
    lm_off = _lm(ref, "recur", requires_grad=True)
    TM.train_forward(lm_off, _tb(ref["batch"]), T_CFG, remat=False).backward()
    for name, p in lm_off.named_parameters():
        assert torch.equal(p.grad, named[name].grad), name


# the leaves whose int8 update is compared with the reference's: 1-D
# leaves of a scanned RG-LRU layer (stacked, [1, d], there) and of the
# tail's (the reference's op-by-op optimizer compiles each new shape, some
# 2.5 s a shape on a CPU)
INT8_LEAVES = ("blocks.0.mixer.lam", "blocks.0.mixer.b_a",
               f"blocks.{TAIL}.mixer.lam", f"blocks.{TAIL}.mixer.b_i")


def test_train_step_int8_matches_reference(ref):
    """``make_train_step`` with int8 moments on 2 microbatches (the
    fixture's batch and one more), recurring ``lam``: its loss and mean
    gradients against the reference's, then its update against the
    reference's ``apply_updates`` (op by op) on the same gradients, for
    the leaves of ``INT8_LEAVES``: parameters, and every moment's codes
    and scales exactly. ``grad_clip`` is so high that the clip factor is
    exactly 1 in both, so each leaf's update is its own."""
    rng = np.random.default_rng(4)
    micro = [ref["batch"], _batch(rng, 2, SEQ)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    opt = dict(quantize_moments=True, grad_clip=1e9, **OPT)
    cfg = TO.OptConfig(**opt)
    lm = _lm(ref, "recur", requires_grad=True)
    lm, state, m = make_train_step(T_CFG, cfg)(
        lm, TO.init_opt_state(lm, cfg), _tb(batch))
    loss2, grads2 = _j_loss_grad(ref["params"]["recur"], _jb(micro[1]))
    _close(m["loss"], (ref["loss"] + float(loss2)) / 2, 0, 1e-5)
    want_g = convert.lm_arrays_by_name(T_CFG, jax.tree.map(
        lambda a, b: (a + b) / 2, ref["grads"], _np(grads2)))
    named = dict(lm.named_parameters())
    for name, p in named.items():
        _scaled_close(p.grad, want_g[name], GRAD_SCALE_TOL)
    before = convert.lm_arrays_by_name(T_CFG, ref["np"]["recur"])
    keys = [n for n in named if n.startswith(INT8_LEAVES)]
    body = TM.scanned_params(lm)

    def stacked(name, a):
        return jnp.asarray(a[None] if name in body else a)

    jp = {n: stacked(n, before[n]) for n in keys}
    jg = {n: stacked(n, named[n].grad.numpy()) for n in keys}
    j_cfg = JO.OptConfig(**opt)
    p1, st1, _ = JO.apply_updates(jp, jg, JO.init_opt_state(jp, j_cfg),
                                  j_cfg)
    for name in keys:
        def lead(a, name=name):
            return np.asarray(a)[0] if name in body else np.asarray(a)
        _close(named[name], lead(p1[name]), 1e-6, 0)
        for mom in ("m", "v"):
            got, want = state[mom][name], st1[mom][name]
            assert got["code"].dtype == torch.int8
            np.testing.assert_array_equal(got["code"].numpy(),
                                          lead(want["code"]), err_msg=name)
            np.testing.assert_array_equal(got["scale"].numpy(),
                                          lead(want["scale"]),
                                          err_msg=name)


_j_apply = jax.jit(lambda p, g, s: JO.apply_updates(
    p, g, s, JO.OptConfig(**OPT)))


def test_weight_decay_follows_the_reference_stacking(ref):
    """One AdamW step on zero gradients over the whole tree (float32
    moments; the reference's jitted): only weight decay moves a parameter,
    so each is scaled by 1 - lr wd or left as it was, as the reference's
    stacked tree decides. The 1-D leaves of the scanned periods (``lam``,
    ``b_a``, ``b_i``, the norm scales: [L, d] there) decay; the tail's and
    the final norm's do not; ``scanned_params`` names the first."""
    params = ref["params"]["recur"]
    zeros = jax.tree.map(jnp.zeros_like, params)
    p1, _, _ = _j_apply(params, zeros, JO.init_opt_state(params,
                                                         JO.OptConfig()))
    lm = _lm(ref, "recur")
    named = dict(lm.named_parameters())
    stacked = TM.scanned_params(lm)
    assert "blocks.3.mixer.lam" in stacked
    assert f"blocks.{TAIL}.mixer.lam" not in stacked
    TO.apply_updates(lm, {n: torch.zeros_like(p) for n, p in named.items()},
                     TO.init_opt_state(lm, TO.OptConfig()),
                     TO.OptConfig(**OPT), stacked=stacked)
    want = convert.lm_arrays_by_name(T_CFG, _np(p1))
    before = convert.lm_arrays_by_name(T_CFG, ref["np"]["recur"])
    decayed = set()
    for name, p in named.items():
        _close(p, want[name], 1e-7, 0)
        if not np.array_equal(want[name], before[name]):
            decayed.add(name)
    for leaf in ("mixer.lam", "mixer.b_a", "mixer.b_i", "ln1.scale"):
        assert f"blocks.0.{leaf}" in decayed
        assert f"blocks.{TAIL}.{leaf}" not in decayed
    assert "final_norm.scale" not in decayed
    assert f"blocks.{TAIL}.mixer.w_a" in decayed


# ---------------------------------------------------------------------------
# the full config, launchers
# ---------------------------------------------------------------------------

def test_full_config_counts_kinds_and_groups():
    """The published config copied exactly, 3,549,888,000 parameters on
    the meta device, the layer kinds as ``tests/test_models.py`` checks
    them, and 8 stacked periods with a tail of 2 ``rglru`` layers."""
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == 3_549_888_000
    model = TM.init_params(cfg, device="meta")
    assert next(model.parameters()).is_meta
    assert tuple(model.blocks[0].mixer.w_a.shape) == (2560, 2560)
    kinds = cfg.layer_kinds
    assert len(kinds) == 26
    assert kinds[:3] == ("rglru", "rglru", "local_attn")
    assert kinds.count("local_attn") == 8
    groups = TM.layer_groups(cfg)
    assert (groups.n_periods, groups.tail_kinds) == (8, ("rglru", "rglru"))
    assert TM._scanned_layers(cfg) == range(24)
    assert cfg.subquadratic and cfg.local_window == 2048


def test_decode_cache_is_bounded_by_the_window():
    """The decode cache's bytes at 2,064 positions and at 524,288
    (``long_500k``) are equal: the ``local_attn`` ring buffers hold the
    window, the ``rglru`` layers a state and 3 conv rows (meta device)."""
    cfg = get_config(ARCH)

    def nbytes(max_len):
        cache = TM.init_decode_cache(cfg, 1, max_len, torch.float32,
                                     device="meta")
        return sum(t.numel() * t.element_size() for c in cache
                   for t in c.values() if isinstance(t, torch.Tensor))

    assert nbytes(2064) == nbytes(524_288) == nbytes(2048) > nbytes(2047)


def test_launchers_on_cpu(capsys):
    """``launch/train.py`` and ``launch/serve_lm.py`` with ``--arch
    recurrentgemma-2b --smoke --device cpu``: two finite training steps,
    and generation at the serving launcher's defaults (48 positions, past
    the window of 8)."""
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
