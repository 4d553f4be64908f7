"""The port's Mixture of Experts against the JAX reference, and
``grok-1-314b`` at its smoke size (2 layers, d_model 64, 4 heads of 16,
4 experts top-2 of width 96, capacity factor 8: dropless), with the
reference's parameters drawn with numpy in its shapes and carried across
by ``convert``:

- ``moe_fwd`` with and without ``router_bias`` and the ``shared`` expert;
  capacity-bound cases (factor 1, inputs skewed toward one expert) whose
  routing (expert ids, the
  stable sort's order, ranks, keep mask, slots) equal the reference's,
  its router scaled so that every token's k-th and (k+1)-th biased logit
  are at least 1e-3 apart (asserted); ties, which ``jax.lax.top_k`` breaks
  to the lower index (a router with two identical columns); ``top_k_ids``
  on a matrix of many ties; ``moe_aux_loss``; ``moe_fwd`` against the
  port's plain per-expert statement of it (``moe_fwd_plain``); gradients
  of the router, the experts, the shared expert and the input against
  ``jax.grad``;
- the smoke model: parameters carried across (an ``attn`` layer's ``ffn``
  is :class:`layers.MoE`), ``forward_logits``, ``train_forward``'s loss
  and every gradient, a train step of 2 microbatches with int8 moments
  (the port's step, then the reference's ``apply_updates`` op by op on
  the port's gradients: parameters, and codes and scales exactly),
  decode steps at capacity factor 0.5 (a step of B = 4 tokens drops at
  least half its assignments) against the reference's, decode against the parallel forward
  (dropless);
- the full config's counts on the meta device (316,489,340,928, active
  84,561,106,944) and both LM launchers on ``--arch grok-1-314b``.

The reference's layer runs eagerly, its model's loss, gradients and
decode step jitted (as its own tests run them), its int8 optimizer op by
op (under ``jit`` XLA divides by 127 as a reciprocal multiply, which
rounds otherwise). Tolerances: routing exactly; layer
outputs within 1e-5 x max(1, max|ref|) (float32, sums in another order),
gradients within 1e-4 x max(1, max|ref|); ``moe_fwd`` against the plain
statement within 1e-5 x scale; logits ``atol=rtol=1e-4``; ``rtol=1e-5``
on losses, ``atol=1e-6, rtol=1e-4`` on the model's gradients,
``atol=1e-6`` on parameters after an optimizer step; decode against the
parallel forward ``atol=rtol=2e-3`` (the reference test's).
"""
import dataclasses
import math

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

ARCH = "grok-1-314b"
TOL = 1e-4
OUT_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARALLEL_TOL = 2e-3
GAP = 1e-3
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 16


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


def _close(got, want, atol=TOL, rtol=None):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _scaled_close(got, want, rtol):
    """max |got - want| <= rtol * max(1, max |want|)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _moe_cfg(cfg, **moe):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

# variant -> MoEConfig fields over the grok smoke config's (4 experts
# top-2, width 96, capacity factor 8)
VARIANTS = {
    "plain": {},
    "bias": dict(router_aux_free=True),
    "shared": dict(n_shared=1, d_expert=32),
    "bias_shared": dict(router_aux_free=True, n_shared=1, d_expert=32),
    "drops": dict(capacity_factor=1.0),
    "drops_bias_shared": dict(capacity_factor=1.0, router_aux_free=True,
                              n_shared=1, d_expert=32),
}


def _layer_case(variant, seed=0, router_scale=1.0, t=(2, 12)):
    """(reference cfg, port cfg, reference params as numpy, x [B, S, d]):
    weights N(0, 1) / sqrt(fan-in), the router times ``router_scale``, a
    random router bias of scale 0.5 where the variant has one, x N(0, 1);
    in the capacity-bound variants x is shifted by 2 along expert 0's
    router column, so that expert 0 takes more than its slots and the
    others leave slots empty."""
    jc = _moe_cfg(J_CFG, **VARIANTS[variant])
    tc = _moe_cfg(T_CFG, **VARIANTS[variant])
    rng = np.random.default_rng(seed)
    mo, d = jc.moe, jc.d_model
    ff = mo.d_expert or jc.d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)

    p = {"router": router_scale * w(d, mo.n_experts, fan_in=d),
         "w_gate": w(mo.n_experts, d, ff, fan_in=d),
         "w_up": w(mo.n_experts, d, ff, fan_in=d),
         "w_down": w(mo.n_experts, ff, d, fan_in=ff)}
    if mo.router_aux_free:
        p["router_bias"] = (0.5 * rng.standard_normal(mo.n_experts)).astype(
            np.float32)
    if mo.n_shared:
        sf = ff * mo.n_shared
        p["shared"] = {"w_gate": w(d, sf, fan_in=d), "w_up": w(d, sf,
                                                               fan_in=d),
                       "w_down": w(sf, d, fan_in=sf)}
    x = rng.standard_normal((*t, d)).astype(np.float32)
    if variant.startswith("drops"):
        r0 = p["router"][:, 0]
        x = (x + 2 * r0 / np.linalg.norm(r0)).astype(np.float32)
    return jc, tc, p, x


def _ref_route(p, xf, cfg):
    """The reference's routing, by the lines of ``moe_fwd``
    (``src/repro/models/layers.py:418-437``) that it does not return:
    (experts, probs, order, rank, keep, slot, cap)."""
    mo = cfg.moe
    t = xf.shape[0]
    logits = jnp.einsum("td,de->te", xf.astype(jnp.float32), p["router"])
    sel = logits + p["router_bias"] if "router_bias" in p else logits
    _, experts = jax.lax.top_k(sel, mo.top_k)
    probs = jax.nn.softmax(jnp.take_along_axis(logits, experts, axis=1),
                           axis=-1)
    flat_e = experts.reshape(-1)
    order = jnp.argsort(flat_e)
    sorted_e = flat_e[order]
    first = jnp.searchsorted(sorted_e, sorted_e, side="left")
    rank = jnp.arange(t * mo.top_k) - first
    cap = int(math.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor))
    keep = rank < cap
    slot = jnp.where(keep, sorted_e * cap + rank, mo.n_experts * cap)
    return experts, probs, order, rank, keep, slot, cap


def _assert_same_route(tp, jp, x, tc, jc):
    got = TL.moe_route(tp, torch.from_numpy(x).reshape(-1, x.shape[-1]), tc)
    want = _ref_route(jp, jnp.asarray(x).reshape(-1, x.shape[-1]), jc)
    experts, probs, order, rank, keep, slot, cap = want
    assert got.cap == cap
    for name, a, b in (("experts", got.experts, experts),
                       ("order", got.order, order), ("rank", got.rank, rank),
                       ("keep", got.keep, keep), ("slot", got.slot, slot)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    _close(got.probs, probs, 1e-6)
    return got


def _selection_gap(p, x, cfg):
    """The least gap, over tokens, between the k-th and (k+1)-th largest
    biased router logit."""
    sel = x.reshape(-1, x.shape[-1]).astype(np.float64) @ p["router"]
    if "router_bias" in p:
        sel = sel + p["router_bias"]
    top = -np.sort(-sel, axis=1)
    k = cfg.moe.top_k
    return float(np.min(top[:, k - 1] - top[:, k]))


def test_moe_holder_matches_reference_init():
    """``layers.MoE`` holds ``init_moe``'s parameters under the reference's
    names and shapes (``shared`` nested as ``shared.w_gate``), the router
    and its bias float32 in a bfloat16 model, the router at scale 0.02."""
    jc = _moe_cfg(J_CFG, **VARIANTS["bias_shared"])
    tc = _moe_cfg(T_CFG, **VARIANTS["bias_shared"])
    want = jax.eval_shape(lambda k: JL.init_moe(k, jc, jnp.bfloat16),
                          jax.random.PRNGKey(0))
    moe = TL.MoE(tc, torch.bfloat16,
                 generator=torch.Generator().manual_seed(0))
    got = {n: (tuple(p.shape), str(p.dtype).split(".")[1])
           for n, p in moe.named_parameters()}
    flat = convert._flatten(want)
    assert got == {n: (tuple(a.shape), str(a.dtype))
                   for n, a in flat.items()}
    assert "shared.w_gate" in got and "router_bias" in moe
    assert bool((moe.router_bias == 0).all())
    assert abs(float(moe.router.std()) / 0.02 - 1) < 0.2
    assert not any(p.requires_grad for p in moe.parameters())


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_fwd_matches_reference(variant):
    """``moe_fwd`` on x [2, 12, 64]: the routing equal to the reference's,
    the output within 1e-5 of its scale. The capacity-bound variants
    (factor 1, cap 12, the 48 assignments skewed toward expert 0) drop
    assignments and leave slots empty."""
    jc, tc, p, x = _layer_case(variant, seed=len(variant), router_scale=4.0)
    assert _selection_gap(p, x, jc) >= GAP
    route = _assert_same_route(_t(p), p, x, tc, jc)
    want = JL.moe_fwd(p, jnp.asarray(x), jc)
    got = TL.moe_fwd(_t(p), torch.from_numpy(x), tc)
    assert got.shape == x.shape and got.dtype == torch.float32
    _scaled_close(got, want, OUT_RTOL)
    dropped = int((~route.keep).sum())
    if variant.startswith("drops"):
        assert route.cap == 12 and dropped > 0
        filled = torch.bincount(route.experts.reshape(-1)[
            route.order[route.keep]], minlength=4)
        assert int(filled.min()) < route.cap      # an empty slot too
    else:
        assert dropped == 0


@pytest.mark.parametrize("bias", [[100.0, 0.0, 0.0, -100.0],
                                  [0.0, 100.0, 100.0, 0.0]])
def test_tied_experts_take_the_lower_index(bias):
    """A router whose columns 1 and 2 are equal, so every token's logits
    tie there; a router bias that puts the tie at the k-th place (expert
    1 chosen, 2 not) or at the top (1 before 2). The port picks as
    ``jax.lax.top_k`` does, and with capacity drops (factor 1) the
    ranks and the output follow."""
    jc, tc, p, x = _layer_case("drops_bias_shared", seed=3)
    p["router"][:, 2] = p["router"][:, 1]
    p["router_bias"] = np.asarray(bias, np.float32)
    route = _assert_same_route(_t(p), p, x, tc, jc)
    want_ids = [0, 1] if bias[0] else [1, 2]
    assert (route.experts.numpy() == want_ids).all()
    assert int((~route.keep).sum()) > 0
    _scaled_close(TL.moe_fwd(_t(p), torch.from_numpy(x), tc),
                  JL.moe_fwd(p, jnp.asarray(x), jc), OUT_RTOL)


def test_top_k_ids_orders_ties_as_jax():
    """``top_k_ids`` on 64 rows of 16 values drawn from {0, 1, 2, 3} (many
    ties at every k) equals ``jax.lax.top_k``'s indices, at k = 1, 2, 8."""
    s = np.random.default_rng(5).integers(0, 4, (64, 16)).astype(np.float32)
    for k in (1, 2, 8):
        np.testing.assert_array_equal(
            TL.top_k_ids(torch.from_numpy(s), k).numpy(),
            np.asarray(jax.lax.top_k(jnp.asarray(s), k)[1]))


@pytest.mark.parametrize("variant", ["plain", "bias_shared"])
def test_moe_aux_loss_matches_reference(variant):
    jc, tc, p, x = _layer_case(variant, seed=6)
    want = JL.moe_aux_loss(p, jnp.asarray(x), jc)
    got = TL.moe_aux_loss(_t(p), torch.from_numpy(x), tc)
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want, 0, 1e-6)


@pytest.mark.parametrize("variant", ["drops", "drops_bias_shared"])
def test_moe_fwd_matches_plain_per_expert(variant):
    """The port alone: ``moe_fwd`` (sort, ranks, slots, batched GEMMs,
    gather combine) against ``moe_fwd_plain`` (each expert's first
    ``cap`` assignments in flat order), with drops, at B x S = 3 x 20."""
    _, tc, p, x = _layer_case(variant, seed=7, t=(3, 20))
    tp, xt = _t(p), torch.from_numpy(x)
    plain = TL.moe_fwd_plain(tp, xt, tc)
    _scaled_close(TL.moe_fwd(tp, xt, tc), plain.numpy(), OUT_RTOL)
    assert int((~TL.moe_route(tp, xt.reshape(60, -1), tc).keep).sum()) > 0


@pytest.mark.parametrize("variant", ["plain", "bias_shared", "drops",
                                     "drops_bias_shared"])
def test_moe_gradients_match_reference(variant):
    """d/d(params, x) of sum(moe_fwd(p, x) * c) against ``jax.grad``:
    router, experts, shared expert and input within 1e-4 x max(1,
    max|ref|). ``router_bias`` shifts only the selection: ``jax.grad``
    gives zeros, autograd no gradient."""
    jc, tc, p, x = _layer_case(variant, seed=8, router_scale=4.0)
    assert _selection_gap(p, x, jc) >= GAP
    c = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    gp, gx = jax.grad(lambda pp, xx: jnp.sum(JL.moe_fwd(pp, xx, jc) * c),
                      argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    tp = jax.tree.map(lambda a: a.requires_grad_(), _t(p))
    xt = torch.from_numpy(x).requires_grad_()
    (TL.moe_fwd(tp, xt, tc) * torch.from_numpy(c)).sum().backward()
    _scaled_close(xt.grad, gx, GRAD_SCALE_TOL)
    want = convert._flatten(_np(gp))
    got = convert._flatten(tp)
    assert set(got) == set(want)
    for name, a in got.items():
        if name == "router_bias":
            assert a.grad is None and not np.any(want[name])
            continue
        assert a.grad is not None, name
        _scaled_close(a.grad, want[name], GRAD_SCALE_TOL)


# ---------------------------------------------------------------------------
# the smoke model
# ---------------------------------------------------------------------------

def _params(rng, cfg):
    """A param tree of the reference's shapes drawn with numpy: the
    embedding and unembedding 0.02 N(0, 1), norm scales 1 + 0.2 N(0, 1),
    every other weight N(0, 1) / sqrt(fan-in) (a stacked leaf's first axis
    is its layer's; an expert weight's fan-in its second axis)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape[1:] if "'body'" in name else leaf.shape
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "'embed'" in name or "'unembed'" in name:
            return jnp.asarray(0.02 * z)
        if "'scale'" in name:
            return jnp.asarray(1 + 0.2 * z)
        if "'router_bias'" in name:
            return jnp.zeros(leaf.shape, jnp.float32)
        if "'wo'" in name:
            fan_in = shape[0] * shape[1]
        elif len(shape) == 3 and "'ffn'" in name:        # [E, in, out]
            fan_in = shape[1]
        else:
            fan_in = shape[0]
        return jnp.asarray(z / np.float32(np.sqrt(fan_in)))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(rng, b, s, vocab):
    """tokens / labels / mask as numpy: labels the next token, a -1
    sentinel at position 5 (masked), the last position and a few more
    masked."""
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, 5] = -1
    mask = np.ones((b, s), np.float32)
    mask[:, [5, -1]] = 0.0
    mask[-1, 10:14] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# the reference's loss and gradients of one batch, jitted once for the
# batch shape of these tests
_j_loss_grad = jax.jit(jax.value_and_grad(
    lambda p, b: JM.train_forward(p, b, J_CFG)))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, a batch, and its loss and gradients."""
    rng = np.random.default_rng(0)
    params = _params(rng, J_CFG)
    batch = _batch(rng, 2, SEQ, J_CFG.vocab)
    loss, grads = _j_loss_grad(params, _jb(batch))
    return {"params": params, "np": _np(params), "batch": batch,
            "loss": float(loss), "grads": _np(grads)}


def _lm(ref, cfg=T_CFG, requires_grad=False):
    return convert.lm_params_from_arrays(
        cfg, ref["np"], device="cpu").requires_grad_(requires_grad)


def test_params_carried_across(ref):
    lm = _lm(ref)
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    want = convert.lm_arrays_by_name(T_CFG, ref["np"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    assert all(isinstance(b.ffn, TL.MoE) for b in lm.blocks)
    np.testing.assert_array_equal(
        named["blocks.1.ffn.w_down"].numpy(),
        ref["np"]["body"][0]["ffn"]["w_down"][1])
    assert not hasattr(lm, "mtp")


def test_forward_logits_match_reference(ref):
    toks = np.random.default_rng(1).integers(0, 256, (2, 19)).astype(
        np.int32)
    want = JM.forward_logits(ref["params"], jnp.asarray(toks), J_CFG)
    got = TM.forward_logits(_lm(ref), torch.from_numpy(toks), T_CFG)
    assert got.dtype == torch.float32 and got.shape == (2, 19, 256)
    _close(got, want)


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


# the leaves whose int8 update is compared with the reference's: the
# first MoE layer's feed-forward (stacked 3- and 4-axis leaves), the
# embedding (rows the batch does not use get no gradient: all-zero
# blocks) and the final norm
INT8_LEAVES = ("blocks.0.ffn.", "embed", "final_norm.")


def test_train_step_int8_matches_reference(ref):
    """``make_train_step`` with int8 moments on 2 microbatches (the
    fixture's batch and one more): its loss and mean gradients against the
    reference's, then its update against the reference's
    ``apply_updates`` (op by op) on the same gradients, for the leaves of
    ``INT8_LEAVES``: parameters, and every moment's codes and scales
    exactly. ``grad_clip`` is set so high that the clip factor is exactly
    1 in both (the two global norms differ in their last bits, which a
    clip factor below 1 would carry into every moment), so each leaf's
    update is its own and a subset of the tree can be compared."""
    rng = np.random.default_rng(2)
    micro = [ref["batch"], _batch(rng, 2, SEQ, J_CFG.vocab)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    opt = dict(quantize_moments=True, grad_clip=1e9, **OPT)
    cfg = TO.OptConfig(**opt)
    lm = _lm(ref, requires_grad=True)
    lm, state, m = make_train_step(T_CFG, cfg)(
        lm, TO.init_opt_state(lm, cfg), _tb(batch))
    loss2, grads2 = _j_loss_grad(ref["params"], _jb(micro[1]))
    _close(m["loss"], (ref["loss"] + float(loss2)) / 2, 0, 1e-5)
    want_g = convert.lm_arrays_by_name(T_CFG, jax.tree.map(
        lambda a, b: (a + b) / 2, ref["grads"], _np(grads2)))
    named = dict(lm.named_parameters())
    for name, p in named.items():
        _close(p.grad, want_g[name], GRAD_ATOL, GRAD_RTOL)
    assert bool((named["embed"].grad.abs().sum(1) == 0).any())
    # the reference's update of those leaves, on the port's gradients; a
    # scanned layer's leaf gets the reference's extra (layer) axis, so
    # that it decays as the reference's stacked leaf does
    before = convert.lm_arrays_by_name(T_CFG, ref["np"])
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


def test_decode_steps_drop_as_the_reference(ref):
    """At capacity factor 0.5 a decode step of B = 4 tokens has cap =
    ceil(4 x 2 / 4 x 0.5) = 1 slot an expert (``deepseek-v3-671b``'s cap
    in decode at B = 4), so at least 4 of its 8 assignments drop in every
    MoE layer: five single-token steps from a cache carried across, logits
    and caches against the reference's steps."""
    jc, tc = _moe_cfg(J_CFG, capacity_factor=0.5), _moe_cfg(
        T_CFG, capacity_factor=0.5)
    b, max_len = 4, 8
    assert TL.moe_capacity(b, tc.moe) == 1
    lm = _lm(ref, tc)
    toks = np.random.default_rng(3).integers(0, 256, (b, 7)).astype(np.int32)

    step = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, jc))

    def jstep(c, t):
        return step(ref["params"], c, jnp.asarray(t))

    jcache = JM.init_decode_cache(jc, b, max_len, jnp.float32)
    _, jcache = jstep(jcache, toks[:, :1])
    tcache = convert.decode_cache_from_arrays(tc, _np(jcache), device="cpu")
    for i in range(1, 6):
        want, jcache = jstep(jcache, toks[:, i:i + 1])
        got, tcache = TM.decode_step(lm, tcache, torch.from_numpy(
            toks[:, i:i + 1]), tc)
        _close(got, want)
        for tl, jl in zip(tcache, convert._unstack(_np(jcache), tc)):
            assert tl["length"] == int(jl["length"]) == i + 1
            _close(tl["k"], jl["k"])
            _close(tl["v"], jl["v"])


def test_decode_matches_parallel_forward(ref):
    """The port alone, dropless (capacity factor 8): token-by-token decode,
    and a cache-writing prefill of 7 tokens given their positions followed
    by single-token steps, reproduce the parallel forward."""
    lm = _lm(ref)
    s = 12
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, s)).astype(np.int32))
    want = TM.forward_logits(lm, tokens, T_CFG).numpy()
    for prompt in (1, 7):
        cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                     device="cpu")
        whole, cache = TM.decode_step(lm, cache, tokens[:, :prompt], T_CFG,
                                      pos=torch.arange(prompt).expand(
                                          2, prompt))
        got = [whole.numpy()]
        for i in range(prompt, s):
            logits, cache = TM.decode_step(lm, cache, tokens[:, i:i + 1],
                                           T_CFG)
            got.append(logits.numpy())
        _close(np.concatenate(got, 1), want, PARALLEL_TOL)


# ---------------------------------------------------------------------------
# the full config, launchers
# ---------------------------------------------------------------------------

def test_count_params_full_config_on_meta():
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == 316_489_340_928
    active = cfg.active_param_count()
    assert active == TM.count_params(cfg, active_only=True) == \
        jcfg.active_param_count() == 84_561_106_944
    model = TM.init_params(cfg, device="meta")
    assert next(model.parameters()).is_meta
    assert tuple(model.blocks[63].ffn.w_down.shape) == (8, 32768, 6144)
    assert cfg.layer_kinds == ("attn",) * 64


def test_launchers_on_cpu(capsys):
    """``launch/train.py`` and ``launch/serve_lm.py`` with ``--arch
    grok-1-314b --smoke --device cpu``: two finite training steps, and
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
