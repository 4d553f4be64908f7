"""The port's training path vs the JAX reference, at the smoke size of
``rwkv6-7b`` (2 layers, d_model 64, 4 heads of 16, vocab 256), with the
reference's parameters, gradients and optimizer state carried across by
``convert`` (every layer's bonus ``u`` drawn nonzero). The reference runs
once, in the module fixture.

- The chunked-parallel core (``layers.rwkv_chunked_core``) against the
  reference's ``_rwkv_chunked_core`` and ``_rwkv_scan_core`` at S = 37
  (padded to 48) and S = 32: output, final state, and the gradients of a
  fixed scalar of both (``jax.grad`` of each reference core):
  ``atol=rtol=1e-4`` on outputs of magnitude up to about 30; each
  gradient within ``1e-4 x max(1, max|reference|)`` (float32: the w
  gradient passes through exp(-log A) and exp(log A) factors up to e^80
  apart, and the reference's own two cores differ there by up to 2.3e-5
  of its largest value; the port by up to 4.4e-5).
- ``chunked_ce_loss`` (one chunk and four, masked and ``-1`` labels) and
  ``train_forward``'s loss and every parameter's gradient against
  ``jax.value_and_grad`` of the reference's: ``rtol=1e-5`` on the loss,
  ``atol=1e-6, rtol=1e-4`` on gradients (seen: 6e-8 at most); remat on
  against remat off exactly.
- ``apply_updates`` from a carried-across state, float32 moments
  (``atol=1e-6`` on parameters and moments) and int8 moments (codes
  equal, scales bitwise equal: with the clip factor exactly 1 both
  frameworks do the same float32 operations and round half to even), and
  with the clip engaged (``atol=1e-6``).
- One and three steps of ``make_train_step`` against the reference's
  jitted step: ``atol=2e-3`` on the parameters (as
  ``tests/test_train_infra.py:56-57``: reassociated sums are amplified by
  Adam's 1/sqrt(v) where v is tiny; steps two and three from the
  reference's state before them), ``rtol=1e-5`` on the losses;
  ``n_micro=1`` against ``n_micro=4`` in the port as in the reference's
  test (loss ``rtol=1e-5``, parameters ``atol=2e-3``).
- ``rwkv_scan`` refuses inputs that need a gradient, and the time mix
  trains through the chunked core.
"""
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
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step

J_CFG = j_smoke(j_get("rwkv6-7b"))
T_CFG = smoke_config(get_config("rwkv6-7b"))
CORE_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
STEP_ATOL = 2e-3
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 37


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, b, s, n_micro=None):
    """tokens/labels/mask as numpy: labels the next token, a ``-1``
    sentinel at position 5 (masked), the last position and a few more
    masked."""
    toks = rng.integers(0, J_CFG.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, 5] = -1
    mask = np.ones((b, s), np.float32)
    mask[:, [5, -1]] = 0.0
    mask[-1, 10:14] = 0.0
    batch = {"tokens": toks, "labels": labels, "mask": mask}
    if n_micro:
        batch = {k: v.reshape((n_micro, b // n_micro) + v.shape[1:])
                 for k, v in batch.items()}
    return batch


def _core_inputs(rng, s):
    b, h, hd = 2, 3, 8
    r, k, v, x = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.clip(np.exp(x), 0, 5)).astype(np.float32)
    u = (0.1 * rng.standard_normal((h, hd))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, hd, hd))).astype(np.float32)
    c_out = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    c_st = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return (r, k, v, w, u, s0), (c_out, c_st)


def _scalar(out, state, c_out, c_st):
    return (out * c_out).sum() + (state * c_st).sum()


@pytest.fixture(scope="module")
def ref():
    """Everything the tests hold the port to, from the reference."""
    rng = np.random.default_rng(0)
    out = {}
    # the chunked core and the sequential scan, with gradients
    for s in (SEQ, 32):
        ins, cs = _core_inputs(rng, s)
        jins = [jnp.asarray(a) for a in ins]
        case = dict(ins=ins, cs=cs)
        for name, core in (("chunked",
                            lambda *a: JL._rwkv_chunked_core(*a, 16)),
                           ("scan", JL._rwkv_scan_core)):
            fn = jax.jit(jax.value_and_grad(
                lambda *a: _scalar(*core(*a), *cs), argnums=tuple(range(6)),
                has_aux=False))
            grads = fn(*jins)[1]
            case[name] = (_np(jax.jit(core)(*jins)), _np(grads))
        out[f"core{s}"] = case

    # the model: reference parameters with a nonzero u in every layer
    params = jax.jit(JM.init_params, static_argnums=0)(
        J_CFG, jax.random.PRNGKey(0))
    mixer = dict(params["body"][0]["mixer"])
    mixer["u"] = jnp.asarray(
        0.1 * rng.standard_normal(mixer["u"].shape).astype(np.float32))
    params["body"][0] = dict(params["body"][0], mixer=mixer)
    out["params"] = _np(params)

    # chunked_ce_loss alone, one chunk and four
    x = rng.standard_normal((2, 32, J_CFG.d_model)).astype(np.float32)
    ce_batch = _batch(rng, 2, 32)
    for chunk in (512, 8):
        f = lambda xx, un: JM.chunked_ce_loss(
            xx, un, jnp.asarray(ce_batch["labels"]),
            jnp.asarray(ce_batch["mask"]), chunk=chunk)
        loss, g = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(
            jnp.asarray(x), params["unembed"])
        out[f"ce{chunk}"] = dict(loss=float(loss), grads=_np(g))
    out["ce_in"] = (x, ce_batch)

    # train_forward's loss and gradients
    batch = _batch(rng, 2, SEQ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.train_forward(p, jb, J_CFG)))(params)
    out["fwd"] = dict(batch=batch, loss=float(loss), grads=_np(grads))

    # apply_updates: a first step from zero state, then the compared one;
    # gradients small enough that the clip factor is exactly 1, and large
    # ones that engage it
    def rand_tree(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            scale * rng.standard_normal(p.shape).astype(np.float32)),
            params)

    # (op by op: under jit XLA divides by the 127 of the scales as a
    # reciprocal multiply, which rounds otherwise)
    for quant in (False, True):
        cfg = JO.OptConfig(quantize_moments=quant, **OPT)
        st0 = JO.init_opt_state(params, cfg)
        p1, st1, _ = JO.apply_updates(params, rand_tree(1e-3), st0, cfg)
        for tag, scale in (("small", 1e-3), ("clipped", 1.0)):
            if quant and tag == "clipped":
                continue
            g = rand_tree(scale)
            p2, st2, m = JO.apply_updates(p1, g, st1, cfg)
            out[f"opt_{quant}_{tag}"] = dict(
                before=(_np(p1), _np(st1)), grads=_np(g),
                after=(_np(p2), _np(st2)), metrics=_np(m))

    # one and three train steps (the reference's jitted step, 2 micro-
    # batches), on three batches
    step = jax.jit(j_make_train_step(J_CFG, JO.OptConfig(**OPT)))
    st = JO.init_opt_state(params, JO.OptConfig(**OPT))
    p, batches, logs = params, [], []
    for i in range(3):
        batches.append(_batch(rng, 4, SEQ, n_micro=2))
        logs.append(dict(before=(_np(p), _np(st))))
        p, st, m = step(p, st, {k: jnp.asarray(v)
                                for k, v in batches[-1].items()})
        logs[-1].update(params=_np(p), metrics=_np(m))
    out["steps"] = dict(batches=batches, logs=logs)
    return out


def _lm(tree, requires_grad=True):
    return convert.lm_params_from_arrays(
        T_CFG, tree, device="cpu").requires_grad_(requires_grad)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _close_scaled(got, want, tol):
    """max |got - want| <= tol * max(1, max |want|)."""
    got, want = got.detach().numpy(), np.asarray(want)
    err, scale = np.abs(got - want).max(), max(1.0, np.abs(want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("s", [SEQ, 32])
@pytest.mark.parametrize("core", ["chunked", "scan"])
def test_chunked_core_matches_reference(ref, s, core):
    case = ref[f"core{s}"]
    ins = [_t(a, True) for a in case["ins"]]
    o, st = TL.rwkv_chunked_core(*ins)
    assert o.shape == ins[0].shape and st.shape == ins[5].shape
    (want_o, want_st), want_grads = case[core]
    _close(o, want_o, CORE_TOL, CORE_TOL)
    _close(st, want_st, CORE_TOL, CORE_TOL)
    _scalar(o, st, *(torch.from_numpy(c) for c in case["cs"])).backward()
    for t, want in zip(ins, want_grads):
        _close_scaled(t.grad, want, CORE_TOL)


@pytest.mark.parametrize("chunk", [512, 8])
def test_chunked_ce_loss_matches_reference(ref, chunk):
    x, batch = ref["ce_in"]
    xt = _t(x, True)
    un = _t(ref["params"]["unembed"], True)
    loss = TM.chunked_ce_loss(xt, un, torch.from_numpy(batch["labels"]),
                              torch.from_numpy(batch["mask"]), chunk=chunk)
    want = ref[f"ce{chunk}"]
    assert loss.dtype == torch.float32 and loss.shape == ()
    _close(loss, want["loss"], 0, 1e-5)
    loss.backward()
    _close(xt.grad, want["grads"][0], GRAD_ATOL, GRAD_RTOL)
    _close(un.grad, want["grads"][1], GRAD_ATOL, GRAD_RTOL)


def test_train_forward_loss_and_every_gradient_match_reference(ref):
    lm = _lm(ref["params"])
    batch = {k: torch.from_numpy(v) for k, v in ref["fwd"]["batch"].items()}
    loss = TM.train_forward(lm, batch, T_CFG)
    _close(loss, ref["fwd"]["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["fwd"]["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)


def test_remat_on_equals_remat_off(ref):
    batch = {k: torch.from_numpy(v) for k, v in ref["fwd"]["batch"].items()}
    grads = []
    for remat in (True, False):
        lm = _lm(ref["params"])
        loss = TM.train_forward(lm, batch, T_CFG, remat=remat)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      lm.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


def _opt_state(tree):
    return convert.opt_state_from_arrays(T_CFG, tree, device="cpu")


@pytest.mark.parametrize("case", ["False_small", "False_clipped",
                                  "True_small"])
def test_apply_updates_matches_reference(ref, case):
    want = ref[f"opt_{case}"]
    quant = case.startswith("True")
    cfg = TO.OptConfig(quantize_moments=quant, **OPT)
    p1, st1 = want["before"]
    lm = _lm(p1, requires_grad=False)
    state = _opt_state(st1)
    grads = {n: torch.from_numpy(np.array(g)) for n, g in
             convert.lm_arrays_by_name(T_CFG, want["grads"]).items()}
    _, new, metrics = TO.apply_updates(lm, grads, state, cfg,
                                       stacked=TM.scanned_params(lm))
    p2, st2 = want["after"]
    assert int(new["step"]) == int(st2["step"]) == 2
    _close(metrics["grad_norm"], want["metrics"]["grad_norm"], 0, 1e-6)
    _close(metrics["lr"], want["metrics"]["lr"], 0, 0)
    clipped = float(metrics["grad_norm"]) > cfg.grad_clip
    assert clipped == case.endswith("clipped")
    want_p = convert.lm_arrays_by_name(T_CFG, p2)
    for name, p in lm.named_parameters():
        _close(p, want_p[name], 1e-6)
    for mom in ("m", "v"):
        wm = convert.lm_arrays_by_name(T_CFG, st2[mom])
        assert set(new[mom]) == set(wm)
        for name, got in new[mom].items():
            if quant:
                assert got["code"].dtype == torch.int8
                np.testing.assert_array_equal(got["code"].numpy(),
                                              wm[name]["code"])
                np.testing.assert_array_equal(got["scale"].numpy(),
                                              wm[name]["scale"])
            else:
                _close(got, wm[name], 1e-6)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_train_steps_match_reference(ref):
    """The port's step against the reference's jitted step on the same
    three batches (2 microbatches each). Run free from the same start,
    the losses and gradient norms of all three steps agree, and the
    parameters after the first. The parameters after the second and third
    are compared from the reference's state before each (carried across by
    ``convert``): a free-running Adam trajectory carries the first step's
    roundoff into nearly cancelling gradients (seen: an embedding element
    whose gradient, -1.32e-6 in a row whose largest is 0.085, changed sign
    after one step and moved 1.4 x lr apart)."""
    cfg = TO.OptConfig(**OPT)
    step = make_train_step(T_CFG, cfg)
    lm = _lm(ref["params"])
    state = TO.init_opt_state(lm, cfg)
    for i, (batch, log) in enumerate(zip(ref["steps"]["batches"],
                                         ref["steps"]["logs"])):
        lm, state, m = step(lm, state, _torch_batch(batch))
        _close(m["loss"], log["metrics"]["loss"], 0, 1e-5)
        _close(m["grad_norm"], log["metrics"]["grad_norm"], 0, 1e-4)
        _close(m["lr"], log["metrics"]["lr"], 0, 0)
        if i:
            p0, st0 = log["before"]
            lm_i = _lm(p0)
            lm_i, st_i, _ = step(lm_i, _opt_state(st0), _torch_batch(batch))
            assert int(st_i["step"]) == i + 1
        else:
            lm_i = lm
        want = convert.lm_arrays_by_name(T_CFG, log["params"])
        for name, p in lm_i.named_parameters():
            _close(p, want[name], STEP_ATOL)
    assert int(state["step"]) == 3


def test_microbatch_equivalence(ref):
    """The port of ``tests/test_train_infra.py::test_microbatch_equivalence``:
    four microbatches accumulate to the one-batch step (every row with
    the same mask count, so that the mean of the microbatches' means is
    the batch's mean)."""
    toks = np.random.default_rng(4).integers(
        0, J_CFG.vocab, (1, 4, SEQ)).astype(np.int32)
    mask = np.ones(toks.shape, np.float32)
    mask[..., -1] = 0.0
    flat = {"tokens": toks, "labels": np.roll(toks, -1, axis=-1),
            "mask": mask}
    cfg = TO.OptConfig(**OPT)
    outs = []
    for n_micro in (1, 4):
        lm = _lm(ref["params"])
        b = {k: v.reshape((n_micro, -1) + v.shape[2:])
             for k, v in flat.items()}
        lm, _, m = make_train_step(T_CFG, cfg)(
            lm, TO.init_opt_state(lm, cfg), _torch_batch(b))
        outs.append((float(m["loss"]), dict(lm.named_parameters())))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-5)
    for name, p in outs[0][1].items():
        _close(p, outs[1][1][name].detach().numpy(), STEP_ATOL)


def test_rwkv_scan_refuses_inputs_that_need_a_gradient(ref):
    ins = [_t(a) for a in ref["core32"]["ins"]]
    for i in range(6):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(ins)]
        with pytest.raises(RuntimeError, match="no backward"):
            rwkv_scan(*args)
        with torch.no_grad():
            out, st = rwkv_scan(*args)
        assert out.grad_fn is None and st.grad_fn is None


def test_time_mix_trains_through_the_chunked_core(ref, monkeypatch):
    """With gradients the time mix takes the chunked core (any S, also
    1); without them ``rwkv_scan``, whose result it equals."""
    calls = []
    real = TL.rwkv_chunked_core

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(TL, "rwkv_chunked_core", spy)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 12, J_CFG.d_model)).astype(np.float32))
    serve = _lm(ref["params"], requires_grad=False).blocks[0].mixer
    train = _lm(ref["params"]).blocks[0].mixer
    for s in (12, 1):
        want, _ = serve(x[:, :s])
        got, _ = train(x[:, :s])
        assert want.grad_fn is None and got.grad_fn is not None
        _close(got, want.numpy(), CORE_TOL, CORE_TOL)
        got.sum().backward()
        assert bool(train.u.grad.abs().max() > 0)
    with torch.no_grad():
        train(x)
    assert calls == [12, 1]
