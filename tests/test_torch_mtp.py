"""``deepseek-v3-671b`` in the port against the JAX reference, at its smoke
size: 3 dense-prefix ``attn_dense`` layers and 2 MoE layers (4 experts
top-2 of width 32, a shared expert, the aux-free ``router_bias``,
capacity factor 8: dropless), MLA throughout (ranks 32 / 16, d_nope 16,
d_rope 8, d_v 16), d_model 64, 4 heads, vocab 256, and the multi-token
head, with the reference's parameters drawn with numpy in its shapes and
carried across by ``convert`` (the unstacked ``prefix`` list, the stacked
``body``, the top-level ``mtp``, the nested ``shared``):

- the model's names and kinds: ``layer_kinds``, the prefix's SwiGLU and
  the body's MoE, ``mtp.proj``, ``mtp.block`` (an ``attn_dense`` block)
  and ``mtp.norm``;
- ``train_forward``'s loss, the multi-token head's term included, and
  every gradient against ``jax.value_and_grad`` of the reference's;
  ``router_bias`` gets no gradient (``jax.grad``: zeros); the loss with
  the head larger than without it (the port of ``tests/test_models.py::
  test_mtp_loss_larger_than_plain``) and that one equal to the
  reference's;
- ``make_train_step`` on 2 microbatches against the reference's jitted
  step: loss, gradient norm, every parameter and both float32 moments,
  ``router_bias`` and its moments staying exactly 0; ``apply_updates``
  with int8 moments where ``router_bias`` has no gradient (None), against
  the reference's (op by op) on the reference's gradients: parameters,
  codes and scales exactly, the bias and its codes 0;
- ``decode_step`` token by token from a cache carried across against the
  reference's steps, and the port's decode against its own parallel
  forward (prefix layers, MoE and MLA's absorbed decode), which the
  multi-token head does not enter;
- the full config's counts on the meta device (670,303,384,064, active
  36,829,262,336) and both LM launchers on ``--arch deepseek-v3-671b``.

The reference's loss, gradients, train step and decode step run jitted
(as its own tests run them), its int8 optimizer op by op (under ``jit``
XLA divides by 127 as a reciprocal multiply, which rounds otherwise).
Tolerances: ``rtol=1e-5`` on losses, ``atol=1e-6, rtol=1e-4`` on
gradients, ``atol=1e-6`` on parameters after an optimizer step,
``atol=2e-3`` on parameters after a whole train step and ``atol=1e-6,
rtol=1e-4`` on its moments, ``atol=rtol=1e-4`` on logits and caches,
``atol=rtol=2e-3`` on decode against the parallel forward (the reference
test's).
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
from repro_torch.train.train_step import make_train_step

ARCH = "deepseek-v3-671b"
TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARALLEL_TOL = STEP_ATOL = 2e-3
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 16
BIASES = ("blocks.3.ffn.router_bias", "blocks.4.ffn.router_bias")


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _params(rng, cfg):
    """A param tree of the reference's shapes drawn with numpy: the
    embedding and unembedding 0.02 N(0, 1), norm scales 1 + 0.2 N(0, 1),
    ``router_bias`` 0 (its init), every other weight N(0, 1) /
    sqrt(fan-in) (a stacked leaf's first axis is its layer's; an expert
    weight's fan-in its second axis; an output projection's its first
    two)."""
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


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, a batch, and its loss (with and
    without the multi-token head) and gradients."""
    rng = np.random.default_rng(0)
    params = _params(rng, J_CFG)
    batch = _batch(rng, 2, SEQ)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: JM.train_forward(
        p, _jb(batch), J_CFG)))(params)
    plain = jax.jit(lambda p: JM.train_forward(
        p, _jb(batch), dataclasses.replace(J_CFG, mtp=False)))(params)
    return {"params": params, "np": _np(params), "batch": batch,
            "loss": float(loss), "loss_no_mtp": float(plain),
            "grads": _np(grads)}


def _lm(ref, requires_grad=False):
    return convert.lm_params_from_arrays(
        T_CFG, ref["np"], device="cpu").requires_grad_(requires_grad)


def test_model_names_and_kinds(ref):
    """The dense prefix keeps its SwiGLU (``_layer_uses_moe``: only
    ``attn`` layers), the body's layers are MoE with a nested shared
    expert, and the multi-token head holds the reference's ``mtp`` tree:
    every parameter carried across by ``lm_params_from_arrays``."""
    assert T_CFG.layer_kinds == ("attn_dense",) * 3 + ("attn",) * 2
    assert get_config(ARCH).layer_kinds == ("attn_dense",) * 3 + (
        "attn",) * 58
    lm = _lm(ref)
    assert [type(b.ffn).__name__ for b in lm.blocks] == (
        ["SwiGLU"] * 3 + ["MoE"] * 2)
    assert all(isinstance(b.mixer, TL.MLA) for b in lm.blocks)
    assert isinstance(lm.mtp.block.ffn, TL.SwiGLU)
    named = dict(lm.named_parameters())
    want = convert.lm_arrays_by_name(T_CFG, ref["np"])
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    assert {n for n in named if n.startswith("mtp.")} >= {
        "mtp.proj", "mtp.norm.scale", "mtp.block.mixer.kv_b",
        "mtp.block.ffn.w_down"}
    assert tuple(named["mtp.proj"].shape) == (128, 64)
    assert "blocks.4.ffn.shared.w_gate" in named and all(
        b in named for b in BIASES)
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)


def test_train_forward_with_mtp_and_every_gradient_match_reference(ref):
    lm = _lm(ref, requires_grad=True)
    loss = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
    _close(loss, ref["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    named = dict(lm.named_parameters())
    for name, p in named.items():
        if name in BIASES:
            assert p.grad is None and not np.any(want[name]), name
            continue
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)


def test_mtp_loss_larger_than_plain(ref):
    """The multi-token head adds 0.1 x its cross-entropy: the loss without
    it (``mtp=False`` on the same parameters, the head left unused) is
    the reference's too, and smaller."""
    lm = _lm(ref)
    with torch.no_grad():
        with_mtp = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
        plain = TM.train_forward(lm, _tb(ref["batch"]), dataclasses.replace(
            T_CFG, mtp=False))
    _close(plain, ref["loss_no_mtp"], 0, 1e-5)
    assert float(with_mtp) > float(plain)


def test_train_step_matches_reference(ref):
    """One ``make_train_step`` of 2 microbatches against the reference's
    jitted step from the same parameters (float32 moments): loss,
    gradient norm, every parameter and moment after it. ``router_bias``
    gets no gradient in either: it and its moments stay exactly 0."""
    rng = np.random.default_rng(7)
    micro = [_batch(rng, 2, SEQ) for _ in range(2)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    j_cfg = JO.OptConfig(**OPT)
    step = jax.jit(j_make_train_step(J_CFG, j_cfg))
    p, st, want_m = step(ref["params"], JO.init_opt_state(ref["params"],
                                                          j_cfg), _jb(batch))
    cfg = TO.OptConfig(**OPT)
    lm = _lm(ref, requires_grad=True)
    lm, state, m = make_train_step(T_CFG, cfg)(
        lm, TO.init_opt_state(lm, cfg), _tb(batch))
    _close(m["loss"], want_m["loss"], 0, 1e-5)
    _close(m["grad_norm"], want_m["grad_norm"], 0, 1e-4)
    want = convert.lm_arrays_by_name(T_CFG, _np(p))
    named = dict(lm.named_parameters())
    for name, q in named.items():
        _close(q, want[name], STEP_ATOL, 0)
    for mom in ("m", "v"):
        wm = convert.lm_arrays_by_name(T_CFG, _np(st[mom]))
        for name, got in state[mom].items():
            _close(got, wm[name], GRAD_ATOL, GRAD_RTOL)
    for name in BIASES:
        assert named[name].grad is None
        assert not named[name].any() and not np.any(want[name])
        assert not state["m"][name].any() and not state["v"][name].any()
    assert int(state["step"]) == 1


def test_apply_updates_int8_with_no_gradient_matches_reference(ref):
    """``apply_updates`` with int8 moments from the zero state, on the
    reference's gradients with ``router_bias``'s given as None (what
    autograd leaves there), against the reference's (op by op, zeros
    there) for the first MoE layer's router, bias, expert and shared
    down projections, the multi-token head's norm and the final norm. The clip factor is exactly 1 (``grad_clip``
    set high), so each leaf's update is its own. The bias's blocks are
    all zero: their second moment decodes to 0 in both (the reference's
    float32 flushes the floor's subnormal square), so its codes are 0 and
    it stays 0."""
    grads = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    params = convert.lm_arrays_by_name(T_CFG, ref["np"])
    keys = [f"blocks.3.ffn.{n}" for n in ("router", "router_bias",
                                          "w_down", "shared.w_down")]
    keys += ["mtp.norm.scale", "final_norm.scale"]
    assert BIASES[0] in keys
    opt = dict(quantize_moments=True, grad_clip=1e9, **OPT)
    body = {n for n in keys if n.startswith("blocks.3.")}   # scanned

    def stacked(name, a):
        return jnp.asarray(np.asarray(a)[None] if name in body else a)

    jp = {n: stacked(n, params[n]) for n in keys}
    jg = {n: stacked(n, grads[n]) for n in keys}
    j_cfg = JO.OptConfig(**opt)
    p1, st1, jm = JO.apply_updates(jp, jg, JO.init_opt_state(jp, j_cfg),
                                   j_cfg)
    tp = {n: torch.from_numpy(np.array(params[n])) for n in keys}
    tg = {n: None if n == BIASES[0] else torch.from_numpy(
        np.array(grads[n])) for n in keys}
    cfg = TO.OptConfig(**opt)
    _, new, metrics = TO.apply_updates(tp, tg, TO.init_opt_state(tp, cfg),
                                       cfg, stacked=body)
    _close(metrics["grad_norm"], jm["grad_norm"], 0, 1e-6)
    for name in keys:
        def lead(a, name=name):
            return np.asarray(a)[0] if name in body else np.asarray(a)
        _close(tp[name], lead(p1[name]), 1e-6, 0)
        for mom in ("m", "v"):
            np.testing.assert_array_equal(new[mom][name]["code"].numpy(),
                                          lead(st1[mom][name]["code"]),
                                          err_msg=name)
            np.testing.assert_array_equal(new[mom][name]["scale"].numpy(),
                                          lead(st1[mom][name]["scale"]),
                                          err_msg=name)
    assert not tp[BIASES[0]].any()
    assert not new["v"][BIASES[0]]["code"].any()


def test_decode_step_matches_reference_token_by_token(ref):
    """Two steps in the reference, its cache (prefix and body, latent and
    rope key) carried across by ``decode_cache_from_arrays``, then two
    single-token steps of each package (the absorbed decode): logits and
    every layer's cache."""
    lm = _lm(ref)
    b, max_len = 2, 8
    toks = np.random.default_rng(2).integers(0, 256, (b, 4)).astype(np.int32)

    step = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, J_CFG))

    def jstep(c, t):
        return step(ref["params"], c, jnp.asarray(t))

    jcache = JM.init_decode_cache(J_CFG, b, max_len, jnp.float32)
    for i in range(2):
        _, jcache = jstep(jcache, toks[:, i:i + 1])
    tcache = convert.decode_cache_from_arrays(T_CFG, _np(jcache),
                                              device="cpu")
    assert len(tcache) == T_CFG.n_layers
    for i in range(2, 4):
        want, jcache = jstep(jcache, toks[:, i:i + 1])
        got, tcache = TM.decode_step(lm, tcache, torch.from_numpy(
            toks[:, i:i + 1]), T_CFG)
        _close(got, want)
        for tl, jl in zip(tcache, convert._unstack(_np(jcache), T_CFG)):
            assert tl["length"] == int(jl["length"]) == i + 1
            _close(tl["latent"], jl["latent"])
            _close(tl["k_rope"], jl["k_rope"])


def test_decode_matches_parallel_forward(ref):
    """The port of ``tests/test_models.py::test_decode_matches_parallel_
    forward[deepseek-v3-671b]`` on the port alone: token-by-token decode,
    and a cache-writing prefill of 7 tokens given their positions followed
    by single-token steps, reproduce the parallel forward."""
    lm = _lm(ref)
    s = 12
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
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


def test_count_params_full_config_on_meta():
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == \
        670_303_384_064
    assert cfg.active_param_count() == jcfg.active_param_count() == \
        TM.count_params(cfg, active_only=True) == 36_829_262_336
    model = TM.init_params(cfg, device="meta")
    assert next(model.parameters()).is_meta
    assert tuple(model.blocks[3].ffn.w_gate.shape) == (256, 7168, 2048)
    assert tuple(model.blocks[3].ffn.shared.w_down.shape) == (2048, 7168)
    assert tuple(model.blocks[2].ffn.w_gate.shape) == (7168, 2048)
    assert tuple(model.mtp.proj.shape) == (14336, 7168)


def test_launchers_on_cpu(capsys):
    """``launch/train.py`` and ``launch/serve_lm.py`` with ``--arch
    deepseek-v3-671b --smoke --device cpu``: two finite training steps
    (the multi-token head's term in the loss), and generation at the
    serving launcher's defaults."""
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
