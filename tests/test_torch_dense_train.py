"""The port's training path for the dense attention kinds against the JAX
reference, at the smoke sizes of ``lm-100m``, ``qwen1.5-110b`` (QKV bias)
and an ``("attn", "local_attn")`` pattern (2 kv heads of 4, window 8, a
tail layer outside the scanned periods), with the reference's
parameters (drawn with numpy in the reference's shapes), gradients and
optimizer state carried across by ``convert``:
``train_forward``'s loss and every parameter's gradient against
``jax.value_and_grad`` of the reference's, remat on against off, and one
AdamW step (``apply_updates``, ``lm-100m`` and the local pattern, whose
tail layer's vectors the reference does not decay) with float32 moments
(gradients that engage the clip) and with int8 moments (codes and scales
exactly); then the LM launchers on their default ``--arch``
(``lm-100m``) at smoke size on the CPU.

The reference runs eagerly: its loss and gradients once per config in
the module fixture, its optimizer op by op in each optimizer test (under
``jit`` XLA divides by the 127 of the int8 scales as a reciprocal
multiply). Tolerances are ``tests/test_torch_train.py``'s:
``rtol=1e-5`` on the loss, ``atol=1e-6, rtol=1e-4`` on gradients,
``atol=1e-6`` on parameters and float32 moments after a step.
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
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.launch import serve_lm as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO

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


def configs(arch):
    """(reference, port) smoke configs of ``arch``."""
    if arch == "local":
        local = dict(layer_pattern=("attn", "local_attn"))
        return tuple(dataclasses.replace(smoke(dataclasses.replace(
            get("lm-100m"), **local)), n_kv_heads=2)
            for smoke, get in ((j_smoke, j_get), (smoke_config, get_config)))
    return j_smoke(j_get(arch)), smoke_config(get_config(arch))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(rng, jcfg, b, s):
    """tokens/labels/mask as numpy: labels the next token, a ``-1``
    sentinel at position 5 (masked), the last position and a few more
    masked."""
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, 5] = -1
    mask = np.ones((b, s), np.float32)
    mask[:, [5, -1]] = 0.0
    mask[-1, 10:14] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask}


def _params(jcfg, rng):
    """A param tree of the reference's shapes (``jax.eval_shape`` of its
    init) drawn with numpy: the embedding and unembedding 0.02 N(0, 1),
    norm scales 1 + 0.2 N(0, 1), QKV biases 0.2 N(0, 1), every other
    weight N(0, 1) / sqrt(d_model)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(jcfg, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "'embed'" in name or "'unembed'" in name:
            z = 0.02 * z
        elif "'scale'" in name:
            z = 1 + 0.2 * z
        elif any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            z = 0.2 * z
        else:
            z = z / np.float32(np.sqrt(jcfg.d_model))
        return jnp.asarray(z)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module", params=["lm-100m", "qwen1.5-110b", "local"])
def ref(request):
    """The reference's parameters, a batch, and its loss and gradients."""
    jcfg, tcfg = configs(request.param)
    rng = np.random.default_rng(0)
    params = _params(jcfg, rng)
    batch = _batch(rng, jcfg, 2, SEQ)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(
        lambda p: JM.train_forward(p, jb, jcfg))(params)
    return {"cfg": tcfg, "params": _np(params),
            "fwd": dict(batch=batch, loss=float(loss), grads=_np(grads))}


def _lm(ref):
    return convert.lm_params_from_arrays(
        ref["cfg"], ref["params"], device="cpu").requires_grad_()


def _close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def test_train_forward_loss_and_every_gradient_match_reference(ref):
    cfg = ref["cfg"]
    lm = _lm(ref)
    batch = {k: torch.from_numpy(v) for k, v in ref["fwd"]["batch"].items()}
    loss = TM.train_forward(lm, batch, cfg)
    _close(loss, ref["fwd"]["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(cfg, ref["fwd"]["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)


def test_remat_on_equals_remat_off(ref):
    batch = {k: torch.from_numpy(v) for k, v in ref["fwd"]["batch"].items()}
    grads = []
    for remat in (True, False):
        lm = _lm(ref)
        loss = TM.train_forward(lm, batch, ref["cfg"], remat=remat)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in
                                      lm.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    for name, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][name]), name


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("arch", ["lm-100m", "local"])
def test_apply_updates_matches_reference(arch, quant):
    """float32 moments: a step from zero state on gradients that engage
    the clip. int8 moments: a first step, then the compared one, on
    gradients small enough that the clip factor is exactly 1."""
    jcfg, cfg = configs(arch)
    rng = np.random.default_rng(1)
    params = _params(jcfg, rng)

    def rand_tree(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            scale * rng.standard_normal(p.shape).astype(np.float32)),
            params)

    j_cfg = JO.OptConfig(quantize_moments=quant, **OPT)
    p1, st1 = params, JO.init_opt_state(params, j_cfg)
    if quant:
        p1, st1, _ = JO.apply_updates(p1, rand_tree(1e-3), st1, j_cfg)
    g = rand_tree(1e-3 if quant else 1.0)
    p2, st2, want_m = JO.apply_updates(p1, g, st1, j_cfg)
    p1, st1, p2, st2 = _np(p1), _np(st1), _np(p2), _np(st2)

    opt_cfg = TO.OptConfig(quantize_moments=quant, **OPT)
    lm = convert.lm_params_from_arrays(cfg, p1, device="cpu")
    state = convert.opt_state_from_arrays(cfg, st1, device="cpu")
    grads = {n: torch.from_numpy(np.array(a)) for n, a in
             convert.lm_arrays_by_name(cfg, _np(g)).items()}
    _, new, metrics = TO.apply_updates(lm, grads, state, opt_cfg,
                                       stacked=TM.scanned_params(lm))
    assert int(new["step"]) == int(st2["step"]) == 1 + quant
    _close(metrics["grad_norm"], want_m["grad_norm"], 0, 1e-6)
    _close(metrics["lr"], want_m["lr"], 0, 0)
    assert (float(metrics["grad_norm"]) > opt_cfg.grad_clip) == (not quant)
    want_p = convert.lm_arrays_by_name(cfg, p2)
    for name, p in lm.named_parameters():
        _close(p, want_p[name], 1e-6)
    for mom in ("m", "v"):
        wm = convert.lm_arrays_by_name(cfg, st2[mom])
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


def test_train_cli_default_arch_trains_lm_100m_on_cpu(capsys):
    """``launch/train.py --smoke --device cpu --steps 2`` with no
    ``--arch``: the smoke ``lm-100m`` trains two steps."""
    train_cli.main(["--smoke", "--device", "cpu", "--steps", "2"])
    out = capsys.readouterr().out
    assert "arch=lm-100m-smoke" in out and out.strip().endswith("done")
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_lm_cli_default_arch_serves_lm_100m_on_cpu(capsys):
    """``launch/serve_lm.py --smoke --device cpu`` with no ``--arch``: the
    smoke ``lm-100m`` generates at the launcher's defaults."""
    serve_cli.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=lm-100m-smoke on cpu generated (4, 32) tokens" in out
