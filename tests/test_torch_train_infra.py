"""The port's training infrastructure, on its own (no JAX): the
reference's ``tests/test_train_infra.py`` ported to the smoke
``rwkv6-7b`` (the reference's tests use an attention config, not ported
yet), plus what the port adds: the batch fields of every family,
``ResilientLoop`` resuming to the uninterrupted run's parameters,
checkpoints holding int8 moments, the training command line, and on the
card the chunked core's gradients and a train step against the CPU's.

Tolerances: the reference's where a test is ported (loss within 0.8 of
the first after 15 steps on one batch; int8 round trip within half a
step; quantized Adam within 0.15 of float32 Adam's loss after 5 steps;
an update under 0.2 with the clip engaged; resumed losses ``rtol=1e-6``).
A resumed run on the CPU equals the uninterrupted one exactly (the same
operations in the same order on the same values). On the card against
the CPU: the chunked core's output and gradients within ``1e-4 x max(1,
max|CPU|)``, and a train step's loss ``rtol=1e-5`` and parameters
``atol=2e-3`` (the step tests' tolerance).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import (batch_specs, make_batch,
                                       synthetic_stream)
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import get_config
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (ResilientLoop,
                                               StragglerMonitor,
                                               fetch_metrics)
from repro_torch.train.optimizer import (OptConfig, _qdecode, _qdecode_sqrt,
                                         _qencode, _qencode_sqrt,
                                         apply_updates, init_opt_state)
from repro_torch.train.train_step import make_eval_step, make_train_step

CFG = smoke_config(get_config("rwkv6-7b"))
OPT = OptConfig(lr=1e-2, warmup_steps=1)
CARD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(opt_cfg=OPT, device="cpu"):
    params = M.init_params(CFG, 0, device=device, requires_grad=True)
    return params, init_opt_state(params, opt_cfg), make_train_step(
        CFG, opt_cfg)


def _batch(step=0, n_micro=1, b=4, s=16, device="cpu"):
    gen = torch.Generator(device).manual_seed(1000 + step)
    batch = make_batch(CFG, b, s, gen, device=device)
    return {k: v.reshape((n_micro, b // n_micro) + v.shape[1:])
            for k, v in batch.items()}


def _state(params) -> dict:
    return {k: v.detach().clone() for k, v in params.state_dict().items()}


def _losses(log):
    return [m["loss"] for m in log]


def test_loss_decreases():
    params, opt, step = _setup()
    losses = []
    batch = _batch()
    for _ in range(15):
        params, opt, m = step(params, opt, batch)  # overfit one batch
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8, losses


def test_eval_step_is_the_loss_without_autograd():
    params, opt, step = _setup()
    batch = _batch()
    loss = make_eval_step(CFG)(params, batch)
    assert loss.grad_fn is None
    _, _, m = step(params, opt, batch)
    np.testing.assert_allclose(float(loss), float(m["loss"]), rtol=1e-5)


def test_serving_a_trainable_model_builds_no_graph():
    """The serving steps run without autograd, so a model being trained
    serves through ``rwkv_scan`` with the tokens of the same weights
    without gradients."""
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_prefill_step)
    params, opt, step = _setup()
    params, _, _ = step(params, opt, _batch())
    frozen = M.init_params(CFG, 0, device="cpu")
    frozen.load_state_dict(params.state_dict())
    prompt = _batch(step=1)["tokens"][0]
    got = make_prefill_step(CFG)(params, {"tokens": prompt})
    assert got.grad_fn is None
    assert torch.equal(got, make_prefill_step(CFG)(frozen,
                                                   {"tokens": prompt}))
    assert torch.equal(greedy_generate(params, CFG, prompt, 4, 32),
                       greedy_generate(frozen, CFG, prompt, 4, 32))


def test_quantized_moments_roundtrip():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32) * 0.03)
    q = _qencode(x)
    y = _qdecode(q, x.shape)
    # absmax int8: error bounded by half a quantization step per block
    step = float(q["scale"].max())
    np.testing.assert_allclose(y.numpy(), x.numpy(), atol=0.51 * step + 1e-7)
    assert q["code"].dtype == torch.int8 and q["code"].shape == (1024,)
    assert q["scale"].shape == (4,)


def test_quantized_sqrt_moments_bounded():
    v = torch.from_numpy(np.abs(np.random.default_rng(0).standard_normal(
        1000)).astype(np.float32) * 1e-4)
    v[::7] = 1e-12                # tiny second moments inside the block
    q = _qencode_sqrt(v)
    y = _qdecode_sqrt(q, v.shape)
    # decode floor: no zero-collapse (the update-explosion guard)
    assert float(y.min()) > 0
    big = v > 1e-6
    np.testing.assert_allclose(y[big].numpy(), v[big].numpy(), rtol=0.2)


def test_quantized_codes_keep_the_parameter_shape():
    for shape in [(), (5,), (3, 300), (2, 4, 256)]:
        x = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        q = _qencode(x)
        last = shape[-1] if shape else 1
        assert q["code"].shape == (*shape[:-1], -(-last // 256) * 256)
        assert q["scale"].shape == (*shape[:-1], -(-last // 256))
        assert _qdecode(q, shape).shape == shape


def test_quantized_adam_tracks_fp32():
    cfg_q = OptConfig(lr=1e-2, warmup_steps=1, quantize_moments=True)
    pf, of, step_f = _setup()
    qf, oq, step_q = _setup(cfg_q)
    b = _batch()
    for _ in range(5):
        pf, of, mf = step_f(pf, of, b)
        qf, oq, mq = step_q(qf, oq, b)
    assert abs(float(mf["loss"]) - float(mq["loss"])) < 0.15
    assert oq["m"]["embed"]["code"].dtype == torch.int8


def test_grad_clip_engages():
    params, opt, _ = _setup()
    before = _state(params)
    big = {n: torch.ones_like(p) * 1e3 for n, p in params.named_parameters()}
    _, _, m = apply_updates(params, big, opt,
                            OptConfig(lr=1e-2, grad_clip=1.0,
                                      warmup_steps=1))
    assert float(m["grad_norm"]) > 1.0
    # update magnitude bounded by lr * (1 + wd-ish): clip engaged
    delta = max(float((p.detach() - before[n]).abs().max())
                for n, p in params.named_parameters())
    assert delta < 0.2


@pytest.mark.parametrize("quantize", [False, True])
def test_checkpoint_roundtrip_and_retention(tmp_path, quantize):
    cfg = OptConfig(lr=1e-2, warmup_steps=1, quantize_moments=quantize)
    params, opt, step = _setup(cfg)
    params, opt, _ = step(params, opt, _batch())
    saved = _state(params)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30):
        mgr.save(s, params, opt, extra={"cursor": s})
    assert mgr.all_steps() == [20, 30]   # retention pruned step 10
    assert mgr.latest_step() == 30
    fresh, opt0, _ = _setup(cfg)
    p2, o2, man = mgr.restore(fresh, opt0)
    assert man == {"step": 30, "cursor": 30} and p2 is fresh
    for k, v in p2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    assert all(p.requires_grad for p in p2.parameters())
    assert int(o2["step"]) == int(opt["step"]) == 1
    for mom in ("m", "v"):
        for name, want in opt[mom].items():
            got = o2[mom][name]
            pairs = (zip(got.values(), want.values()) if quantize
                     else [(got, want)])
            for g, w in pairs:
                assert g.dtype == w.dtype and torch.equal(g, w), name


def test_resume_determinism(tmp_path):
    """train 6 straight == train 3, checkpoint, restore, train 3."""
    pa, oa, step = _setup()
    for s in range(6):
        pa, oa, ma = step(pa, oa, _batch(step=s))

    pb, ob, _ = _setup()
    for s in range(3):
        pb, ob, _ = step(pb, ob, _batch(step=s))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, pb, ob)
    pc, oc, _ = mgr.restore(*_setup()[:2])
    for s in range(3, 6):
        pc, oc, mc = step(pc, oc, _batch(step=s))
    np.testing.assert_allclose(float(ma["loss"]), float(mc["loss"]),
                               rtol=1e-6)


def _flaky(step, fail_at):
    calls = {"n": 0}

    def flaky_step(p, o, b):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("injected node failure")
        return step(p, o, b)

    return flaky_step


def _stream_fn(start):
    return (_batch(step=s) for s in range(start, 10_000))


def test_resilient_loop_recovers_from_failure(tmp_path):
    """A failure after the step-6 checkpoint: the loop restores it and
    reaches step 10 with the parameters, moments and losses of the run
    that did not fail."""
    params, opt, step = _setup()
    loop = ResilientLoop(CheckpointManager(str(tmp_path / "a")),
                         save_every=100)
    want_p, want_o, want_log = loop.run(step, params, opt, _stream_fn,
                                        n_steps=10)
    params, opt, step = _setup()
    loop = ResilientLoop(CheckpointManager(str(tmp_path / "b")),
                         save_every=2, max_restarts=2)
    p, o, log = loop.run(_flaky(step, 7), params, opt, _stream_fn,
                         n_steps=10)
    assert loop.restarts == 1
    assert len(log) == 10          # all 10 steps eventually completed
    assert loop.ckpt.latest_step() == 10
    assert _losses(log) == _losses(want_log)
    assert set(log[0]) == {"loss", "grad_norm", "lr"}
    for k, v in p.state_dict().items():
        assert torch.equal(v, want_p.state_dict()[k]), k
    assert int(o["step"]) == 10
    for name, m in o["m"].items():
        assert torch.equal(m, want_o["m"][name]), name


def test_resilient_loop_replays_from_an_older_checkpoint(tmp_path):
    """A failure two steps past the last checkpoint replays those steps:
    the log holds them twice, the final state is the uninterrupted one."""
    params, opt, step = _setup()
    loop = ResilientLoop(CheckpointManager(str(tmp_path / "a")),
                         save_every=100)
    want_p, _, want_log = loop.run(step, params, opt, _stream_fn, n_steps=6)
    params, opt, step = _setup()
    loop = ResilientLoop(CheckpointManager(str(tmp_path / "b")),
                         save_every=3)
    p, _, log = loop.run(_flaky(step, 6), params, opt, _stream_fn,
                         n_steps=6)
    assert loop.restarts == 1
    assert _losses(log) == (_losses(want_log)[:5] + _losses(want_log)[3:])
    for k, v in p.state_dict().items():
        assert torch.equal(v, want_p.state_dict()[k]), k


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    params, opt, step = _setup()

    def broken(p, o, b):
        raise RuntimeError("injected node failure")

    loop = ResilientLoop(CheckpointManager(str(tmp_path)), max_restarts=2)
    with pytest.raises(RuntimeError, match="injected"):
        loop.run(broken, params, opt, _stream_fn, n_steps=3)
    assert loop.restarts == 3


def test_fetch_metrics_is_one_transfer():
    m = {"loss": torch.tensor(2.5), "grad_norm": torch.tensor(0.5),
         "lr": torch.tensor(1e-3)}
    assert fetch_metrics(m) == {"loss": 2.5, "grad_norm": 0.5,
                                "lr": float(torch.tensor(1e-3))}


def test_straggler_monitor():
    mon = StragglerMonitor(factor=3.0)
    for _ in range(10):
        assert not mon.observe(0.1)
    assert mon.observe(1.0)        # 10x the EMA -> flagged
    assert mon.flagged == 1
    assert not mon.observe(0.1)    # EMA not polluted by the straggler


def test_stream_resumable():
    a = list(zip(range(5), synthetic_stream(CFG, 2, 8, device="cpu")))
    b = list(zip(range(3), synthetic_stream(CFG, 2, 8, start_step=2,
                                            device="cpu")))
    for (_, x), (_, y) in zip(a[2:], b):
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert not torch.equal(a[0][1]["tokens"], a[1][1]["tokens"])
    c = next(synthetic_stream(CFG, 2, 8, seed=1, device="cpu"))
    assert not torch.equal(c["tokens"], a[0][1]["tokens"])


@pytest.mark.parametrize("family", ["ssm", "vlm", "audio"])
def test_batch_fields_of_every_family(family):
    cfg = {"ssm": CFG,
           "vlm": dataclasses.replace(CFG, pos="mrope",
                                      frontend="vision_stub",
                                      n_vision_tokens=4),
           "audio": dataclasses.replace(CFG, enc_dec=True, enc_context=6,
                                        max_target_len=5)}[family]
    specs = batch_specs(cfg, 2, 8)
    batch = make_batch(cfg, 2, 8, torch.Generator().manual_seed(0),
                       device="cpu")
    assert set(specs) == set(batch)
    want = {"ssm": {"tokens", "labels", "mask"},
            "vlm": {"tokens", "labels", "mask", "pos3", "vision_embeds"},
            "audio": {"tokens", "labels", "mask", "enc_input"}}[family]
    assert set(batch) == want
    for k, spec in specs.items():
        assert spec.is_meta and spec.shape == batch[k].shape, k
        if k != "vision_embeds" and k != "enc_input":
            assert spec.dtype == batch[k].dtype, k
    toks = batch["tokens"]
    assert torch.equal(batch["labels"], torch.roll(toks, -1, dims=1))
    assert bool((toks >= 0).all() and (toks < cfg.vocab).all())
    assert bool((batch["mask"][:, -1] == 0).all())
    if family == "vlm":
        assert bool((batch["mask"][:, :4] == 0).all())
        assert batch["pos3"][0, 3].tolist() == [0, 1, 1]
        assert batch["pos3"][0, 6].tolist() == [6, 6, 6]
    if family == "audio":
        assert toks.shape == (2, 5)


def test_train_cli_smoke_on_cpu(tmp_path, capsys):
    """``launch/train.py --arch rwkv6-7b --smoke --device cpu`` without and
    with ``--ckpt-dir`` (which then resumes from its last checkpoint)."""
    args = ["--arch", "rwkv6-7b", "--smoke", "--device", "cpu", "--batch",
            "4", "--seq", "16", "--n-micro", "2"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--save-every", "2"]

    def losses(out):
        return [ln.split("loss=")[1].split()[0] for ln in out.splitlines()
                if "loss=" in ln]

    train_cli.main(args + ["--steps", "4"])
    plain = capsys.readouterr().out
    assert "arch=rwkv6-7b-smoke" in plain and plain.strip().endswith("done")
    assert len(losses(plain)) == 4
    train_cli.main(args + ["--steps", "4"] + ckpt)
    first = capsys.readouterr().out
    assert "resumed" not in first
    # the same losses as without checkpoints (same seed, same stream)
    assert losses(first) == losses(plain)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]
    train_cli.main(args + ["--steps", "6"] + ckpt)
    resumed = capsys.readouterr().out
    assert "resumed from step 4" in resumed and len(losses(resumed)) == 2
    assert "step     4 loss=" in resumed


def test_train_cli_default_arch_is_not_ported(monkeypatch):
    """The launcher's default ``--arch`` is the reference's ``lm-100m``,
    which trains since its attention layers were ported
    (``tests/test_torch_dense_train.py``). Every layer kind of the
    reference is ported now (RG-LRU in ``tests/test_torch_rglru.py``); an
    arch of a kind the reference does not have either raises through the
    launcher, as the reference's ``init_layer`` does."""
    from repro_torch.models import config as C
    other = dataclasses.replace(get_config("lm-100m"), name="kind-test",
                                layer_pattern=("mamba",))
    monkeypatch.setitem(C._REGISTRY, other.name, other)
    with pytest.raises(ValueError, match="unknown layer kind mamba"):
        train_cli.main(["--arch", other.name, "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close_scaled(got, want, tol, what):
    got, want = got.detach().cpu(), want.detach().cpu()
    err = float((got - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.cuda
def test_chunked_core_gradients_on_card_match_cpu():
    """The chunked core's output, final state and gradients on the card
    against the CPU's on the same inputs (S = 37, padded)."""
    _card()
    rng = np.random.default_rng(0)
    shape = (2, 37, 4, 16)
    r, k, v, x = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))
    w = np.exp(-np.clip(np.exp(x), 0, 5)).astype(np.float32)
    u = (0.1 * rng.standard_normal(shape[2:])).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((2, 4, 16, 16))).astype(np.float32)
    c_out = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    c_st = torch.from_numpy(
        rng.standard_normal(s0.shape).astype(np.float32))
    runs = {}
    for dev in ("cpu", "cuda"):
        ins = [torch.from_numpy(a).to(dev).requires_grad_()
               for a in (r, k, v, w, u, s0)]
        out, st = L.rwkv_chunked_core(*ins)
        ((out * c_out.to(dev)).sum() + (st * c_st.to(dev)).sum()).backward()
        runs[dev] = [out, st] + [t.grad for t in ins]
    names = ["out", "state", "dr", "dk", "dv", "dw", "du", "dstate0"]
    for name, got, want in zip(names, runs["cuda"], runs["cpu"]):
        assert got.device.type == "cuda"
        _close_scaled(got, want, CARD_TOL, name)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One train step of the smoke model (2 microbatches) on the card and
    on the CPU from the same weights and batch."""
    _card()
    batch = _batch(n_micro=2)
    out = {}
    for dev in ("cpu", "cuda"):
        params = M.init_params(CFG, 0, device="cpu",
                               requires_grad=True).to(dev)
        opt = init_opt_state(params, OPT)
        params, opt, m = make_train_step(CFG, OPT)(
            params, opt, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), _state(params))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for k, v in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][k].cpu().numpy(),
                                   v.numpy(), atol=2e-3, err_msg=k)
