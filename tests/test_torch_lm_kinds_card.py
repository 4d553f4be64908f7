"""M-RoPE with the vision stub (``qwen2-vl-7b``), Multi-head Latent
Attention (``minicpm3-4b``), the MoE feed-forward (``grok-1-314b``),
DeepSeek-V3's routed experts with the multi-token head
(``deepseek-v3-671b``), RG-LRU with local attention
(``recurrentgemma-2b``) and the Whisper encoder-decoder (``whisper-tiny``)
on the card against the CPU path, at smoke size, from one set of weights
(drawn on the CPU and moved). The CPU path is the one
``tests/test_torch_mrope.py``, ``tests/test_torch_mla.py``,
``tests/test_torch_moe.py``, ``tests/test_torch_mtp.py``,
``tests/test_torch_rglru.py`` and ``tests/test_torch_whisper.py`` hold
against the JAX reference; this file imports no JAX.

Each test needs a CUDA device (``cuda`` marker) and skips without one.
Tolerances: ``atol=rtol=1e-4`` on logits card against CPU (float32,
PyTorch's default of no TF32 in matmuls: ``chip_smoke.py``'s
``LM_CPU_TOL``), ``atol=rtol=2e-3`` on decode against the parallel
forward, and a train step's loss within ``rtol=1e-5`` and parameters
within ``atol=2e-3`` of the CPU's (the CPU tests' tolerances against the
reference's step).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import get_config
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.serve_step import make_prefill_step
from repro_torch.train.train_step import make_train_step

CPU_TOL = 1e-4
PARALLEL_TOL = STEP_ATOL = 2e-3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().cpu().numpy(), atol=tol,
                               rtol=tol)


def _models(arch):
    cfg = smoke_config(get_config(arch))
    cpu = M.init_params(cfg, 0, device="cpu")
    return cfg, cpu, M.init_params(cfg, 0, device="cpu").to("cuda")


def _recurring(lm):
    """``lm`` with every RG-LRU ``lam`` negated, so that its layers recur
    (``a_t`` about 0.9-0.9995; the initial ``lam`` gives below 3e-8)."""
    with torch.no_grad():
        for blk in lm.blocks:
            if isinstance(blk.mixer, L.RGLRU):
                blk.mixer.lam.neg_()
    return lm


def _train_step_on_both(cfg, batch, prepare=lambda lm: lm):
    opt = OptConfig(lr=1e-2, warmup_steps=1)
    out = {}
    for dev in ("cpu", "cuda"):
        lm = prepare(M.init_params(cfg, 0, device="cpu",
                                   requires_grad=True)).to(dev)
        lm, _, m = make_train_step(cfg, opt)(
            lm, init_opt_state(lm, opt),
            {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (m["loss"].cpu(), dict(lm.named_parameters()))
    _close(out["cuda"][0], out["cpu"][0], 1e-5)
    for name, p in out["cpu"][1].items():
        _close(out["cuda"][1][name], p, STEP_ATOL)


@pytest.mark.cuda
def test_mla_on_card_matches_cpu():
    """Smoke ``minicpm3-4b``: logits, the absorbed decode against the
    parallel forward on the card, a decode step's cache against the
    CPU's, and one train step of 2 microbatches."""
    _card()
    cfg, cpu, card = _models("minicpm3-4b")
    toks = torch.randint(0, cfg.vocab, (2, 13), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    want = M.forward_logits(cpu, toks, cfg)
    got = M.forward_logits(card, toks.cuda(), cfg)
    _close(got, want, CPU_TOL)
    cache = M.init_decode_cache(cfg, 2, 14, torch.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(card, cache, toks[:, i:i + 1].cuda(),
                                      cfg)
        steps.append(logits)
    _close(torch.cat(steps, 1), got, PARALLEL_TOL)
    cpu_cache = M.init_decode_cache(cfg, 2, 14, torch.float32, device="cpu")
    for i in range(toks.shape[1]):
        _, cpu_cache = M.decode_step(cpu, cpu_cache, toks[:, i:i + 1], cfg)
    for c, w in zip(cache, cpu_cache):
        assert c["length"] == w["length"] == toks.shape[1]
        _close(c["latent"], w["latent"], CPU_TOL)
        _close(c["k_rope"], w["k_rope"], CPU_TOL)
    batch = make_batch(cfg, 4, 37, torch.Generator().manual_seed(1),
                       device="cpu")
    _train_step_on_both(cfg, {k: v.reshape((2, 2) + v.shape[1:])
                              for k, v in batch.items()})


@pytest.mark.cuda
def test_vlm_on_card_matches_cpu():
    """Smoke ``qwen2-vl-7b``: the prefill step with ``pos3`` and
    ``vision_embeds``, decode with explicit ``pos3`` against the card's
    own parallel forward at those positions, ``apply_mrope`` at hd 128,
    and one train step of 2 microbatches of vision batches."""
    _card()
    cfg, cpu, card = _models("qwen2-vl-7b")
    batch = make_batch(cfg, 2, 21, torch.Generator().manual_seed(0),
                       device="cpu")
    prefill = make_prefill_step(cfg)
    _close(prefill(card, {k: v.cuda() for k, v in batch.items()}),
           prefill(cpu, batch), CPU_TOL)
    toks, pos3 = batch["tokens"].cuda(), batch["pos3"].cuda()
    with torch.no_grad():
        x = M._run_layers(card, card.embed[toks], cfg, pos=pos3)
        want = M._logits(M._norm(x, card.final_norm, cfg.norm_eps),
                         card.unembedding())
    cache = M.init_decode_cache(cfg, 2, 22, torch.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(card, cache, toks[:, i:i + 1], cfg,
                                      pos=pos3[:, i:i + 1])
        steps.append(logits)
    _close(torch.cat(steps, 1), want, PARALLEL_TOL)
    x = torch.randn((2, 7, 3, 128),
                    generator=torch.Generator().manual_seed(2))
    p3 = torch.randint(0, 4096, (2, 7, 3),
                       generator=torch.Generator().manual_seed(3))
    sec = L.mrope_sections(128)
    _close(L.apply_mrope(x.cuda(), p3.cuda(), 1e6, sec),
           L.apply_mrope(x, p3, 1e6, sec), CPU_TOL)
    batch = make_batch(cfg, 4, 21, torch.Generator().manual_seed(1),
                       device="cpu")
    _train_step_on_both(cfg, {k: v.reshape((2, 2) + v.shape[1:])
                              for k, v in batch.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_moe_on_card_matches_cpu(arch):
    """Smoke ``grok-1-314b`` and ``deepseek-v3-671b`` (dropless, capacity
    factor 8): logits, the routing of the first MoE layer's input (expert
    ids, ranks, keep mask) equal to the CPU's, ``moe_fwd`` against
    ``moe_fwd_plain`` on the card, decode against the parallel forward on
    the card, and one train step of 2 microbatches (the multi-token head's
    term in deepseek's loss)."""
    _card()
    cfg, cpu, card = _models(arch)
    toks = torch.randint(0, cfg.vocab, (2, 13), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    want = M.forward_logits(cpu, toks, cfg)
    got = M.forward_logits(card, toks.cuda(), cfg)
    _close(got, want, CPU_TOL)
    li = cfg.dense_prefix
    x = torch.randn((2, 13, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        r_cpu = L.moe_route(cpu.blocks[li].ffn, x.reshape(26, -1), cfg)
        r_card = L.moe_route(card.blocks[li].ffn, x.reshape(26, -1).cuda(),
                             cfg)
        for name in ("experts", "order", "rank", "keep", "slot"):
            assert torch.equal(getattr(r_card, name).cpu(),
                               getattr(r_cpu, name)), name
        _close(L.moe_fwd(card.blocks[li].ffn, x.cuda(), cfg),
               L.moe_fwd_plain(card.blocks[li].ffn, x.cuda(), cfg), CPU_TOL)
    cache = M.init_decode_cache(cfg, 2, 14, torch.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(card, cache, toks[:, i:i + 1].cuda(),
                                      cfg)
        steps.append(logits)
    _close(torch.cat(steps, 1), got, PARALLEL_TOL)
    batch = make_batch(cfg, 4, 37, torch.Generator().manual_seed(1),
                       device="cpu")
    _train_step_on_both(cfg, {k: v.reshape((2, 2) + v.shape[1:])
                              for k, v in batch.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("lam", ["init", "recur"])
def test_rglru_on_card_matches_cpu(lam):
    """Smoke ``recurrentgemma-2b`` with its initial ``lam`` and with one
    that recurs: logits, token-by-token decode on the card against the
    card's parallel forward past the window of 8 (the ring buffers wrap),
    the decode's ``h`` against the CPU's, and one train step of 2
    microbatches."""
    _card()
    prepare = _recurring if lam == "recur" else (lambda lm: lm)
    cfg, cpu, card = _models("recurrentgemma-2b")
    cpu, card = prepare(cpu), prepare(card)
    toks = torch.randint(0, cfg.vocab, (2, 13), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    want = M.forward_logits(cpu, toks, cfg)
    got = M.forward_logits(card, toks.cuda(), cfg)
    _close(got, want, CPU_TOL)
    cache = M.init_decode_cache(cfg, 2, 14, torch.float32)
    cpu_cache = M.init_decode_cache(cfg, 2, 14, torch.float32, device="cpu")
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = M.decode_step(card, cache, toks[:, i:i + 1].cuda(),
                                      cfg)
        _, cpu_cache = M.decode_step(cpu, cpu_cache, toks[:, i:i + 1], cfg)
        steps.append(logits)
    _close(torch.cat(steps, 1), got, PARALLEL_TOL)
    for kind, c, w in zip(cfg.layer_kinds, cache, cpu_cache):
        if kind == "rglru":
            _close(c["h"], w["h"], CPU_TOL)
    batch = make_batch(cfg, 4, 37, torch.Generator().manual_seed(1),
                       device="cpu")
    _train_step_on_both(cfg, {k: v.reshape((2, 2) + v.shape[1:])
                              for k, v in batch.items()}, prepare)


def _whisper_parallel(lm, cfg, tokens, enc_in):
    """The parallel decoder's logits of ``tokens`` over the encoder's
    output."""
    memory = M.encoder_fwd(lm, enc_in, cfg)
    x = lm.embed[tokens] + lm.dec_pos[None, :tokens.shape[1]]
    x, _ = M._dec_layers_with_cross(lm, x, memory, cfg, pos=None)
    return M._logits(L.layernorm(x, lm.final_norm, cfg.norm_eps),
                     lm.unembedding())


def _whisper_cached(lm, cfg, tokens, enc_in):
    """The cached cross decode, one token a step, composed from the
    reference's pieces: the encoder and the cross keys and values once,
    then ``dec_pos[length]`` and ``_dec_layers_with_cross`` with both
    caches per token."""
    memory = M.encoder_fwd(lm, enc_in, cfg)
    kv = [M._cross_kv(c.attn, memory, cfg) for c in lm.cross]
    caches = M.init_decode_cache(cfg, tokens.shape[0], tokens.shape[1] + 1,
                                 torch.float32, device=tokens.device)
    out = []
    for i in range(tokens.shape[1]):
        n = caches[0]["length"]
        x = lm.embed[tokens[:, i:i + 1]] + lm.dec_pos[None, n:n + 1]
        x, caches = M._dec_layers_with_cross(lm, x, None, cfg, pos=None,
                                             self_caches=caches, cross_kv=kv)
        out.append(M._logits(L.layernorm(x, lm.final_norm, cfg.norm_eps),
                             lm.unembedding()))
    return torch.cat(out, 1)


@pytest.mark.cuda
def test_whisper_on_card_matches_cpu():
    """Smoke ``whisper-tiny``: the ``train_forward`` loss, the parallel
    decoder's logits against the CPU's, the cached cross decode on the
    card against the card's parallel decoder, and one train step of 2
    microbatches of batches with ``enc_input``."""
    _card()
    cfg, cpu, card = _models("whisper-tiny")
    batch = make_batch(cfg, 2, 13, torch.Generator().manual_seed(0),
                       device="cpu")
    with torch.no_grad():
        want = M.train_forward(cpu, batch, cfg)
        got = M.train_forward(card, {k: v.cuda() for k, v in batch.items()},
                              cfg)
        _close(got, want, CPU_TOL)
        toks, enc = batch["tokens"], batch["enc_input"]
        par = _whisper_parallel(card, cfg, toks.cuda(), enc.cuda())
        _close(par, _whisper_parallel(cpu, cfg, toks, enc), CPU_TOL)
        _close(_whisper_cached(card, cfg, toks.cuda(), enc.cuda()), par,
               PARALLEL_TOL)
    batch = make_batch(cfg, 4, 37, torch.Generator().manual_seed(1),
                       device="cpu")
    _train_step_on_both(cfg, {k: v.reshape((2, 2) + v.shape[1:])
                              for k, v in batch.items()})
