"""LM serving demo: batched greedy generation with a KV cache (or the
RWKV-6 recurrent cache), on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch lm-100m \
      --requests 4 --prompt-len 16 --max-new 32

Port of ``src/repro/launch/serve_lm.py`` with its flags and defaults
(``--arch lm-100m``), plus ``--device`` (default ``cuda``; it raises
without a card, and the CPU runs only with ``--device cpu``, e.g.
``--smoke --device cpu``). ``--arch rwkv6-7b`` serves RWKV-6,
``--arch recurrentgemma-2b`` RG-LRU with local attention (ring-buffer
caches of the window) and ``--arch minicpm3-4b`` Multi-head Latent
Attention (single-token steps through the absorbed decode); ``--arch grok-1-314b`` and ``--arch
deepseek-v3-671b`` the MoE feed-forward (with ``--smoke``: the full
configs take 1.27 TB and 2.68 TB of float32 weights, more than a card
holds). ``--arch qwen2-vl-7b`` exits non-zero with
a ``ValueError``, as the reference's launcher fails on it: the greedy
loop steps at the cache's length, and an M-RoPE model needs explicit
``pos3`` positions (``train/serve_step.make_decode_step`` takes them);
so does ``--arch whisper-tiny``, where the reference's loop runs the
decoder without its encoder: an encoder-decoder model is served by its
pieces (``models.model.encoder_fwd``, ``_dec_layers_with_cross``).
The first run is a warmup (it builds the ``rwkv_scan`` kernel where the
model runs it, and warms the libraries) and is reported apart; the
second is the steady state. On the card both are timed with CUDA events; on the CPU
with the host clock.
"""
from __future__ import annotations

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.configs import smoke_config
    from repro_torch.core.api import resolve_device
    from repro_torch.models.config import get_config
    from repro_torch.models.model import init_params
    from repro_torch.train.serve_step import greedy_generate

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    params = init_params(cfg, args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, (args.requests, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    cache_len = args.prompt_len + args.max_new + 1
    n_tok = args.requests * args.max_new
    metrics = obs.metric_set("serve_lm")
    on_card = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"

    def run(name):
        """One generation in a span; its seconds by CUDA events on the
        card, by the span's host clock on the CPU."""
        with obs.span(name, arch=cfg.name, device=where) as sp:
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            out = greedy_generate(params, cfg, prompts, args.max_new,
                                  cache_len)
            if on_card:
                end.record()
                end.synchronize()
        secs = start.elapsed_time(end) / 1e3 if on_card else sp.duration
        return out, secs

    # warmup: builds the kernel and warms the libraries; the second
    # identical call is the steady-state serving throughput
    out, warm_s = run("warmup")
    out, gen_s = run("generate")
    metrics.observe("warmup_s", warm_s)
    metrics.observe("generate_s", gen_s)
    metrics.count("tokens", 2 * n_tok)
    print(f"arch={cfg.name} on {where} generated {tuple(out.shape)} tokens: "
          f"{n_tok / gen_s:.1f} tok/s steady-state, "
          f"{n_tok / warm_s:.1f} tok/s incl. warmup "
          f"(warmup {warm_s:.2f}s)")
    print(out[:, :16].cpu())
    if obs.trace_enabled():
        print(obs.summary())


if __name__ == "__main__":
    main()
