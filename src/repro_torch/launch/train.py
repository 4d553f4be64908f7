"""End-to-end training launcher, on the card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch lm-100m \
      --steps 50 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt

Port of ``src/repro/launch/train.py`` with its flags and defaults
(``--arch lm-100m``, an attention model), plus ``--device`` (default
``cuda``; it raises without a card, and the CPU runs only with
``--device cpu``, e.g. ``--smoke --device cpu``); ``--arch rwkv6-7b``
trains RWKV-6, ``--arch recurrentgemma-2b`` RG-LRU with local attention,
``--arch whisper-tiny`` the encoder-decoder (the synthetic batches carry
``enc_input``), ``--arch minicpm3-4b`` Multi-head Latent Attention and
``--arch qwen2-vl-7b`` M-RoPE with the vision stub (the synthetic batches
carry ``pos3`` and ``vision_embeds``), ``--arch grok-1-314b`` the MoE
feed-forward and ``--arch deepseek-v3-671b`` MLA, the MoE with a shared
expert and the aux-free router bias, and the multi-token head (both with
``--smoke``: the full configs do not fit on one card). Fault tolerance comes from ``ResilientLoop``
(checkpoint/restart + straggler monitor) when ``--ckpt-dir`` is given.
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config of --arch")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=10)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import smoke_config
    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.models.config import get_config
    from repro_torch.models.model import count_params, init_params
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import ResilientLoop
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    print(f"arch={cfg.name} params={count_params(cfg)/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} on {dev}")

    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(100, args.steps // 5
                                                     or 1))
    params = init_params(cfg, args.seed, device=dev, requires_grad=True)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)

    def stream_fn(start):
        def add_micro(b):
            return {k: a.reshape((args.n_micro, a.shape[0] // args.n_micro)
                                 + a.shape[1:]) for k, a in b.items()}
        it = synthetic_stream(cfg, args.batch, args.seq, start_step=start,
                              seed=args.seed, device=dev)
        return (add_micro(b) for b in it)

    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir)
        loop = ResilientLoop(ckpt, save_every=args.save_every)
        start = ckpt.latest_step() or 0
        if start:
            params, opt_state, _ = ckpt.restore(params, opt_state)
            print(f"resumed from step {start}")
        params, opt_state, log = loop.run(step_fn, params, opt_state,
                                          stream_fn, args.steps, start)
        for i, m in enumerate(log):
            if i % args.log_every == 0:
                print(f"step {start + i:5d} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f}")
    else:
        stream = stream_fn(0)
        t0 = time.perf_counter()
        for s in range(args.steps):
            batch = next(stream)
            params, opt_state, m = step_fn(params, opt_state, batch)
            if s % args.log_every == 0:
                loss, gnorm = (float(v) for v in torch.stack(
                    [m["loss"], m["grad_norm"]]).cpu())
                dt = time.perf_counter() - t0
                tok = args.batch * args.seq
                print(f"step {s:5d} loss={loss:.4f} gnorm={gnorm:.3f} "
                      f"({tok / max(dt, 1e-9):.0f} tok/s)")
                t0 = time.perf_counter()
    print("done")


if __name__ == "__main__":
    main()
