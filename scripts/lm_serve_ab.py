#!/usr/bin/env python3
"""Time the port's RWKV-6 serving path of two checkouts of this repository
on one CUDA card, in turns.

    python3 scripts/lm_serve_ab.py OLD_TREE NEW_TREE

Each tree is a checkout, for example an older commit unpacked with
``git archive`` into a git-ignored directory. For the trees in the order
old, new, new, old, a fresh process puts the tree's ``src`` first on its
path, builds that tree's ``rwkv_scan`` kernel and serves full-width,
full-depth ``rwkv6-7b`` with float32 weights from seed 0, at the shapes
of ``chip_smoke.py`` (this checkout's) phase ``lm_serve``: the prefill
step on 4 x 2048 tokens (CUDA events, median of 3 after a warm-up),
``greedy_generate`` at ``serve_lm``'s defaults (median of 3 after a
warm-up), and single ``decode_step`` calls on a live cache (median of
16). The prefill logits and the generated tokens of all runs must agree,
so both trees compute the same results. Prints one JSON line a run, then
a summary line (the card's name and power limit included). Needs one
card; exits non-zero without one.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(tree: str) -> int:
    src = Path(tree).resolve() / "src"
    sys.path[:0] = [str(src), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("lm_serve_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.models import model as M
    from repro_torch.models.config import get_config
    from repro_torch.train.serve_step import (greedy_generate,
                                              make_decode_step,
                                              make_prefill_step)
    if src not in Path(M.__file__).resolve().parents:
        raise RuntimeError(f"imported {M.__file__}, not {src}")
    build.build(["rwkv_scan"])
    cfg = get_config(cs.LM_ARCH)
    params = M.init_params(cfg, cs.LM_SEED, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(cs.LM_SEED)
    b, s = cs.LM_PREFILL
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                           device="cuda", dtype=torch.int32)
    prompts = torch.randint(0, cfg.vocab, (cs.LM_REQUESTS, cs.LM_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    cache_len = cs.LM_PROMPT + cs.LM_MAX_NEW + 1
    logits = prefill(params, {"tokens": tokens})
    prefill_ms = cs.cuda_time_ms(lambda: prefill(params, {"tokens": tokens}),
                                 3, warmup=0)
    out = {}
    generate_ms = cs.cuda_time_ms(lambda: out.update(tok=greedy_generate(
        params, cfg, prompts, cs.LM_MAX_NEW, cache_len)), 3)
    cache = M.init_decode_cache(cfg, cs.LM_REQUESTS, cache_len,
                                torch.float32)
    tok, lat = prompts[:, :1], []
    for _ in range(cs.LM_TIMED_TOKENS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step_logits, cache = decode(params, cache, tok)
        end.record()
        end.synchronize()
        lat.append(start.elapsed_time(end))
        tok = torch.argmax(step_logits[:, -1], dim=-1)[:, None].to(
            torch.int32)
    n_tok = cs.LM_REQUESTS * cs.LM_MAX_NEW
    print(json.dumps({
        "tree": tree, "prefill_ms": prefill_ms, "generate_ms": generate_ms,
        "tokens_per_s": n_tok / generate_ms * 1e3,
        "decode_step_median_ms": sorted(lat)[len(lat) // 2],
        "decode_step_ms": lat,
        "digest": _digest(logits, out["tok"])}), flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        return worker(sys.argv[2])
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = sys.argv[1:]
    runs = []
    for role, tree in (("old", old), ("new", new), ("new", new),
                       ("old", old)):
        proc = subprocess.run([sys.executable, __file__, "--worker", tree],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        run = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                   role=role)
        runs.append(run)
        print(json.dumps(run), flush=True)
    if len({r["digest"] for r in runs}) != 1:
        print("lm_serve_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    summary = {"nvidia_smi": smi, "order": [r["role"] for r in runs],
               "outputs_equal": True}
    for name in ("prefill_ms", "generate_ms", "tokens_per_s",
                 "decode_step_median_ms"):
        summary[name] = {role: [r[name] for r in runs if r["role"] == role]
                         for role in ("old", "new")}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
