"""Cost and memory analysis of a dry-run cell (the counterpart of the
reference's ``launch/hlo_analysis.py``, under its name so that a reader
finds it).

No HLO exists here: the port runs eagerly and compiles no program, so
nothing reports a compiled step's memory or its collectives. What the
reference read from XLA, the port counts:

  * bytes: :func:`sharded_bytes` (exact per-device bytes of a tree of
    tensors under its specs) and :func:`analytic_activation_bytes` (the
    reference's remat-aware activation model), the reference's arithmetic
    exactly;
  * FLOPs and bytes accessed: ``launch/dryrun.py`` counts them on the meta
    device (``FlopCounterMode``; :class:`OpBytes`);
  * collectives: :func:`count_collectives` runs a step on DTensors (on the
    meta device under a fake process group in the dry run) under
    ``CommDebugMode`` and :class:`CollectiveBytes`, which counts them by
    kind with each one's result bytes on this rank, the counterpart of
    the reference's ``collective_bytes`` (XLA's partitioner picks other
    collectives than DTensor does, so the two counts differ). Where a
    step cannot run on DTensors a cell records ``"collectives": null``
    with :data:`COLLECTIVES_NOT_COUNTED` and the operation that stopped
    it, and the roofline's dominant term is taken over the terms that
    exist.

Roofline constants are one NVIDIA H100 SXM5 80GB's, from NVIDIA's data
sheet (dense, no sparsity), the card that ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` reports as "NVIDIA
H100 80GB HBM3, 700.00 W": 989 TFLOP/s bf16, 3.35 TB/s HBM3, 450 GB/s a
direction over NVLink. A card set below 700 W runs slower.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..sharding.rules import mesh_shape

PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense, one H100 SXM5
HBM_BW = 3.35e12             # bytes/s, HBM3, one H100 SXM5
LINK_BW = 450e9              # bytes/s a direction, NVLink 4 (H100 SXM5)
HBM_BYTES = 80e9             # the data sheet's 80 GB
COLLECTIVES_NOT_COUNTED = "the step does not run on DTensors"


@dataclasses.dataclass
class RooflineTerms:
    """Seconds per step on one device; ``collective_s`` is None where
    collectives were not counted."""

    compute_s: float
    memory_s: float
    collective_s: float | None
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float | None
    model_flops: float            # 6*N*D (train) or 2*N*D per token (decode)
    useful_flops_ratio: float     # model_flops_per_device / counted flops

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max((k for k, v in terms.items() if v is not None),
                   key=terms.get)

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "dominant": self.dominant}


def roofline(cost: dict, coll: dict | None, *, chips: int,
             model_flops_global: float) -> RooflineTerms:
    """The roofline terms of a per-device ``cost`` (``"flops"``, ``"bytes
    accessed"``) and collective bytes (``coll["total_bytes"]``, or None)
    at the H100's rates."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = None if coll is None else float(coll["total_bytes"])
    mf_dev = model_flops_global / chips
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=None if cbytes is None else cbytes / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes_per_device=cbytes,
        model_flops=model_flops_global,
        useful_flops_ratio=(mf_dev / flops) if flops else 0.0,
    )


def memory_summary(meta: dict | None = None) -> dict:
    """Without ``meta``: the card's allocator after a run
    (``torch.cuda.max_memory_allocated`` and ``memory_stats``; raises
    without a card). With a dry-run cell's ``meta``: its static bytes
    per device and its analytic peak (static + activations)."""
    if meta is not None:
        return {"source": "analytic",
                "static_bytes_per_device": int(
                    meta["static_bytes_per_device"]),
                "analytic_peak_bytes": int(meta["analytic_peak_bytes"])}
    stats = torch.cuda.memory_stats()
    return {"source": torch.cuda.get_device_name(0),
            "max_allocated_bytes": int(torch.cuda.max_memory_allocated()),
            "allocated_bytes": int(stats.get("allocated_bytes.all.current",
                                             0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "alloc_retries": int(stats.get("num_alloc_retries", 0))}


def _pairs(tree: Any, specs: Any):
    """(tensor, spec) of every tensor leaf of ``tree`` (dicts, lists);
    other leaves (a cache's host-int ``length``) are skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _pairs(v, s)


def sharded_bytes(tree: Any, specs: Any, mesh) -> int:
    """Exact per-device bytes of a tree of tensors (real or meta) under
    ``specs`` (the same tree of ``sharding.rules.P``) on ``mesh``: each
    tensor's bytes over the product of the axis sizes its spec names,
    rounded down as the reference does."""
    axes = mesh_shape(mesh)
    total = 0
    for t, spec in _pairs(tree, specs):
        n = t.numel()
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= axes[a]
        total += n * t.element_size() // max(denom, 1)
    return total


def analytic_activation_bytes(cfg, shape, mesh, meta, *,
                              resid_bytes: int = 2) -> int:
    """Per-device activation watermark under per-layer remat: layer-boundary
    checkpoints + one layer's live intermediates + one CE chunk, the
    reference's model. ``resid_bytes`` is a residual element's size: 2 for
    the reference's bfloat16 checkpoints (its only case), 4 for a float32
    run; logits and the CE chunk are float32 either way."""
    axes = mesh_shape(mesh)
    baxes = [a for a in ("pod", "data") if a in axes]
    n_b = math.prod(axes[a] for a in baxes) if baxes else 1
    if shape.kind == "train":
        b_local = max(1, meta.get("b_micro", shape.global_batch) // n_b)
    else:
        b_local = max(1, shape.global_batch // n_b)
    seq = min(shape.seq_len, cfg.max_target_len) if cfg.enc_dec \
        else shape.seq_len
    if shape.kind == "decode":
        seq = 1
    d = cfg.d_model
    resid = b_local * seq * d * resid_bytes             # checkpoints
    ckpts = cfg.n_layers * resid if shape.kind == "train" else 2 * resid
    # one live layer: qkv + attn logits (n_heads/model-sharded if divisible)
    n_m = axes.get("model", 1)
    h_shard = cfg.n_heads // n_m if cfg.n_heads % n_m == 0 else cfg.n_heads
    live = 4 * resid + b_local * h_shard * seq * min(seq, 4096) * 4
    ce = 0
    if shape.kind == "train":
        chunk = min(seq, 512)
        v_shard = cfg.vocab // n_m if cfg.vocab % n_m == 0 else cfg.vocab
        ce = b_local * chunk * v_shard * 4 * 2          # logits + grad
    return int(ckpts + live + ce)


class OpBytes(TorchDispatchMode):
    """Sums the bytes each operation reads and writes: every tensor
    argument and result of every op that is not a view, counted at each
    op, as if nothing were fused or kept in cache (an upper bound on the
    bytes a fused program moves). Works on the meta device."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += tree_nbytes((args, kwargs or {}, out))
        return out


_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "broadcast"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                          "c10d")


class CollectiveBytes(TorchDispatchMode):
    """Counts the collectives that run under it, by kind (the reference's
    names: ``all-gather``, ``reduce-scatter``, ``all-reduce``,
    ``all-to-all``; ``broadcast``), and sums each one's result bytes on
    this rank, as the reference's :func:`collective_bytes` reads an HLO
    collective's result shape. It sees what DTensor desugars into (it
    defers on DTensor arguments, as ``CommDebugMode`` does), so on the
    meta device under a fake process group the local shapes, and the
    bytes, are one device's."""

    def __init__(self):
        super().__init__()
        self.counts: dict[str, int] = {}
        self.per_kind_bytes: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = self._kind(func)
        if kind is not None:
            result = out if func.namespace != "c10d" else args[0]
            self.counts[kind] = self.counts.get(kind, 0) + 1
            self.per_kind_bytes[kind] = (self.per_kind_bytes.get(kind, 0)
                                         + tree_nbytes(result))
        return out

    @staticmethod
    def _kind(func) -> str | None:
        if getattr(func, "namespace", None) not in _COLLECTIVE_NAMESPACES:
            return None
        name = func._overloadpacket.__name__
        for key, kind in _KINDS:
            if key in name:
                return kind
        return None

    def summary(self) -> dict:
        return {"counts": dict(self.counts),
                "per_kind_bytes": dict(self.per_kind_bytes),
                "total_bytes": sum(self.per_kind_bytes.values())}


def count_collectives(fn) -> tuple[Any, dict]:
    """``fn()`` under ``CommDebugMode`` and :class:`CollectiveBytes`:
    its result and ``{"counts", "per_kind_bytes", "total_bytes",
    "comm_debug_total"}`` (``CommDebugMode``'s own count of the
    collectives, which equals the sum of ``counts``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    counter = CollectiveBytes()
    with CommDebugMode() as comm, counter:
        out = fn()
    return out, {**counter.summary(),
                 "comm_debug_total": int(comm.get_total_counts())}


def scale_collectives(coll: dict, factor: int) -> dict:
    """Collective counts and bytes times ``factor`` (microbatches)."""
    return {"counts": {k: v * factor for k, v in coll["counts"].items()},
            "per_kind_bytes": {k: v * factor
                               for k, v in coll["per_kind_bytes"].items()},
            "total_bytes": coll["total_bytes"] * factor,
            "comm_debug_total": coll["comm_debug_total"] * factor}


def add_collectives(a: dict, b: dict) -> dict:
    """Two collective records summed kind by kind."""
    def merged(key):
        return {k: a[key].get(k, 0) + b[key].get(k, 0)
                for k in sorted(set(a[key]) | set(b[key]))}
    return {"counts": merged("counts"),
            "per_kind_bytes": merged("per_kind_bytes"),
            "total_bytes": a["total_bytes"] + b["total_bytes"],
            "comm_debug_total": a["comm_debug_total"] + b["comm_debug_total"]}


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    return 0


__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "HBM_BYTES",
           "COLLECTIVES_NOT_COUNTED", "RooflineTerms", "roofline",
           "memory_summary", "sharded_bytes", "analytic_activation_bytes",
           "OpBytes", "CollectiveBytes", "count_collectives",
           "scale_collectives", "add_collectives", "tree_nbytes"]
