"""Device-resident telemetry counters (the reference's ``obs/device.py`` on
tensors).

A session step's one blocking host transfer is a small packed int32
vector

    [flags, overflow, oob, disp_bits, migrated, halo, occ_0, ..., occ_{L-1}]

where ``disp_bits`` is the f32 max-squared-displacement viewed as int32
(lossless; unpacked host-side with a view), ``migrated`` and ``halo`` are
the rows that crossed a slab face and the halo rows received (filled by
the sharded session, zero for a single-device one), and ``occ_i`` counts
query tiles on ladder level ``i`` (the escalation-occupancy histogram).
The port's sessions fetch the header before they plan, so they pack no
occupancy tail (the sharded session packs its per-slab stale flags
there); a plan's histogram reaches the host later without a sync of its
own (``core/dynamic.py``, ``core/shards.py``).

The kernels' own work counters live on the device too, and reach the
host only when :func:`kernel_counters` is called.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

# header slots before the per-level occupancy tail
TELEM_FLAGS = 0
TELEM_OVERFLOW = 1
TELEM_OOB = 2
TELEM_DISP_BITS = 3
TELEM_MIGRATED = 4
TELEM_HALO = 5
TELEM_HEADER = 6


def level_occupancy(tile_levels: Tensor, n_levels: int) -> Tensor:
    """Per-ladder-level query-tile occupancy histogram [n_levels] int32.

    Counts with ``index_add_`` into ``n_levels + 1`` slots, not
    ``torch.bincount``, which reads the input's maximum on the host (a
    sync on CUDA). As the reference's ``jnp.bincount(length=n_levels)``
    does, negative levels count as level 0 and levels past the end are
    dropped (into the extra slot, which is sliced off).
    """
    lv = tile_levels.reshape(-1).to(torch.int64).clamp(0, n_levels)
    hist = torch.zeros((n_levels + 1,), dtype=torch.int32,
                       device=tile_levels.device)
    hist.index_add_(0, lv, torch.ones_like(lv, dtype=torch.int32))
    return hist[:n_levels]


def pack_step_telemetry(flags: Tensor, *, overflow: Tensor, oob: Tensor,
                        max_disp2: Tensor,
                        occupancy: Tensor | None = None,
                        migrated: Tensor | None = None,
                        halo: Tensor | None = None) -> Tensor:
    """Pack per-step counters into one int32 vector [TELEM_HEADER + L] on
    the counters' device, without a sync. Every argument is a 0-d int32 or
    f32 tensor except ``occupancy`` [L] int32 (None packs no tail);
    ``migrated`` and ``halo`` None pack zeros."""
    def i32(x):
        if x is None:
            return torch.zeros((), dtype=torch.int32, device=flags.device)
        return x.to(torch.int32).reshape(())

    disp_bits = max_disp2.to(torch.float32).reshape(()).view(torch.int32)
    head = torch.stack([i32(flags), i32(overflow), i32(oob), disp_bits,
                        i32(migrated), i32(halo)])
    if occupancy is None:
        return head
    return torch.cat([head, occupancy.to(torch.int32).reshape(-1)])


def unpack_step_telemetry(vec) -> dict:
    """Host-side unpack of a fetched telemetry vector (a CPU tensor or a
    numpy array). Returns plain Python numbers: flags, overflow, oob,
    max_disp2 (f32 recovered from its bit pattern), migrated, halo, and
    the occupancy list."""
    v = np.asarray(vec, np.int32).reshape(-1)
    return {
        "flags": int(v[TELEM_FLAGS]),
        "overflow": int(v[TELEM_OVERFLOW]),
        "oob": int(v[TELEM_OOB]),
        "max_disp2": float(v[TELEM_DISP_BITS:TELEM_DISP_BITS + 1]
                           .view(np.float32)[0]),
        "migrated": int(v[TELEM_MIGRATED]),
        "halo": int(v[TELEM_HALO]),
        "occupancy": [int(x) for x in v[TELEM_HEADER:]],
    }


def kernel_counters() -> dict:
    """``{kernel: counts}`` of the kernels that count their own work on
    the device, each fetched once now (a copy that waits for the kernel's
    launches); a kernel that has not run on a card is absent. Today:
    ``knn_tile_anchored``'s walk (``kernels.knn_tile.walk_counts``): the
    query rows and the boxed ones among them, window cells looked up,
    occupied cells, candidate ids staged and candidate pairs compared, in
    all and ``by_signature``."""
    from ..kernels import knn_tile
    walk = knn_tile.walk_counts()
    return {} if walk is None else {"knn_tile_anchored": walk}
