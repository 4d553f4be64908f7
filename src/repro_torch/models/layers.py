"""Layer library of the port: what the ``rwkv``, ``rglru`` and attention
layer kinds (dense, M-RoPE, MLA, MoE) and the Whisper encoder-decoder
need.

Port of ``src/repro/models/layers.py``: the dense init, the two norms,
rotary embeddings (standard and M-RoPE), grouped-query attention with its
linear and ring-buffer KV caches, Multi-head Latent Attention with its
latent cache, the SwiGLU and GELU MLPs, the Mixture of Experts
feed-forward (top-k routing, sorted capacity dispatch: ``moe_fwd`` as
``moe_route``, ``moe_dispatch``, ``moe_experts``, ``moe_combine``;
``moe_aux_loss``), the RG-LRU recurrent block (Griffin) and the RWKV-6
(Finch) time mix and channel mix.
``init_*`` returns a dict of tensors as the reference's returns a param
dict; the ``*_fwd`` functions apply a mapping of parameters by name (a
dict, an ``nn.ParameterDict`` or one of the modules below) and return
what the reference's return. :class:`Attention`, :class:`MLA`,
:class:`SwiGLU`, :class:`MoE`, :class:`GeluMLP`, :class:`RGLRU`,
:class:`RWKV6TimeMix` and :class:`RWKV6ChannelMix` hold the parameters as ``nn.Module``s under
the reference's names. Parameters are made for serving: they require
gradients only after ``requires_grad_()`` (which
``models.model.init_params(..., requires_grad=True)`` calls). The time
mix runs its recurrence through ``kernels.rwkv_scan.rwkv_scan`` (no
backward) when no gradient is needed, and through
:func:`rwkv_chunked_core`, plain tensor operations that autograd
differentiates, when one is. Attention is plain tensor operations, as the
reference's is einsum math (no Pallas kernel stands behind it): grouped
attention with rotary (``apply_rope``) or multimodal rotary
(``apply_mrope``, Qwen2-VL's M-RoPE) positions, and Multi-head Latent
Attention (``mla_fwd``, :class:`MLA`: DeepSeek-V2 / MiniCPM3), whose
decode cache holds the compressed latent and whose single-token decode
attends in the latent space (``_mla_absorbed_decode``). The MoE is
plain tensor operations too (the reference's expert GEMMs are batched
einsums): a stable sort by expert, ranks and capacity drops exactly as
the reference's, the expert GEMMs as ``torch.bmm``, and a deterministic
combine. The RG-LRU block is plain tensor operations too (the reference's
is an associative scan and einsums): its recurrence is a doubling scan
(``_rglru_scan``) that autograd differentiates. The Whisper encoder and
cross-attention reuse the attention, LayerNorm and GELU MLP above.

Sharding: every ``*_fwd`` takes ``shard`` (:func:`NO_SHARD` by default),
a callable that constrains named activations at the reference's points
(``sharding.rules.make_shard_fn``: a no-op on plain tensors, a
redistribution of a DTensor); ``_sdpa`` repeats the kv heads to H where
``shard.model_size`` divides the q heads but not the kv heads.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Mapping, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.rwkv_scan import per_head_placements, rwkv_scan

Tensor = torch.Tensor
Cache = dict[str, Any]


def full(x: Tensor) -> Tensor:
    """``x`` whole on every rank: a DTensor's ``full_tensor()`` (a
    differentiable gather), a plain tensor as it is. For the integer index
    work that DTensor has no sharding strategy for (MoE routing)."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def replicated_as(x: Tensor, like: Tensor) -> Tensor:
    """A plain ``x`` that every rank computed alike, as a replicated
    DTensor on ``like``'s mesh (differentiably: its gradient comes back
    plain, which :func:`full`'s backward needs); ``x`` as it is where
    ``like`` is a plain tensor or ``x`` a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(like, DTensor) or isinstance(x, DTensor):
        return x
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reshape(x: Tensor, *shape) -> Tensor:
    """``x.reshape(*shape)``, a plain tensor's as it is. On a DTensor, in
    the forward and the backward pass alike, a tensor whose placements the
    reshape cannot carry (a sharded dim split into a head count that its
    mesh axis does not divide: DTensor raises where XLA pads) is made
    whole along every dim but the first (the batch) and then reshaped."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _DTensorReshape.apply(x, shape)


def _reshape_dtensor(x: Tensor, shape) -> Tensor:
    try:
        return x.reshape(*shape)
    except RuntimeError:
        return _whole_but_batch(x).reshape(*shape)


def _whole_but_batch(x: Tensor) -> Tensor:
    """``x`` replicated on every tensor dim but the first (the batch)."""
    for d in range(1, x.ndim):
        x = unshard_dim(x, d)
    return x


class _DTensorReshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        # a copy, not a view of ``x``: autograd would replay a view of an
        # input with the plain view op, which is what fails here
        return _reshape_dtensor(x, shape).clone()

    @staticmethod
    def backward(ctx, g):
        return _reshape_dtensor(g, ctx.in_shape), None


def unshard_dim(x: Tensor, dim: int) -> Tensor:
    """``x`` with tensor dim ``dim`` replicated on every mesh dim that
    shards it (a differentiable redistribute); other placements kept. A
    plain tensor as it is. DTensor's ``embedding`` and ``gather`` cannot
    index along a sharded dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = [Replicate() if isinstance(pl, Shard) and pl.dim == dim else pl
            for pl in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def pin(shard, x: Tensor, name: str) -> Tensor:
    """``x`` pinned to the placements that ``shard(x, name)`` would give
    it, in the backward its gradient too (``shard.pin``), at a point where
    the reference has no constraint: XLA's partitioner propagates layouts
    over the whole program, DTensor op by op, and a partial sum left to a
    nonlinearity's own propagation can come back split on the sequence,
    whose flattening for a weight's gradient then sends DTensor's
    sharding propagation on a three-axis mesh into its graph-search
    planner for minutes. Not a ``shard`` call: those stay the
    reference's. ``x`` as it is where ``shard`` has no ``pin``."""
    fn = getattr(shard, "pin", None)
    return x if fn is None else fn(x, name)


def NO_SHARD(x: Tensor, name: str) -> Tensor:
    """The default ``shard`` callable: no constraint. A ``shard(x, name)``
    (``sharding.rules.make_shard_fn``) names the activation it is handed
    (``act_resid``, ``act_heads``, ``act_ffn``, ``attn_logits``,
    ``attn_logits4``, ``logits``, ``logits_last``, ``moe_dispatch``,
    ``moe_ffn``) at the points where the reference constrains it, and may
    carry ``model_size``, the model axis' size."""
    return x


def _dense_init(gen: torch.Generator | None, shape, scale=None,
                dtype=torch.float32, device=None) -> Tensor:
    """N(0, scale^2) of ``shape`` drawn in float32 from ``gen`` on
    ``device`` (``scale`` defaults to 1/sqrt(fan_in)), cast to ``dtype``.
    On the meta device it only allocates the shape."""
    dev = torch.device(device) if device is not None else (
        gen.device if gen is not None else torch.device("cpu"))
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    out = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    return out.mul_(scale).to(dtype)


def param_dict(tensors: Mapping[str, Tensor]) -> nn.ParameterDict:
    """``tensors`` as an ``nn.ParameterDict`` of parameters that do not
    require gradients."""
    return nn.ParameterDict({name: nn.Parameter(t, requires_grad=False)
                             for name, t in tensors.items()})


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(x: Tensor, p: Mapping[str, Tensor], eps: float) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32)).to(x.dtype)


def init_layernorm(d: int, dtype, device=None) -> dict[str, Tensor]:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(x: Tensor, p: Mapping[str, Tensor], eps: float) -> Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_rot: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                         device=device) / d_rot))


def apply_rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x [B,S,H,D] (D even, fully rotary), pos [B,S] int -> rotated x: the
    angles in float32, the two halves rotated, cast back to x's dtype."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                # [D/2]
    ang = pos[..., None].to(torch.float32) * freqs        # [B,S,D/2]
    return _rotate(x, ang)


def _rotate(x: Tensor, ang: Tensor) -> Tensor:
    """x [B,S,H,D] rotated by the float32 angles ``ang`` [B,S,D/2]: the
    first half against the second, cast back to x's dtype."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def mrope_sections(hd: int) -> tuple[int, int, int]:
    """The (temporal, height, width) split of a head's ``hd / 2``
    frequencies that the reference's attention uses: ``(hd/2 - 2 *
    floor(hd/6), floor(hd/6), floor(hd/6))``, (22, 21, 21) at hd 128.
    (Qwen2-VL publishes (16, 24, 24); the port mirrors the reference.)"""
    third = hd // 2 // 3
    return (hd // 2 - 2 * third, third, third)


def apply_mrope(x: Tensor, pos3: Tensor, theta: float,
                sections: tuple[int, int, int]) -> Tensor:
    """Qwen2-VL M-RoPE: the head dim's frequencies are split into
    (temporal, height, width) sections, each rotated by its own position
    stream. x [B,S,H,D], pos3 [B,S,3] int -> rotated x. Frequency j takes
    the stream of the section that covers it (the first ``sections[0]``
    the temporal one, and so on; any beyond their sum the temporal one, as
    in the reference)."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)                # [half]
    sec = torch.zeros(half, dtype=torch.int64, device=x.device)
    off = 0
    for i, n in enumerate(sections):
        sec[off:off + n] = i
        off += n
    b, s = pos3.shape[:2]
    pos_per_freq = pos3.to(torch.float32).gather(
        -1, sec.expand(b, s, half))                       # [B,S,half]
    return _rotate(x, pos_per_freq * freqs)


# ---------------------------------------------------------------------------
# attention (GQA / MQA / MHA), optional sliding window, KV cache
# ---------------------------------------------------------------------------

_MASKED = -1e30          # the reference's fill: a fully masked row gives a
                         # uniform softmax there too, not NaN


def init_attention(gen, cfg, dtype, device=None) -> dict[str, Tensor]:
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, h, hd), None, dtype, device),
        "wk": _dense_init(gen, (d, hk, hd), None, dtype, device),
        "wv": _dense_init(gen, (d, hk, hd), None, dtype, device),
        "wo": _dense_init(gen, (h, hd, d), 1.0 / math.sqrt(h * hd), dtype,
                          device),
    }
    if cfg.attn_bias:
        p["bq"] = torch.zeros((h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hk, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hk, hd), dtype=dtype, device=device)
    return p


def _sdpa(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
          window: int | None, q_offset: int = 0,
          kpos: Tensor | None = None, shard=NO_SHARD) -> Tensor:
    """q [B,Sq,H,D], k/v [B,Sk,Hk,D] -> [B,Sq,H,D]. GQA by head grouping:
    query head h attends with kv head h // (H / Hk). Logits in float32
    over sqrt(D), masked with -1e30, softmax in float32, probabilities
    cast to q's dtype.

    When the kv-head count does not divide the model axis
    (``shard.model_size``) but the q-head count does (kv 8 under model 16),
    the kv heads are repeated to H (Megatron-style), so that the [B, H,
    Sq, Sk] logits shard fully on q heads (``attn_logits4``) instead of
    replicating across the model axis; the same function, each query head
    with its group's kv head.

    ``q_offset`` positions query i at absolute position q_offset + i for
    the causal and window masks (key j at j); ``kpos`` [Sk] gives the keys'
    absolute positions instead (a ring-buffer cache), a negative entry
    marking an unwritten slot."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hk
    msize = getattr(shard, "model_size", 1)
    expand = g > 1 and hk % msize != 0 and h % msize == 0
    dev = q.device
    qpos = torch.arange(sq, device=dev)[:, None] + q_offset
    if kpos is None:
        kp = torch.arange(sk, device=dev)[None, :]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    else:
        kp = kpos[None, :]
        mask = kp >= 0
    if causal:
        mask = mask & (kp <= qpos)
    if window is not None:
        mask = mask & (kp > qpos - window)

    if expand:
        ke = _repeat_heads(k, g)                          # [B,Sk,H,D]
        ve = _repeat_heads(v, g)
        logits = _einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                         ke.to(torch.float32))
        logits = shard(logits, "attn_logits4") / math.sqrt(d)
        logits = torch.where(mask, logits, logits.new_full((), _MASKED))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        dt = torch.promote_types(probs.dtype, ve.dtype)
        return _einsum("bhqk,bkhd->bqhd", probs.to(dt), ve.to(dt))
    qg = reshape(q, b, sq, hk, g, d)
    logits = _einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                     k.to(torch.float32))
    logits = shard(logits, "attn_logits")
    logits = logits / math.sqrt(d)
    logits = torch.where(mask, logits, logits.new_full((), _MASKED))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = _einsum("bhgqk,bkhd->bqhgd", probs.to(dt), v.to(dt))
    return reshape(out, b, sq, h, dv)


def _repeat_heads(x: Tensor, g: int) -> Tensor:
    """[B, S, Hk, D] -> [B, S, Hk * g, D], each head repeated ``g`` times
    in place (``repeat_interleave``). A DTensor goes through
    :func:`reshape`, whose backward can split a head count that the mesh
    axis does not divide."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x.repeat_interleave(g, dim=2)
    b, s, hk, d = x.shape
    return reshape(x[:, :, :, None].expand(b, s, hk, g, d), b, s, hk * g, d)


def _write(buf: Tensor, update: Tensor, start: int) -> Tensor:
    """``buf`` with ``update`` written along axis 1 from ``start``, as a
    new tensor: ``jax.lax.dynamic_update_slice``, whose start is clamped
    to [0, size - update size] so that the update always fits."""
    size, n = buf.shape[1], update.shape[1]
    if n > size:
        raise ValueError(f"a cache write of {n} positions into {size}")
    start = min(max(start, 0), size - n)
    return torch.slice_scatter(buf, update.to(buf.dtype), dim=1,
                               start=start, end=start + n)


def attention_fwd(p: Mapping[str, Tensor], x: Tensor, cfg, *,
                  pos: Tensor | None, cache: Cache | None = None,
                  causal: bool = True, window: int | None = None,
                  shard=NO_SHARD) -> tuple[Tensor, Cache | None]:
    """Returns (out [B,S,d], new_cache). ``pos`` are the tokens' positions
    for the rotary embedding: [B,S] for ``cfg.pos == "rope"``, [B,S,3]
    (temporal, height, width) for ``"mrope"``.

    ``cache`` is ``{"k", "v" [B, S_max, Hk, D], "length": int}`` (decode
    appends at ``length``, a host int, so a step makes no blocking
    transfer), or, for a sliding-window layer, a ring buffer with
    ``"pos"`` [B, S_max] int32 as well: written at ``length % S_max``,
    holding each slot's absolute position (-1: unwritten) for the mask.
    Writes clamp as ``dynamic_update_slice`` does (:func:`_write`). The
    new cache is new tensors; the one passed in is left as it was."""
    b, s, d = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = reshape(x @ reshape(p["wq"], d, h * hd), b, s, h, hd)
    k = reshape(x @ reshape(p["wk"], d, hk * hd), b, s, hk, hd)
    v = reshape(x @ reshape(p["wv"], d, hk * hd), b, s, hk, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = shard(q, "act_heads")

    if cfg.pos == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    elif cfg.pos == "mrope":
        sections = mrope_sections(hd)
        q = apply_mrope(q, pos, cfg.rope_theta, sections)
        k = apply_mrope(k, pos, cfg.rope_theta, sections)

    if cache is None:
        out = _sdpa(q, k, v, causal=causal, window=window, shard=shard)
        new_cache = None
    elif "pos" in cache:
        # ring buffer (sliding-window layers): cache memory stays O(window)
        length = cache["length"]
        slot = length % cache["k"].shape[1]
        ck = _write(cache["k"], k, slot)
        cv = _write(cache["v"], v, slot)
        new_pos = (torch.arange(s, dtype=torch.int32, device=x.device)
                   + length).expand(cache["pos"].shape[0], s)
        cp = _write(cache["pos"], new_pos, slot)
        out = _sdpa(q, ck, cv, causal=True, window=window, q_offset=length,
                    kpos=cp[0], shard=shard)
        new_cache = {"k": ck, "v": cv, "pos": cp, "length": length + s}
    else:
        length = cache["length"]
        ck = _write(cache["k"], k, length)
        cv = _write(cache["v"], v, length)
        # causal mask with q_offset both enforces causality and excludes
        # unwritten cache rows (kpos > length + Sq - 1)
        out = _sdpa(q, ck, cv, causal=True, window=window, q_offset=length,
                    shard=shard)
        new_cache = {"k": ck, "v": cv, "length": length + s}
    o = reshape(out, b, s, h * hd) @ reshape(p["wo"], h * hd, d)
    return shard(o, "act_resid"), new_cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3)
# ---------------------------------------------------------------------------

def init_mla(gen, cfg, dtype, device=None) -> dict[str, Any]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "q_a": _dense_init(gen, (d, m.q_rank), None, dtype, device),
        "q_norm": init_rmsnorm(m.q_rank, dtype, device),
        "q_b": _dense_init(gen, (m.q_rank, h, m.d_nope + m.d_rope), None,
                           dtype, device),
        "kv_a": _dense_init(gen, (d, m.kv_rank + m.d_rope), None, dtype,
                            device),
        "kv_norm": init_rmsnorm(m.kv_rank, dtype, device),
        "kv_b": _dense_init(gen, (m.kv_rank, h, m.d_nope + m.d_v), None,
                            dtype, device),
        "wo": _dense_init(gen, (h, m.d_v, d), 1.0 / math.sqrt(h * m.d_v),
                          dtype, device),
    }


def _einsum(eq: str, *ops: Tensor) -> Tensor:
    """``torch.einsum`` with the operands promoted to one dtype, as
    ``jnp.einsum`` promotes (a bfloat16 cache against float32 weights).
    Two DTensor operands go through :class:`_DTensorEinsum`."""
    from torch.distributed.tensor import DTensor

    dt = ops[0].dtype
    for t in ops[1:]:
        dt = torch.promote_types(dt, t.dtype)
    ops = tuple(t.to(dt) for t in ops)
    if len(ops) == 2 and any(isinstance(t, DTensor) for t in ops):
        return _DTensorEinsum.apply(eq, *ops)
    return torch.einsum(eq, *ops)


class _DTensorEinsum(torch.autograd.Function):
    """``einsum("a,b->c")`` whose backward is two more einsums
    (``"c,b->a"``, ``"a,c->b"``) instead of autograd's views of the
    gradient, which DTensor cannot split where a head count does not
    divide its mesh axis (MLA's 40 heads under a model axis of 16)."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return _einsum_dtensor(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ins, out = ctx.eq.replace(" ", "").split("->")
        ia, ib = ins.split(",")
        ga = (_einsum_dtensor(f"{out},{ib}->{ia}", g, b)
              if ctx.needs_input_grad[1] else None)
        gb = (_einsum_dtensor(f"{ia},{out}->{ib}", a, g)
              if ctx.needs_input_grad[2] else None)
        return None, ga, gb


def _einsum_dtensor(eq: str, a: Tensor, b: Tensor) -> Tensor:
    """``torch.einsum`` of DTensors; where DTensor cannot carry the
    placements through einsum's internal views, the operands are made
    whole along every dim but the first and the einsum runs again. On a
    mesh with "pod" and "data" axes it runs on :func:`_flat_batch_mesh`
    wherever both operands are placed alike on those two."""
    flat = _on_flat_batch(a, b)
    if flat is not None:
        lift, a, b = flat
        return lift(_einsum_dtensor(eq, a, b))
    try:
        return torch.einsum(eq, a, b)
    except RuntimeError:
        return torch.einsum(eq, _whole_but_batch(a), _whole_but_batch(b))


def take_rows(table: Tensor, ids: Tensor) -> Tensor:
    """``table[ids]`` (an embedding lookup). On DTensors of a mesh with
    "pod" and "data" it runs on :func:`_flat_batch_mesh`, the table first
    made whole on whichever of the two shards it alone (an FSDP table),
    where DTensor's sharding propagation of the index takes the two-axis
    path: on the three-axis mesh PyTorch 2.11's refuses ids sharded on
    two mesh dims."""
    flat = _on_flat_batch(_alike_on_batch_axes(table, ids), ids)
    if flat is not None:
        lift, table, ids = flat
        return lift(table[ids])
    return table[ids]


def _alike_on_batch_axes(x: Tensor, like: Tensor) -> Tensor:
    """``x`` made whole on the one of "pod" and "data" that shards it
    where the other leaves it replicated, when ``like`` is a DTensor of
    the same mesh; else as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(x, DTensor) and isinstance(like, DTensor)
            and x.device_mesh == like.device_mesh):
        return x
    names = list(x.device_mesh.mesh_dim_names or ())
    if "pod" not in names or "data" not in names:
        return x
    i, j = names.index("pod"), names.index("data")
    pl = list(x.placements)
    if pl[i] != pl[j] and Replicate() in (pl[i], pl[j]):
        pl[i] = pl[j] = Replicate()
        return x.redistribute(x.device_mesh, pl)
    return x


_FLAT_MESHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _flat_batch_mesh(mesh):
    """``mesh`` with its adjacent "pod" and "data" dims merged into one,
    "pod_data" (pod major, so rank (p, d) sits at p * |data| + d): the same
    ranks, one process group over the batch axes. Made once a mesh (kept
    while the mesh lives), on every rank alike: a new ``DeviceMesh``
    makes its groups collectively.

    DTensor's sharding propagation of an einsum on the three-axis mesh
    prices every candidate placement across the three dims, and a batch
    sharded on two of them sends those prices through its graph-search
    redistribute planner, which does not finish for the attention einsums
    at production shapes; on the merged mesh it is the two-axis case."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh not in _FLAT_MESHES:
        names = list(mesh.mesh_dim_names)
        i = names.index("pod")
        names[i:i + 2] = ["pod_data"]
        _FLAT_MESHES[mesh] = DeviceMesh(
            mesh.device_type, mesh.mesh.flatten(i, i + 1),
            mesh_dim_names=tuple(names))
    return _FLAT_MESHES[mesh]


def _on_flat_batch(a: Tensor, b: Tensor):
    """``(lift, a', b')``: ``a`` and ``b`` as DTensors of
    :func:`_flat_batch_mesh` holding the same local tensors, and ``lift``,
    which takes a DTensor of that mesh back to ``a``'s mesh. None unless
    both are DTensors of one mesh with adjacent "pod" and "data" dims on
    which each is placed alike (both replicated, both partial, or both
    sharding one tensor dim that their product divides)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not (isinstance(a, DTensor) and isinstance(b, DTensor)):
        return None
    mesh = a.device_mesh
    names = list(mesh.mesh_dim_names or ())
    if (b.device_mesh != mesh or "pod" not in names or "data" not in names
            or names.index("data") != names.index("pod") + 1):
        return None
    i = names.index("pod")
    n = mesh.size(i) * mesh.size(i + 1)
    for x in (a, b):
        p, q = x.placements[i], x.placements[i + 1]
        if p != q or type(p) not in (Shard, Replicate, Partial):
            return None
        if isinstance(p, Shard) and x.shape[p.dim] % n:
            return None
    flat = _flat_batch_mesh(mesh)

    def move(x, to, pl):
        return DTensor.from_local(x.to_local(), to, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    def lift(y):
        pl = list(y.placements)
        if isinstance(pl[i], Shard) and y.shape[pl[i].dim] % n:
            pl[i] = Replicate()         # two even splits only where n divides
            y = y.redistribute(flat, pl)
        return move(y, mesh, pl[:i + 1] + pl[i:])

    def lower(x):
        pl = list(x.placements)
        return move(x, flat, pl[:i] + pl[i + 1:])

    return lift, lower(a), lower(b)


def mla_project(p: Mapping[str, Any], x: Tensor, cfg, pos: Tensor,
                shard=NO_SHARD) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The per-token part of MLA: the low-rank query (``q_a``, RMSNorm,
    ``q_b``) split into ``q_nope`` [B,S,H,d_nope] and the rotated
    ``q_rope`` [B,S,H,d_rope], and the compressed KV (``kv_a``) split into
    the RMS-normed ``latent`` [B,S,kv_rank] and the shared rotated key
    ``k_rope`` [B,S,1,d_rope]."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = rmsnorm(pin(shard, x @ p["q_a"], "act_resid"), p["q_norm"],
                cfg.norm_eps)
    q = reshape(q @ reshape(p["q_b"], m.q_rank, -1),
                b, s, h, m.d_nope + m.d_rope)
    q_nope = q[..., : m.d_nope]
    q_rope = apply_rope(q[..., m.d_nope:], pos, cfg.rope_theta)
    kv = pin(shard, x @ p["kv_a"], "act_resid")
    latent = rmsnorm(kv[..., : m.kv_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, m.kv_rank:], pos, cfg.rope_theta)
    return q_nope, q_rope, latent, k_rope


def mla_expanded(p: Mapping[str, Any], q_nope: Tensor, q_rope: Tensor,
                 latent: Tensor, k_rope: Tensor, q_offset: int, m
                 ) -> Tensor:
    """Attention over the latent expanded to full keys and values: K/V =
    ``latent @ kv_b`` [B,Sk,H,d_nope+d_v], each head's key completed with
    the shared ``k_rope``, then causal ``_sdpa`` (q/k head dim d_nope +
    d_rope, v's d_v) with the queries at ``q_offset`` + i.
    -> [B,Sq,H,d_v]."""
    return _mla_attend(p, torch.cat([q_nope, q_rope], -1), latent, k_rope,
                       q_offset, m)


def _mla_attend(p: Mapping[str, Any], q: Tensor, latent: Tensor,
                k_rope: Tensor, q_offset: int, m, shard=NO_SHARD) -> Tensor:
    """:func:`mla_expanded` of the whole query ``q`` [B,Sq,H,d_nope +
    d_rope]."""
    kv_full = _einsum("bsr,rhk->bshk", latent, p["kv_b"])
    k_nope, v = kv_full[..., : m.d_nope], kv_full[..., m.d_nope:]
    k = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(
        *k_nope.shape[:3], m.d_rope)], -1)
    return _sdpa(q, k, v, causal=True, window=None, q_offset=q_offset,
                 shard=shard)


def _mla_absorbed_decode(p: Mapping[str, Any], q_nope: Tensor,
                         q_rope: Tensor, latent: Tensor, k_rope: Tensor,
                         length: int, m) -> Tensor:
    """Absorbed MLA decode (DeepSeek-V2 section 2.1.3): ``kv_b``'s key half
    is absorbed into the query and its value half into the output, so
    attention stays in the kv_rank-dim latent space and the cache is never
    expanded. Scores in float32 over sqrt(d_nope + d_rope), the cache
    slots up to ``length`` (the new token's) attended, probabilities cast
    to the cache's dtype. q_nope [B,1,H,d_nope], q_rope [B,1,H,d_rope],
    latent [B,S_max,kv_rank], k_rope [B,S_max,1,d_rope] -> [B,1,H,d_v]."""
    kv_b_k = p["kv_b"][..., : m.d_nope]            # [r, H, d_nope]
    kv_b_v = p["kv_b"][..., m.d_nope:]             # [r, H, d_v]
    q_lat = _einsum("bshk,rhk->bshr", q_nope, kv_b_k)
    f32 = torch.float32
    scores = _einsum("bshr,btr->bhst", q_lat.to(f32), latent.to(f32))
    scores = scores + _einsum("bshk,btk->bhst", q_rope.to(f32),
                              k_rope[:, :, 0].to(f32))
    scores = scores / math.sqrt(m.d_nope + m.d_rope)
    valid = torch.arange(latent.shape[1], device=latent.device) <= length
    scores = torch.where(valid, scores, scores.new_full((), _MASKED))
    probs = torch.softmax(scores, dim=-1)
    o_lat = _einsum("bhst,btr->bshr", probs.to(latent.dtype), latent)
    return _einsum("bshr,rhv->bshv", o_lat, kv_b_v)


def mla_fwd(p: Mapping[str, Any], x: Tensor, cfg, *, pos: Tensor,
            cache: Cache | None = None, shard=NO_SHARD
            ) -> tuple[Tensor, Cache | None]:
    """MLA forward: (out [B,S,d], new_cache). ``pos`` [B,S] are the
    positions the rotary parts turn by. The decode cache is
    ``{"latent" [B,S_max,kv_rank], "k_rope" [B,S_max,1,d_rope], "length":
    int}``: only the compressed latent and the shared rotary key a token,
    written at ``length`` (clamped as :func:`_write` clamps). Without a
    cache, and for a cache-writing step of S > 1 tokens (over the whole
    S_max latent, queries at ``length`` + i), attention runs on the
    expanded keys and values (:func:`mla_expanded`); a single-token step
    runs :func:`_mla_absorbed_decode`."""
    m = cfg.mla
    b, s, _ = x.shape
    q_nope, q_rope, latent, k_rope = mla_project(p, x, cfg, pos, shard)
    q = shard(torch.cat([q_nope, q_rope], -1), "act_heads")
    new_cache, q_offset = None, 0
    if cache is not None:
        length = cache["length"]
        latent = _write(cache["latent"], latent, length)
        k_rope = _write(cache["k_rope"], k_rope, length)
        new_cache = {"latent": latent, "k_rope": k_rope,
                     "length": length + s}
        q_offset = length
    if cache is not None and s == 1:
        out = _mla_absorbed_decode(p, q_nope, q_rope, latent, k_rope,
                                   length, m)
    else:
        out = _mla_attend(p, q, latent, k_rope, q_offset, m, shard)
    return shard(_einsum("bshv,hvd->bsd", out, p["wo"]), "act_resid"), \
        new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_swiglu(gen, d: int, ff: int, dtype, device=None) -> dict[str, Tensor]:
    return {
        "w_gate": _dense_init(gen, (d, ff), None, dtype, device),
        "w_up": _dense_init(gen, (d, ff), None, dtype, device),
        "w_down": _dense_init(gen, (ff, d), None, dtype, device),
    }


def swiglu_fwd(p: Mapping[str, Tensor], x: Tensor, shard=NO_SHARD
               ) -> Tensor:
    g = pin(shard, x @ p["w_gate"], "act_ffn")
    u = pin(shard, x @ p["w_up"], "act_ffn")
    h = shard(F.silu(g) * u, "act_ffn")
    return shard(h @ p["w_down"], "act_resid")


def init_gelu_mlp(gen, d: int, ff: int, dtype, device=None
                  ) -> dict[str, Tensor]:
    return {
        "w1": _dense_init(gen, (d, ff), None, dtype, device),
        "b1": torch.zeros((ff,), dtype=dtype, device=device),
        "w2": _dense_init(gen, (ff, d), None, dtype, device),
        "b2": torch.zeros((d,), dtype=dtype, device=device),
    }


def gelu_mlp_fwd(p: Mapping[str, Tensor], x: Tensor, shard=NO_SHARD
                 ) -> Tensor:
    """``jax.nn.gelu``'s default is the tanh approximation; so is this."""
    a = pin(shard, x @ p["w1"], "act_ffn") + p["b1"]
    h = shard(F.gelu(a, approximate="tanh"), "act_ffn")
    return shard(h @ p["w2"] + p["b2"], "act_resid")


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k routing, sorted capacity dispatch)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg, dtype, device=None) -> dict[str, Any]:
    mo = cfg.moe
    d = cfg.d_model
    ff = mo.d_expert or cfg.d_ff
    e = mo.n_experts
    p = {
        "router": _dense_init(gen, (d, e), 0.02, torch.float32, device),
        "w_gate": _dense_init(gen, (e, d, ff), None, dtype, device),
        "w_up": _dense_init(gen, (e, d, ff), None, dtype, device),
        "w_down": _dense_init(gen, (e, ff, d), None, dtype, device),
    }
    if mo.router_aux_free:
        p["router_bias"] = torch.zeros((e,), dtype=torch.float32,
                                       device=device)
    if mo.n_shared:
        p["shared"] = init_swiglu(gen, d, ff * mo.n_shared, dtype, device)
    return p


def top_k_ids(scores: Tensor, k: int) -> Tensor:
    """The indices of the ``k`` largest ``scores`` along the last axis,
    largest first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
    ties): a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][
        ..., :k]


class MoERoute(NamedTuple):
    """Where each of the ``t * k`` assignments of :func:`moe_route` goes.
    ``experts`` and ``probs`` [t, k] are each token's chosen experts and
    gates; the rest are over the assignments in expert-sorted order:
    ``order`` the flat index ``token * k + j`` at each sorted position,
    ``rank`` its place within its expert's group, ``keep`` whether it fits
    in the expert's ``cap`` slots, ``slot`` its row of the [E * cap]
    dispatch buffer (``E * cap``, the spare row, if dropped)."""
    experts: Tensor
    probs: Tensor
    order: Tensor
    rank: Tensor
    keep: Tensor
    slot: Tensor
    cap: int


def moe_capacity(t: int, mo) -> int:
    """Slots per expert for ``t`` tokens: ceil(t k / E x capacity_factor)."""
    return int(math.ceil(t * mo.top_k / mo.n_experts * mo.capacity_factor))


def moe_route(p: Mapping[str, Any], xf: Tensor, cfg) -> MoERoute:
    """Router and sorted capacity assignment of tokens ``xf`` [t, d]: the
    router logits in float32; the top-k experts of ``logits +
    router_bias`` (DeepSeek-V3's aux-free bias shifts the selection only);
    gates the softmax of the unbiased logits at those experts; a stable
    sort of the flat expert ids, so that among one expert's assignments
    the earlier flat index ranks first and keeps its slot."""
    mo = cfg.moe
    t = xf.shape[0]
    # on DTensors the logits come whole to every rank: the sort, ranks
    # and slots below are integer index work on [t, k] that DTensor has no
    # sharding strategy for (searchsorted), and every rank routes alike
    logits = full(xf.to(torch.float32) @ p["router"])
    sel = logits + full(p["router_bias"]) if "router_bias" in p else logits
    experts = top_k_ids(sel, mo.top_k)                        # [t, k]
    probs = torch.softmax(torch.gather(logits, 1, experts), dim=-1)
    flat_e = experts.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(t * mo.top_k, device=xf.device) - first
    cap = moe_capacity(t, mo)
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, mo.n_experts * cap))
    return MoERoute(experts, probs, order, rank, keep, slot, cap)


def moe_dispatch(xf: Tensor, route: MoERoute, n_experts: int) -> Tensor:
    """Tokens gathered into their experts' slots, [E, cap, d]; an empty
    slot is zero, and dropped assignments land in a spare row that is cut
    off."""
    d = xf.shape[1]
    k = route.experts.shape[1]
    buf = xf.new_zeros((n_experts * route.cap + 1, d))
    buf = buf.index_put((route.slot,), xf[route.order // k])
    return buf[:-1].reshape(n_experts, route.cap, d)


def moe_experts(p: Mapping[str, Any], buf: Tensor, shard=NO_SHARD
                ) -> Tensor:
    """Every expert's SwiGLU on its ``cap`` slots, as three batched GEMMs
    over [E, cap, d] (empty slots included, as in the reference)."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(shard(h, "moe_ffn"), p["w_down"])


def moe_combine(eo: Tensor, route: MoERoute, dtype) -> Tensor:
    """Each token's gate-weighted sum of its kept experts' outputs, in
    float32, cast to ``dtype``: [t, d]. Deterministic: every assignment
    gathers its slot's row (the appended zero row if dropped), and the
    ``k`` rows of a token are summed along an axis (the reference
    scatter-adds them)."""
    t, k = route.experts.shape
    d = eo.shape[-1]
    rows = torch.cat([eo.reshape(-1, d), eo.new_zeros((1, d))])
    slot_of = torch.empty_like(route.slot).index_put_(
        (route.order,), route.slot)                     # by flat index
    contrib = rows[slot_of].to(torch.float32) * route.probs.reshape(-1, 1)
    return contrib.reshape(t, k, d).sum(dim=1).to(dtype)


def moe_fwd(p: Mapping[str, Any], x: Tensor, cfg, shard=NO_SHARD
            ) -> Tensor:
    """Top-k MoE with *sorted* capacity dispatch: x [B, S, d] -> [B, S, d].

    Tokens are sorted by routed expert before the expert GEMMs, the
    reference's coherence transformation (its section-4 query scheduling
    applied to expert-route divergence). ``cap`` depends on t = B * S, so
    a prefill and a decode step drop differently at capacity factor 1.25.
    The shared experts (``p["shared"]``, DeepSeekMoE) are added after."""
    mo = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    # on DTensors, dispatch and combine index tokens and slots whole on
    # every rank (:func:`full`); the expert GEMMs run on the experts'
    # shards
    xw = full(xf)
    route = moe_route(p, replicated_as(xw, x), cfg)
    buf = replicated_as(moe_dispatch(xw, route, mo.n_experts), x)
    eo = moe_experts(p, shard(buf, "moe_dispatch"), shard)
    out = replicated_as(moe_combine(full(eo), route, x.dtype), x)
    if "shared" in p:
        out = out + swiglu_fwd(p["shared"], xf[None], shard)[0]
    return shard(out.reshape(b, s, d), "act_resid")


def moe_fwd_plain(p: Mapping[str, Any], x: Tensor, cfg) -> Tensor:
    """:func:`moe_fwd`'s function stated expert by expert, without the
    sort: the top-k by repeated first-maximum ``argmax``; for each expert,
    its assignments in flat order (token, then choice), the first ``cap``
    kept, run through that expert's SwiGLU and added with their gates in
    float32; then the shared experts. What ``moe_fwd`` is held to."""
    mo = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    t = xf.shape[0]
    logits = xf.to(torch.float32) @ p["router"]
    sel = logits + p["router_bias"] if "router_bias" in p else logits
    picks, masked = [], sel.clone()
    for _ in range(mo.top_k):
        j = torch.argmax(masked, dim=-1)
        picks.append(j)
        masked[torch.arange(t, device=x.device), j] = -torch.inf
    experts = torch.stack(picks, 1)
    gates = torch.softmax(torch.gather(logits, 1, experts), dim=-1)
    cap = moe_capacity(t, mo)
    out = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    flat_e, flat_g = experts.reshape(-1), gates.reshape(-1)
    for e in range(mo.n_experts):
        fidx = torch.nonzero(flat_e == e)[:, 0][:cap]
        if fidx.numel() == 0:
            continue
        tok = fidx // mo.top_k
        y = swiglu_fwd({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                        "w_down": p["w_down"][e]}, xf[tok])
        out.index_add_(0, tok, y.to(torch.float32) * flat_g[fidx, None])
    out = out.to(x.dtype)
    if "shared" in p:
        out = out + swiglu_fwd(p["shared"], xf)
    return out.reshape(b, s, d)


def moe_aux_loss(p: Mapping[str, Any], x: Tensor, cfg) -> Tensor:
    """Load-balancing auxiliary loss (Switch-style), a 0-d float32 tensor:
    E x sum over experts of (share of the top-k assignments) x (mean
    router probability). The top-k is of the unbiased logits, as in the
    reference. Nothing on the training path adds it to the loss, as in
    the reference."""
    mo = cfg.moe
    t = x.shape[0] * x.shape[1]
    logits = (x.to(torch.float32) @ p["router"]).reshape(t, mo.n_experts)
    probs = torch.softmax(logits, dim=-1)
    experts = top_k_ids(logits, mo.top_k)
    counts = torch.zeros((mo.n_experts,), dtype=torch.float32,
                         device=x.device).index_add_(
        0, experts.reshape(-1), torch.ones(t * mo.top_k, device=x.device))
    frac_tokens = counts / (t * mo.top_k)
    return mo.n_experts * torch.sum(frac_tokens * probs.mean(0))


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------

def init_rglru_block(gen, cfg, dtype, device=None) -> dict[str, Tensor]:
    """The reference's names, shapes and dtypes: ``lam`` [d] float32 from
    u ~ U(0.9, 0.999) (``log(u^(1/8) / (1 - u^(1/8)))``), ``b_a`` and
    ``b_i`` float32 zeros, the weights in ``dtype``."""
    d = cfg.d_model
    dr = d  # lru width = d_model in RecurrentGemma-2B
    c = 8.0
    u = torch.rand((dr,), generator=gen, dtype=torch.float32,
                   device=device) * (0.999 - 0.9) + 0.9
    lam = torch.log(u ** (1 / c) / (1 - u ** (1 / c)))
    return {
        "w_x": _dense_init(gen, (d, dr), None, dtype, device),   # linear
        "w_y": _dense_init(gen, (d, dr), None, dtype, device),   # gate
        "conv_w": _dense_init(gen, (4, dr), 0.5, dtype, device),
        "lam": lam,
        "w_a": _dense_init(gen, (dr, dr), 0.02, dtype, device),
        "b_a": torch.zeros((dr,), dtype=torch.float32, device=device),
        "w_i": _dense_init(gen, (dr, dr), 0.02, dtype, device),
        "b_i": torch.zeros((dr,), dtype=torch.float32, device=device),
        "w_out": _dense_init(gen, (dr, d), None, dtype, device),
    }


def _rglru_scan(xt: Tensor, a_t: Tensor, h0: Tensor) -> tuple[Tensor, Tensor]:
    """The linear recurrence h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2,
    1e-12)) x_t from ``h0``: xt, a_t [B, S, D] float32, h0 [B, D] ->
    (h [B, S, D], h [:, -1]). The reference's associative scan, as a
    doubling (Hillis-Steele) scan of the pairs (a, b) over log2(S) steps
    of plain tensor operations that autograd differentiates: the prefix
    products of the a's are only multiplied, so they underflow to 0 (a
    sum of logs would overflow its exp). Then h0 enters through the
    prefix products, as there. One token is one multiply-add."""
    b = torch.sqrt(torch.clamp(1.0 - a_t * a_t, min=1e-12)) * xt
    a = a_t
    s, k = xt.shape[1], 1
    while k < s:
        # combine(c1, c2) = (a1 a2, a2 b1 + b2), c1 the earlier k steps
        b = torch.cat([b[:, :k], a[:, k:] * b[:, :-k] + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    h = b + a * h0[:, None, :]
    return h, h[:, -1, :]


def rglru_block_fwd(p: Mapping[str, Tensor], x: Tensor, cfg, *,
                    cache: Cache | None = None, shard=NO_SHARD
                    ) -> tuple[Tensor, Cache | None]:
    """Griffin recurrent block: (conv1d -> RG-LRU) branch gated by a GELU
    (tanh) branch. ``cache`` = ``{"h" [B, D] float32, "conv" [B, 3, D]}``
    for decode; the new one holds the last state and the last 3 rows of
    the conv's padded input (x's dtype), as new tensors. The decay is the
    reference's ``log a_t = -8 r_t softplus(lam)`` (Griffin's is
    ``softplus(-lam)``; the port keeps the reference's sign)."""
    b, s, d = x.shape
    xb = x @ p["w_x"]
    yb = F.gelu(x @ p["w_y"], approximate="tanh")

    # depthwise causal conv, kernel 4, summed in the reference's order
    if cache is None:
        prev = xb.new_zeros((b, 3, xb.shape[-1]))
    else:
        prev = cache["conv"].to(xb.dtype)
    xpad = torch.cat([prev, xb], dim=1)
    conv = xpad[:, 0:s] * p["conv_w"][0]
    for i in range(1, 4):
        conv = conv + xpad[:, i:i + s] * p["conv_w"][i]
    new_conv = xpad[:, -3:, :]

    cf = conv.to(torch.float32)
    r = torch.sigmoid(cf @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(cf @ p["w_i"].to(torch.float32) + p["b_i"])
    lam = p["lam"]
    log_a = -8.0 * r * torch.logaddexp(lam, torch.zeros_like(lam))
    a_t = torch.exp(log_a)
    gated_x = i * cf
    h0 = (cf.new_zeros((b, xb.shape[-1])) if cache is None
          else cache["h"].to(torch.float32))
    h, h_last = _rglru_scan(gated_x, a_t, h0)
    h = shard(h.to(x.dtype), "act_ffn")

    out = (h * yb) @ p["w_out"]
    new_cache = None if cache is None else {"h": h_last, "conv": new_conv}
    return shard(out, "act_resid"), new_cache


# ---------------------------------------------------------------------------
# RWKV-6 (Finch): data-dependent decay time-mix + channel-mix
# ---------------------------------------------------------------------------

_LOG_DECAY_CLAMP = 5.0   # per-step |log w| cap, as the reference's: keeps
                         # every exponent difference inside a chunk within
                         # float32 range (16 * 5 = 80 < log(f32 max) ~ 88.7)
RWKV_CHUNK = 16          # chunk length of the chunked-parallel core, the
                         # reference's default


def init_rwkv6(gen, cfg, dtype, device=None) -> dict[str, Any]:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    n_h = d // hd
    lora = 64
    f32 = torch.float32
    return {
        "maa": 0.5 * torch.ones((5, d), dtype=f32, device=device),  # r,k,v,w,g
        "w0": torch.full((d,), -6.0, dtype=f32, device=device),     # decay base
        "w1": _dense_init(gen, (d, lora), 0.02, f32, device),
        "w2": _dense_init(gen, (lora, d), 0.02, f32, device),
        "u": torch.zeros((n_h, hd), dtype=f32, device=device),      # bonus
        "wr": _dense_init(gen, (d, d), None, dtype, device),
        "wk": _dense_init(gen, (d, d), None, dtype, device),
        "wv": _dense_init(gen, (d, d), None, dtype, device),
        "wg": _dense_init(gen, (d, d), None, dtype, device),
        "wo": _dense_init(gen, (d, d), None, dtype, device),
        "ln_x": init_layernorm(d, f32, device),                     # group-norm-ish
    }


def _token_shift(x: Tensor, cache: Cache | None) -> Tensor:
    """``x`` shifted one step back along S, the cached last token (or 0)
    in front, minus ``x``."""
    b, _s, d = x.shape
    if cache is None:
        x_prev = x.new_zeros((b, 1, d))
    else:
        x_prev = cache["x_prev"][:, None, :].to(x.dtype)
    return torch.cat([x_prev, x[:, :-1, :]], dim=1) - x


def _chunked_core_local(r, k, v, w, u, state0, chunk: int):
    """:func:`rwkv_chunked_core` of DTensors: every (batch, head) pair
    recurs alone, so each rank runs the plain core on its own shard, the
    batch and head dims kept sharded as ``r`` has them and the sequence and
    head width made whole (DTensor's own einsums over the chunked layout
    mis-size their local views). Differentiable: ``to_local`` and
    ``from_local``."""
    from torch.distributed.tensor import DTensor, Partial, Shard

    mesh = r.device_mesh
    pl, u_pl, s_pl = per_head_placements(r.placements)
    r, k, v, w = (replicated_as(x, r).redistribute(mesh, pl)
                  for x in (r, k, v, w))
    u = replicated_as(u, r).redistribute(mesh, u_pl)
    state0 = replicated_as(state0, r).redistribute(mesh, s_pl)
    # u is shared by the batch: on a mesh dim that splits the batch, each
    # rank's gradient of u is a partial sum
    u_grad = [Partial() if isinstance(p, Shard) and p.dim == 0 else q
              for p, q in zip(pl, u_pl)]
    out, state = rwkv_chunked_core(r.to_local(), k.to_local(), v.to_local(),
                                   w.to_local(),
                                   u.to_local(grad_placements=u_grad),
                                   state0.to_local(), chunk)
    out, state = out.contiguous(), state.contiguous()
    b, s, h, hd = r.shape
    return (DTensor.from_local(out, mesh, pl, run_check=False,
                               shape=(b, s, h, hd),
                               stride=(s * h * hd, h * hd, hd, 1)),
            DTensor.from_local(state, mesh, s_pl, run_check=False,
                               shape=(b, h, hd, hd),
                               stride=(h * hd * hd, hd * hd, hd, 1)))


def rwkv_chunked_core(r: Tensor, k: Tensor, v: Tensor, w: Tensor,
                      u: Tensor, state0: Tensor, chunk: int = RWKV_CHUNK
                      ) -> tuple[Tensor, Tensor]:
    """The reference's chunked-parallel form of the recurrence
    (``_rwkv_chunked_core``), the same math as ``rwkv_scan`` in plain
    tensor operations, so that autograd differentiates it. Within a chunk,
    with A_t = prod_{j<=t} w_j,

        out_t = r_t diag(A_{t-1}) S_0
              + sum_{i<t} r_t diag(A_{t-1}/A_i) k_i^T v_i
              + (r_t . u k_t) v_t.

    S is padded to a multiple of ``chunk`` (r, k, v with 0, w with 1, so
    the state passes the padding unchanged). The intra-chunk and bonus
    terms of all chunks are batched einsums; only the carried state is a
    loop over the chunks, each chunk's increment computed for all chunks
    at once. r/k/v/w [B, S, H, hd] float32, u [H, hd], state0
    [B, H, hd, hd] -> (out [B, S, H, hd], state_T). On DTensors it runs
    shard by shard (:func:`_chunked_core_local`)."""
    from torch.distributed.tensor import DTensor

    if isinstance(r, DTensor):
        return _chunked_core_local(r, k, v, w, u, state0, chunk)
    b, s, h, hd = r.shape
    pad = (-s) % chunk
    if pad:
        z = (0, 0, 0, 0, 0, pad)
        r, k, v = F.pad(r, z), F.pad(k, z), F.pad(v, z)
        w = F.pad(w, z, value=1.0)
    n_c = (s + pad) // chunk

    def resh(t):                                     # [N, B, C, H, hd]
        return t.reshape(b, n_c, chunk, h, hd).transpose(0, 1)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(w)
    lw = torch.log(torch.clamp(wc, min=1e-38))       # <= 0
    la = torch.cumsum(lw, dim=2)                     # inclusive
    la_ex = la - lw                                  # exclusive
    la_c = la[:, :, -1:]                             # the chunk's total decay
    mask = (torch.arange(chunk, device=r.device)[:, None]
            > torch.arange(chunk, device=r.device)[None, :])

    rr = rc * torch.exp(la_ex)                       # <= |r|, safe
    kk_neg = kc * torch.exp(-la)                     # bounded by the clamp
    # intra-chunk (strictly causal)
    scores = torch.einsum("nbthk,nbihk->nbhti", rr, kk_neg)
    scores = torch.where(mask, scores, scores.new_zeros(()))
    intra = torch.einsum("nbhti,nbihv->nbthv", scores, vc)
    # diagonal bonus term
    bonus = torch.einsum("nbchk,nbchk->nbch", rc, u * kc)
    # each chunk's state increment and decay, then the carried state
    k_dec = kc * torch.exp(la_c - la)
    incr = torch.einsum("nbihk,nbihv->nbhkv", k_dec, vc)
    decay = torch.exp(la_c[:, :, 0])[..., None]      # [N, B, H, hd, 1]
    states, state = [], state0
    for n in range(n_c):
        states.append(state)
        state = state * decay[n] + incr[n]
    # inter-chunk: the decayed state at the chunk's start
    out = torch.einsum("nbchk,nbhkv->nbchv", rr, torch.stack(states))
    out = out + intra + bonus[..., None] * vc
    out = out.transpose(0, 1).reshape(b, s + pad, h, hd)
    return out[:, :s], state


def _needs_grad(*ts: Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rwkv6_timemix_fwd(p: Mapping[str, Any], x: Tensor, cfg, *,
                      cache: Cache | None = None, shard=NO_SHARD
                      ) -> tuple[Tensor, Cache | None]:
    """RWKV-6 time mix. State S [B, H, hd, hd]; recurrence
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ; out_t = r_t (S_{t-1} + u k_t^T v_t).

    Where autograd needs a gradient of the recurrence's inputs (training),
    it runs :func:`rwkv_chunked_core`; otherwise (prefill and decode in
    serving) :func:`kernels.rwkv_scan.rwkv_scan`, which has no backward.
    The reference takes its chunked core for every S > 1, prefill
    included, and its sequential scan for S = 1; the two cores are the
    same math, held together by ``tests/test_torch_models.py``
    (``test_forward_logits_matches_reference`` against both of the
    reference's cores) and ``tests/test_torch_train.py``."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    n_h = d // hd

    if cache is None:
        state0 = torch.zeros((b, n_h, hd, hd), dtype=torch.float32,
                             device=x.device)
    else:
        state0 = cache["state"]
    diff = _token_shift(x, cache)

    def mix(i):
        return x + diff * p["maa"][i].to(x.dtype)

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = reshape(xr @ p["wr"], b, s, n_h, hd)
    k = reshape(xk @ p["wk"], b, s, n_h, hd)
    v = reshape(xv @ p["wv"], b, s, n_h, hd)
    g = F.silu(xg @ p["wg"])
    wf = xw.to(torch.float32)
    w = p["w0"] + torch.tanh(wf @ p["w1"]) @ p["w2"]           # [B,S,d]
    w = torch.exp(-torch.clamp(torch.exp(w), 0.0, _LOG_DECAY_CLAMP))
    w = reshape(w, b, s, n_h, hd)                            # decay in (0,1)

    u = p["u"]
    if _needs_grad(r, k, v, w, u, state0):
        out, state_last = rwkv_chunked_core(
            r.to(torch.float32), k.to(torch.float32), v.to(torch.float32),
            w.to(torch.float32), u, state0)
    else:
        out, state_last = rwkv_scan(r, k, v, w, u, state0)
    out = out.reshape(b, s, d)
    out = layernorm(out, p["ln_x"], 1e-5).to(x.dtype) * g.to(x.dtype)
    out = out @ p["wo"]
    new_cache = None
    if cache is not None:
        new_cache = {"x_prev": x[:, -1, :].clone(), "state": state_last}
    return shard(out, "act_resid"), new_cache


def init_rwkv6_channelmix(gen, cfg, dtype, device=None) -> dict[str, Tensor]:
    d, ff = cfg.d_model, cfg.d_ff
    f32 = torch.float32
    return {
        "maa_k": 0.5 * torch.ones((d,), dtype=f32, device=device),
        "maa_r": 0.5 * torch.ones((d,), dtype=f32, device=device),
        "wk": _dense_init(gen, (d, ff), None, dtype, device),
        "wv": _dense_init(gen, (ff, d), None, dtype, device),
        "wr": _dense_init(gen, (d, d), None, dtype, device),
    }


def rwkv6_channelmix_fwd(p: Mapping[str, Any], x: Tensor, cfg, *,
                         cache: Cache | None = None, shard=NO_SHARD
                         ) -> tuple[Tensor, Cache | None]:
    diff = _token_shift(x, cache)
    xk = x + diff * p["maa_k"].to(x.dtype)
    xr = x + diff * p["maa_r"].to(x.dtype)
    h = shard(torch.square(F.relu(pin(shard, xk @ p["wk"], "act_ffn"))),
              "act_ffn")
    kv = h @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    new_cache = None if cache is None else {"x_prev": x[:, -1, :].clone()}
    return shard(rr * kv, "act_resid"), new_cache


class _Params(nn.Module):
    """A module whose parameters are also read by name (``p["wr"]``), so
    that the functional forwards above take it as they take a dict."""

    def __init__(self, tensors: Mapping[str, Any]):
        super().__init__()
        for name, t in tensors.items():
            if isinstance(t, Mapping):
                setattr(self, name, param_dict(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class RWKV6TimeMix(_Params):
    """The time mix's parameters (:func:`init_rwkv6`); ``forward(x, cache)``
    is :func:`rwkv6_timemix_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_rwkv6(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, cache: Cache | None = None):
        return rwkv6_timemix_fwd(self, x, self.cfg, cache=cache)


class RWKV6ChannelMix(_Params):
    """The channel mix's parameters (:func:`init_rwkv6_channelmix`);
    ``forward(x, cache)`` is :func:`rwkv6_channelmix_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_rwkv6_channelmix(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, cache: Cache | None = None):
        return rwkv6_channelmix_fwd(self, x, self.cfg, cache=cache)


class Attention(_Params):
    """Attention's parameters (:func:`init_attention`: ``wq``, ``wk``,
    ``wv``, ``wo``, and ``bq``/``bk``/``bv`` with ``cfg.attn_bias``);
    ``forward(x, pos, cache, window)`` is :func:`attention_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_attention(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, pos: Tensor | None = None,
                cache: Cache | None = None, window: int | None = None):
        return attention_fwd(self, x, self.cfg, pos=pos, cache=cache,
                             window=window)


class MLA(_Params):
    """MLA's parameters (:func:`init_mla`: ``q_a``, ``q_norm``, ``q_b``,
    ``kv_a``, ``kv_norm``, ``kv_b``, ``wo``; the two norms nested, as
    ``q_norm.scale``); ``forward(x, pos, cache)`` is :func:`mla_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_mla(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, pos: Tensor | None = None,
                cache: Cache | None = None):
        return mla_fwd(self, x, self.cfg, pos=pos, cache=cache)


class SwiGLU(_Params):
    """The SwiGLU MLP's parameters (:func:`init_swiglu`); ``forward(x)`` is
    :func:`swiglu_fwd`."""

    def __init__(self, d: int, ff: int, dtype=torch.float32, *,
                 generator=None, device=None):
        super().__init__(init_swiglu(generator, d, ff, dtype, device))

    def forward(self, x: Tensor) -> Tensor:
        return swiglu_fwd(self, x)


class MoE(_Params):
    """The MoE feed-forward's parameters (:func:`init_moe`: ``router`` [d,
    E] float32, ``w_gate``/``w_up`` [E, d, ff], ``w_down`` [E, ff, d],
    ``router_bias`` [E] float32 with ``router_aux_free``, the ``shared``
    SwiGLU nested, as ``shared.w_gate``, with ``n_shared``);
    ``forward(x)`` is :func:`moe_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_moe(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor) -> Tensor:
        return moe_fwd(self, x, self.cfg)


class GeluMLP(_Params):
    """The GELU MLP's parameters (:func:`init_gelu_mlp`); ``forward(x)`` is
    :func:`gelu_mlp_fwd`."""

    def __init__(self, d: int, ff: int, dtype=torch.float32, *,
                 generator=None, device=None):
        super().__init__(init_gelu_mlp(generator, d, ff, dtype, device))

    def forward(self, x: Tensor) -> Tensor:
        return gelu_mlp_fwd(self, x)


class RGLRU(_Params):
    """The RG-LRU block's parameters (:func:`init_rglru_block`: ``w_x``,
    ``w_y``, ``conv_w``, ``lam``, ``w_a``, ``b_a``, ``w_i``, ``b_i``,
    ``w_out``); ``forward(x, cache)`` is :func:`rglru_block_fwd`."""

    def __init__(self, cfg, dtype=torch.float32, *, generator=None,
                 device=None):
        super().__init__(init_rglru_block(generator, cfg, dtype, device))
        self.cfg = cfg

    def forward(self, x: Tensor, cache: Cache | None = None):
        return rglru_block_fwd(self, x, self.cfg, cache=cache)
