"""Logical-axis sharding rules -> partition specs (the port of
``src/repro/sharding/rules.py``).

Scheme (MaxText-style 2-D: "data" doubles as the FSDP axis, "model" is the
tensor/expert-parallel axis, "pod", when present, is pure data
parallelism):

  params: weight matrices shard (input dim -> "data", output/head/expert
          dim -> "model") wherever the dim divides the axis; everything
          else replicates. Optimizer moments inherit the parameter's spec
          (ZeRO-style sharded optimizer state).
  activations: batch -> ("pod", "data"); heads/ffn/vocab -> "model";
          a constraint applies only where the shapes divide.

A spec is a :class:`P`, one entry per tensor dimension: a mesh axis name,
a tuple of names (split major to minor), or None. The rules read only a
mesh's axis names and sizes (:func:`mesh_shape`): a
``torch.distributed.device_mesh.DeviceMesh``, a mapping of axis name to
size, or an object whose ``shape`` is such a mapping. :func:`placements`
turns a spec into DTensor placements on a ``DeviceMesh``.

Deliberate deviation: the reference stacks each period's layers on a
leading axis and matches a rule by leaf name and trailing rank, highest
rank first, so a stacked rank-2 weight can take a rank-3 rule of the same
name and put a mesh axis on the layer dimension (rwkv's ``wk``/``wv``/
``wo`` take the attention rules; a dense ``w_gate``/``w_up``/``w_down``
takes the MoE rule when the layer count divides the model axis). The
port holds one tensor per layer and applies the rules to each layer's own
shape, which is what the table means.
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: one entry per tensor dimension (an axis name, a
    tuple of axis names, or None). Prints as JAX's ``PartitionSpec`` and
    compares with trailing Nones stripped (``P("data", None) ==
    P("data")``)."""

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as JAX canonicalises it
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def normalized(self) -> tuple:
        n = len(self)
        while n and self[n - 1] is None:
            n -= 1
        return tuple(self[:n])

    def __eq__(self, other):
        if not isinstance(other, tuple):
            return NotImplemented
        other = other.normalized() if isinstance(other, P) else P(
            *other).normalized()
        return self.normalized() == other

    def __ne__(self, other):
        eq = self.__eq__(other)
        return eq if eq is NotImplemented else not eq

    def __hash__(self):
        return hash(self.normalized())

    def __repr__(self):
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"


# leaf-name -> trailing-dims logical roles
#   i = input dim ("data"), o = output dim ("model"), e = experts ("model"),
#   h = heads ("model"), . = replicated
_PARAM_RULES: dict[tuple[str, int], Any] = {
    ("embed", 2): "oi",       # [vocab->model, d->data]
    ("unembed", 2): "io",     # [d->data, vocab->model]
    ("wq", 3): "ih.",
    ("wk", 3): "ih.",
    ("wv", 3): "ih.",
    ("wo", 3): "h.i",
    ("w_gate", 2): "io",
    ("w_up", 2): "io",
    ("w_down", 2): "oi",
    # MoE [E, d, ff]: expert-parallel when E divides the model axis;
    # otherwise fall back to tensor-parallel on ff (e.g. grok-1's 8 experts
    # under a 16-way model axis)
    ("w_gate", 3): ("ei.", ".io"),
    ("w_up", 3): ("ei.", ".io"),
    ("w_down", 3): ("e.i", ".oi"),
    ("router", 2): "i.",
    ("q_a", 2): "i.",
    ("q_b", 3): ".h.",
    ("kv_a", 2): "i.",
    ("kv_b", 3): ".h.",
    ("w_x", 2): "io",
    ("w_y", 2): "io",
    ("w_out", 2): "oi",
    ("w_a", 2): ".o",
    ("w_i", 2): ".o",
    ("conv_w", 2): ".o",
    ("wr", 2): "io",
    ("wk", 2): "io",
    ("wv", 2): "io",
    ("wg", 2): "io",
    ("wo", 2): "oi",
    ("w1", 2): "i.",
    ("w2", 2): ".i",
    ("proj", 2): "i.",
}

_ROLE_AXIS = {"i": "data", "o": "model", "h": "model", "e": "model",
              ".": None}


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of ``mesh``: a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``shape``), a mapping, or an object whose
    ``shape`` is a mapping (a JAX ``Mesh``, a stand-in)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(k): int(v) for k, v in shape.items()}
    raise TypeError(f"not a named mesh: {mesh!r} (a DeviceMesh with "
                    "mesh_dim_names, or a mapping of axis name to size)")


def _axis_size(axes: Mapping[str, int], name: str | None) -> int:
    if name is None or name not in axes:
        return 1
    return axes[name]


def _leaf(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def param_pspec(name: str, shape, mesh, profile: str = "train") -> P:
    """The spec of the parameter ``name`` (its leaf, the last component of
    a dotted name, picks the rule) of ``shape`` (one layer's own).

    ``profile="train"``: FSDP("data") x TP("model"), memory-optimal.
    ``profile="serve"``: weights replicated over "data" (each data row is
    an independent replica serving its own batch shard), TP("model")
    only. Of a rule's alternatives the one that shards the most dimensions
    wins, the first on a tie."""
    axes = mesh_shape(mesh)
    leaf = _leaf(name)
    shape = tuple(int(s) for s in shape)
    nd = len(shape)
    for trail in range(nd, 0, -1):
        rules = _PARAM_RULES.get((leaf, trail))
        if rules is None:
            continue
        if isinstance(rules, str):
            rules = (rules,)
        best, best_score = None, -1
        for rule in rules:
            specs: list[str | None] = [None] * (nd - trail)
            score = 0
            for dim_sz, role in zip(shape[nd - trail:], rule):
                ax = _ROLE_AXIS[role]
                if profile == "serve" and ax == "data":
                    ax = None
                if ax is not None and (ax not in axes
                                       or dim_sz % _axis_size(axes, ax)):
                    ax = None
                if ax is not None:
                    score += 1
                specs.append(ax)
            if score > best_score:
                best, best_score = P(*specs), score
        return best
    return P()


def _named_shapes(params) -> dict[str, tuple]:
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: tuple(getattr(t, "shape", t)) for name, t in params.items()}


def param_pspecs(params, mesh, profile: str = "train") -> dict[str, P]:
    """``{name: spec}`` of a model (``LM.named_parameters()`` names) or of a
    mapping of name to tensor or shape."""
    return {name: param_pspec(name, shape, mesh, profile)
            for name, shape in _named_shapes(params).items()}


def _scale_spec(param_name: str, shape, axes: Mapping[str, int]) -> P:
    """A quantized moment's ``scale`` (the parameter's shape with the last
    axis cut to its block count): the parameter's rule on that shape, its
    last axis replicated where the block count stops dividing."""
    spec = param_pspec(param_name, shape, axes)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    if dims and dims[-1] is not None:
        names = dims[-1] if isinstance(dims[-1], tuple) else (dims[-1],)
        if shape[-1] % math.prod(axes[a] for a in names):
            dims[-1] = None
    return P(*dims)


def opt_pspecs(opt_state: Mapping[str, Any], mesh) -> dict[str, Any]:
    """Specs of the port's optimizer state (``{"step", "m", "v"}``, each
    moment ``{name: tensor}`` or ``{name: {"code", "scale"}}``), as the
    reference names its leaves: a moment takes its parameter's spec, an
    int8 ``code`` (the parameter's shape, the last axis padded) the
    parameter's rule on its own shape, a ``scale`` :func:`_scale_spec`.
    The reference reads a leaf's name from the last key of its path, so a
    float32 moment of a parameter whose leaf is ``scale`` (a norm's) goes
    down the scale branch under the name of the norm; the port does the
    same, which replicates it as before."""
    axes = mesh_shape(mesh)

    def moment(name: str, m):
        if isinstance(m, Mapping):
            return {"code": param_pspec(name, m["code"].shape, axes),
                    "scale": _scale_spec(name, tuple(m["scale"].shape),
                                         axes)}
        if _leaf(name) == "scale":
            parent = name.rsplit(".", 1)[0] if "." in name else ""
            return _scale_spec(parent, tuple(m.shape), axes)
        return param_pspec(name, m.shape, axes)

    out: dict[str, Any] = {"step": P()}
    for key in ("m", "v"):
        out[key] = {name: moment(name, m)
                    for name, m in opt_state[key].items()}
    return out


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``: for
    each mesh dimension, ``Shard(d)`` where tensor dim ``d``'s entry names
    it, else ``Replicate()``. A tuple of axes on one tensor dim becomes
    ``Shard(d)`` on each of those mesh dims; DTensor splits them in mesh
    order, major to minor, as JAX splits the tuple, so the tuple must name
    them in mesh order (ValueError otherwise)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    by_axis: dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: the axes {group} of dim {d} "
                             f"are not in the mesh's order {names}")
        for a in group:
            if a in by_axis:
                raise ValueError(f"spec {spec!r} names axis {a!r} twice")
            by_axis[a] = d
    return tuple(Shard(by_axis[n]) if n in by_axis else Replicate()
                 for n in names)


def place_tree(tree: Any, mesh, specs: Any) -> Any:
    """A tree (dicts, lists, tuples) of tensors that every rank holds whole
    and alike, as DTensors on ``mesh`` placed by ``specs`` (the same tree
    of :class:`P`): each rank keeps its own shard of its own copy, so no
    collective runs (``distribute_tensor(..., src_data_rank=None)``); it
    works on the meta device. A non-tensor leaf stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, Mapping):
        return {k: place_tree(v, mesh, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, mesh, s) for v, s in zip(tree, specs))
    if not isinstance(tree, Tensor):
        return tree
    return distribute_tensor(tree.detach(), mesh, placements(specs, mesh),
                             src_data_rank=None)


def place_parameters(model: torch.nn.Module, mesh,
                     specs: Mapping[str, P]) -> torch.nn.Module:
    """``model``'s parameters replaced in place by DTensors on ``mesh``
    placed by ``specs`` (by parameter name, as :func:`param_pspecs` names
    them), as :func:`place_tree` places them; ``requires_grad`` kept.
    Returns ``model``, whose steps then run sharded
    (``train.make_train_step(..., shard=make_shard_fn(mesh))``)."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(
            place_tree(p, mesh, specs[name]), requires_grad=p.requires_grad))
    return model


# -- activations -------------------------------------------------------------

def batch_axes(mesh) -> tuple[str, ...]:
    axes = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def batch_pspec(mesh, batch_size: int, extra_dims: int = 1) -> P:
    """Spec for a [B, ...] batch tensor; shards B over pod+data if it
    divides."""
    axes = mesh_shape(mesh)
    baxes = batch_axes(axes)
    n = math.prod(axes[a] for a in baxes)
    if baxes and batch_size % n == 0:
        return P(baxes, *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


def make_shard_fn(mesh):
    """The activation-constraint callable that the models take as
    ``shard``: ``shard(x, name)`` returns a plain tensor as it is, and
    redistributes a DTensor, and in the backward its gradient
    (:class:`_Constrain`), to the placements of the spec that ``name``
    and ``x``'s shape select (``shard.spec(shape, name)``, None where no
    rule applies, which leaves ``x`` as it is). ``shard.pin`` does the same
    where the models pin a layout the reference leaves to XLA
    (``models.layers.pin``). ``shard.model_size`` is the model axis' size,
    which lets attention pick the kv-replicated branch."""
    axes = mesh_shape(mesh)
    baxes = batch_axes(axes)
    n_b = math.prod(axes[a] for a in baxes)
    n_m = _axis_size(axes, "model")

    def maybe_b(sz):
        return baxes if baxes and sz % n_b == 0 else None

    def maybe_m(sz):
        return "model" if "model" in axes and sz % n_m == 0 else None

    def spec(shape, name: str) -> P | None:
        s = tuple(shape)
        nd = len(s)
        if name == "act_resid" and nd == 3:
            return P(maybe_b(s[0]), None, None)
        if name == "act_heads" and nd == 4:
            return P(maybe_b(s[0]), None, maybe_m(s[2]), None)
        if name == "act_ffn" and nd == 3:
            return P(maybe_b(s[0]), None, maybe_m(s[2]))
        if name == "attn_logits" and nd == 5:
            return P(maybe_b(s[0]), maybe_m(s[1]), None, None, None)
        if name == "attn_logits4" and nd == 4:
            # kv-replicated GQA: [B, H, Sq, Sk] shards fully on q heads
            return P(maybe_b(s[0]), maybe_m(s[1]), None, None)
        if name == "logits" and nd == 3:
            return P(maybe_b(s[0]), None, maybe_m(s[2]))
        if name == "logits_last" and nd == 2:
            return P(maybe_b(s[0]), maybe_m(s[1]))
        if name in ("moe_dispatch", "moe_ffn") and nd == 3:
            return P(maybe_m(s[0]), None, None)       # experts on model
        return None

    def shard(x: Tensor, name: str) -> Tensor:
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            return x
        sp = spec(x.shape, name)
        if sp is None:
            return x
        return _Constrain.apply(x, placements(sp, x.device_mesh))

    shard.spec = spec
    shard.pin = shard
    shard.model_size = n_m
    return shard


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to ``placements``, its gradient too, as
    ``jax.lax.with_sharding_constraint`` constrains the cotangent: without
    it the gradient keeps whatever placement DTensor's backward picks (on
    a three-axis mesh a [B, S, ff] gradient came back with S on "model",
    whose flattening for the weight's gradient took minutes of sharding
    propagation)."""

    @staticmethod
    def forward(ctx, x, pl):
        ctx.pl = pl
        return x.redistribute(x.device_mesh, pl)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.pl), None


def cache_pspecs(cache, mesh, batch: int) -> list:
    """Specs of the port's decode cache (one dict per layer): batch over
    pod+data where it divides (the first dim equal to ``batch``); KV heads
    on model where they divide, else the sequence dim (split-KV: a kv-head
    count that does not divide the model axis, GQA kv=8 under 16, would
    replicate 32k x batch caches across it); MLA's latent and shared rope
    key on the sequence dim; rwkv's state on its heads. A host-int
    ``length`` takes no spec (None)."""
    axes = mesh_shape(mesh)
    baxes = batch_axes(axes)
    n_b = math.prod(axes[a] for a in baxes)
    n_m = _axis_size(axes, "model")
    has_m = "model" in axes

    def spec_for(name: str, t) -> P | None:
        if not isinstance(t, Tensor):
            return None
        shape, nd = tuple(t.shape), t.dim()
        dims: list[Any] = [None] * nd
        for i, sz in enumerate(shape):
            if sz == batch and batch % n_b == 0 and baxes:
                dims[i] = baxes
                break
        if name in ("k", "v") and nd >= 3 and has_m:
            if shape[-2] % n_m == 0:
                dims[-2] = "model"              # KV heads on model
            elif shape[-3] % n_m == 0:
                dims[-3] = "model"              # split-KV: sequence
        if name == "latent" and nd >= 2 and has_m and shape[-2] % n_m == 0:
            dims[-2] = "model"                  # MLA latent: seq on model
        if name == "k_rope" and nd >= 3 and has_m and shape[-3] % n_m == 0:
            dims[-3] = "model"
        if name == "state" and nd >= 3 and has_m and shape[-3] % n_m == 0:
            dims[-3] = "model"                  # rwkv [.., H, hd, hd]
        return P(*dims)

    def walk(name: str, node):
        if isinstance(node, Mapping):
            return {k: walk(k, v) for k, v in node.items()}
        return spec_for(name, node)

    return [walk("", layer) for layer in cache]


__all__ = ["P", "mesh_shape", "param_pspec", "param_pspecs", "opt_pspecs",
           "placements", "place_tree", "place_parameters", "batch_axes",
           "batch_pspec", "make_shard_fn", "cache_pspecs"]
