"""The ``shard`` argument threaded through the port's models, against the
JAX reference's, at smoke sizes.

- ``_sdpa``'s kv-replicated branch (``expand``: the kv heads repeated to H
  when ``shard.model_size`` divides the q heads but not the kv heads):
  against the reference's branch on the same inputs within 1e-6 of scale
  (max |got - want| <= 1e-6 x max(1, max |want|)), causal, windowed,
  non-causal and with a ring buffer's ``kpos``; and against the port's
  grouped branch, the same function, within 1e-6 of scale;
- every model kind (``rwkv``, dense attention, MLA, M-RoPE with the vision
  stub, MoE, DeepSeek-V3's MLA + MoE + multi-token head, RG-LRU with
  local attention, the Whisper encoder-decoder) under a recording
  ``shard``: a forward (``forward_logits``, or the prefill step for
  M-RoPE), one decode step and a train step of 2 microbatches (remat off,
  as the reference's remat replays no Python) make the same sequence of
  (name, shape) calls as the reference's under the same recorder (the
  reference traced by ``jax.eval_shape`` with ``jax.lax.scan`` and
  ``jax.lax.map`` monkeypatched to Python loops, so that its layer scans
  call the recorder layer by layer, as under ``jax.disable_jit``, without
  computing); and the port's outputs under the recorder are bitwise
  those under ``NO_SHARD``;
- a recorder carrying ``model_size`` on a GQA model (kv-replicated
  attention, a ring buffer's too): the same call sequence as the
  reference's (``attn_logits4``), outputs within 1e-5 of scale of the
  grouped branch's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as JL
import repro.models.model as JM
from repro.configs import smoke_config as j_smoke
from repro.models.config import get_config as j_get
from repro.train import optimizer as JO
from repro.train.serve_step import make_prefill_step as j_prefill
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO
from repro_torch.train.serve_step import make_prefill_step
from repro_torch.train.train_step import make_train_step

SDPA_RTOL = 1e-6
EXPAND_RTOL = 1e-5
B, S, N_MICRO = 2, 8, 2
KINDS = {"rwkv": "rwkv6-7b", "dense": "lm-100m", "mla": "minicpm3-4b",
         "mrope": "qwen2-vl-7b", "moe": "grok-1-314b",
         "mla_moe_mtp": "deepseek-v3-671b", "rglru": "recurrentgemma-2b",
         "enc_dec": "whisper-tiny"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (many small tensor
    operations; the test workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _loop_scans(monkeypatch):
    """``jax.lax.scan`` and ``jax.lax.map`` as Python loops over the
    leading axis (what they do under ``jax.disable_jit``), so that a
    traced reference calls its layers' ``shard`` once per layer."""
    def scan(f, init, xs, length=None, **_kw):
        n = jax.tree.leaves(xs)[0].shape[0] if xs is not None else length
        carry, ys = init, []
        for i in range(n):
            carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
            ys.append(y)
        if all(y is None for y in ys):
            return carry, None
        return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)

    monkeypatch.setattr(jax.lax, "scan", scan)
    monkeypatch.setattr(jax.lax, "map",
                        lambda f, xs: scan(lambda c, x: (c, f(x)), None,
                                           xs)[1])


class Recorder:
    """A ``shard`` callable that records (name, shape) and returns x."""

    def __init__(self, model_size=None):
        self.calls = []
        if model_size is not None:
            self.model_size = model_size

    def __call__(self, x, name):
        self.calls.append((name, tuple(int(d) for d in x.shape)))
        return x


def _scaled_err(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0,
                                                 float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# _sdpa's kv-replicated branch
# ---------------------------------------------------------------------------

SDPA_CASES = {
    "causal": dict(causal=True, window=None),
    "windowed": dict(causal=True, window=5),
    "noncausal": dict(causal=False, window=None),
    "ring": dict(causal=True, window=6, q_offset=9, ring=True),
}


@pytest.mark.parametrize("case", list(SDPA_CASES))
def test_sdpa_kv_replicated_matches_reference(case):
    kw = dict(SDPA_CASES[case])
    ring = kw.pop("ring", False)
    rng = np.random.default_rng(7)
    b, sq, sk, h, hk, d = 2, 7, 12, 8, 2, 16
    if not ring:
        sq = sk
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hk, d)).astype(np.float32)
    if ring:
        # a ring buffer of 12 slots after 16 writes, two left unwritten
        kpos = np.array([12, 13, 14, 15, 4, 5, 6, 7, 8, 9, -1, -1],
                        np.int32)
        kw["kpos"] = kpos
    j_shard = lambda x, name: x                                # noqa: E731
    j_shard.model_size = 4
    t_shard = Recorder(model_size=4)
    jkw = dict(kw)
    tkw = dict(kw)
    if ring:
        jkw["kpos"] = jnp.asarray(kpos)
        tkw["kpos"] = torch.from_numpy(kpos)
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    shard=j_shard, **jkw)
    got = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), shard=t_shard, **tkw)
    assert t_shard.calls == [("attn_logits4", (b, h, sq, sk))]
    assert got.shape == (b, sq, h, d)
    assert _scaled_err(got, want) <= SDPA_RTOL
    grouped = TL._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), **tkw)
    assert _scaled_err(got, grouped.numpy()) <= SDPA_RTOL


def test_sdpa_takes_grouped_branch_where_kv_heads_divide():
    """kv heads dividing the model axis (or q heads not dividing it) keep
    the grouped branch: its [B, Hk, G, Sq, Sk] logits are constrained."""
    q, k = torch.ones(1, 3, 8, 4), torch.ones(1, 3, 4, 4)
    for msize, name in ((4, "attn_logits"), (3, "attn_logits"),
                        (8, "attn_logits4"), (1, "attn_logits")):
        rec = Recorder(model_size=msize)
        TL._sdpa(q, k, k, causal=True, window=None, shard=rec)
        assert [c[0] for c in rec.calls] == [name], msize


# ---------------------------------------------------------------------------
# the models under a recording shard
# ---------------------------------------------------------------------------

def _cfgs(arch, n_kv=None):
    j_cfg, t_cfg = j_smoke(j_get(arch)), smoke_config(get_config(arch))
    if n_kv is not None:
        j_cfg = dataclasses.replace(j_cfg, n_kv_heads=n_kv)
        t_cfg = dataclasses.replace(t_cfg, n_kv_heads=n_kv)
    return j_cfg, t_cfg


def _port_model(j_cfg, t_cfg, tree, train=False):
    model = convert.lm_params_from_arrays(t_cfg, tree, device="cpu")
    return model.requires_grad_(train)


def _batches(t_cfg, n_micro=N_MICRO):
    gen = torch.Generator().manual_seed(3)
    micro = [make_batch(t_cfg, B, S, gen, device="cpu")
             for _ in range(n_micro)]
    return {k: torch.stack([m[k] for m in micro]) for k in micro[0]}


def _j(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _forward(model, t_cfg, batch, shard):
    """A forward: the prefill step for M-RoPE (it takes ``pos3``), else
    ``forward_logits``."""
    micro = {k: v[0] for k, v in batch.items()}
    if t_cfg.pos == "mrope":
        return make_prefill_step(t_cfg, shard=shard)(model, micro)
    with torch.no_grad():
        return TM.forward_logits(model, micro["tokens"], t_cfg, shard=shard)


def _j_forward(tree, j_cfg, batch, shard):
    micro = {k: v[0] for k, v in _j(batch).items()}
    if j_cfg.pos == "mrope":
        return jax.eval_shape(j_prefill(j_cfg, shard=shard), tree, micro)
    return jax.eval_shape(lambda t, tok: JM.forward_logits(
        t, tok, j_cfg, shard=shard), tree, micro["tokens"])


def _decode(model, t_cfg, shard):
    cache = TM.init_decode_cache(t_cfg, B, 8, torch.float32, device="cpu")
    tok = torch.tensor([[3], [5]], dtype=torch.int32)
    pos = (torch.zeros((B, 1, 3), dtype=torch.int32)
           if t_cfg.pos == "mrope" else None)
    with torch.no_grad():
        return TM.decode_step(model, cache, tok, t_cfg, pos=pos, shard=shard)


def _j_decode(tree, j_cfg, shard):
    cache = JM.init_decode_cache(j_cfg, B, 8, jnp.float32)
    tok = jnp.asarray([[3], [5]], jnp.int32)
    pos = jnp.zeros((B, 1, 3), jnp.int32) if j_cfg.pos == "mrope" else None
    return jax.eval_shape(lambda t, c: JM.decode_step(
        t, c, tok, j_cfg, pos=pos, shard=shard), tree, cache)


def _train(model, t_cfg, batch, shard):
    opt_cfg = TO.OptConfig(lr=1e-2, warmup_steps=1)
    opt = TO.init_opt_state(model, opt_cfg)
    step = make_train_step(t_cfg, opt_cfg, shard=shard, remat=False)
    _, opt, metrics = step(model, opt, batch)
    return metrics["loss"], {n: p.detach().clone()
                             for n, p in model.named_parameters()}


def _j_train(tree, j_cfg, batch, shard):
    opt_cfg = JO.OptConfig(lr=1e-2, warmup_steps=1)
    params = jax.tree.map(jnp.asarray, tree)
    step = j_make_train_step(j_cfg, opt_cfg, shard=shard, remat=False)
    return jax.eval_shape(step, params, JO.init_opt_state(params, opt_cfg),
                          _j(batch))[2]["loss"]


def _tree(j_cfg):
    """The reference's parameter tree drawn with numpy in its shapes."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: JM.init_params(j_cfg, k),
                            jax.random.PRNGKey(0))
    return jax.tree.map(lambda s: (0.1 * rng.standard_normal(s.shape))
                        .astype(s.dtype), shapes)


def _bitwise(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _bitwise(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _bitwise(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("kind", list(KINDS))
def test_model_kind_shard_calls_match_reference(kind):
    j_cfg, t_cfg = _cfgs(KINDS[kind])
    tree = _tree(j_cfg)
    batch = _batches(t_cfg)
    served = not t_cfg.enc_dec        # Whisper is served by its pieces

    if served:
        rec, j_rec = Recorder(), Recorder()
        got = _forward(_port_model(j_cfg, t_cfg, tree), t_cfg, batch, rec)
        _j_forward(tree, j_cfg, batch, j_rec)
        assert rec.calls == j_rec.calls and rec.calls
        plain = _forward(_port_model(j_cfg, t_cfg, tree), t_cfg, batch,
                         TM.NO_SHARD)
        _bitwise(got, plain)

        rec, j_rec = Recorder(), Recorder()
        got = _decode(_port_model(j_cfg, t_cfg, tree), t_cfg, rec)
        _j_decode(tree, j_cfg, j_rec)
        assert rec.calls == j_rec.calls and rec.calls
        plain = _decode(_port_model(j_cfg, t_cfg, tree), t_cfg,
                        TM.NO_SHARD)
        _bitwise(got, plain)

    rec, j_rec = Recorder(), Recorder()
    got = _train(_port_model(j_cfg, t_cfg, tree, train=True), t_cfg, batch,
                 rec)
    _j_train(tree, j_cfg, batch, j_rec)
    assert rec.calls == j_rec.calls and rec.calls
    plain = _train(_port_model(j_cfg, t_cfg, tree, train=True), t_cfg,
                   batch, TM.NO_SHARD)
    _bitwise(got, plain)


@pytest.mark.parametrize("arch,n_kv,msize", [("lm-100m", 2, 4),
                                             ("recurrentgemma-2b", None, 2)])
def test_kv_replicated_model_matches_reference_calls(arch, n_kv, msize):
    j_cfg, t_cfg = _cfgs(arch, n_kv)
    tree = _tree(j_cfg)
    batch = _batches(t_cfg, n_micro=1)
    rec, j_rec = Recorder(msize), Recorder(msize)
    got = _forward(_port_model(j_cfg, t_cfg, tree), t_cfg, batch, rec)
    _j_forward(tree, j_cfg, batch, j_rec)
    assert rec.calls == j_rec.calls
    assert ("attn_logits4", (B, t_cfg.n_heads, S, S)) in rec.calls
    plain = _forward(_port_model(j_cfg, t_cfg, tree), t_cfg, batch,
                     TM.NO_SHARD)
    assert _scaled_err(got, plain.numpy()) <= EXPAND_RTOL

    rec, j_rec = Recorder(msize), Recorder(msize)
    got, _ = _decode(_port_model(j_cfg, t_cfg, tree), t_cfg, rec)
    _j_decode(tree, j_cfg, j_rec)
    assert rec.calls == j_rec.calls
    assert any(c[0] == "attn_logits4" for c in rec.calls)
    plain, _ = _decode(_port_model(j_cfg, t_cfg, tree), t_cfg, TM.NO_SHARD)
    assert _scaled_err(got, plain.numpy()) <= EXPAND_RTOL
