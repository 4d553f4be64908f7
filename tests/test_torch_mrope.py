"""The port's M-RoPE and vision stub against the JAX reference, at the smoke
size of ``qwen2-vl-7b`` (2 layers, d_model 64, 4 heads of 16, QKV bias,
8 vision-stub tokens), with the reference's parameters (drawn with numpy
in its shapes), gradients and optimizer state carried across by
``convert``:

- ``apply_mrope`` at head dims 16 and 128 with the reference's sections
  (``(hd/2 - 2 floor(hd/6), floor(hd/6), floor(hd/6))``) and with sections
  that leave frequencies over; ``attention_fwd`` with M-RoPE, without a
  cache and with a KV cache, with and without the QKV bias;
- ``make_prefill_step`` with ``pos3`` and ``vision_embeds`` (a prompt
  longer and one shorter than the vision tokens), ``train_forward``'s loss
  and every gradient (vision tokens spliced in, ``pos3`` grid positions),
  a sequence no longer than the vision tokens (every position masked:
  loss 0, as the reference's);
- ``decode_step`` with explicit ``pos3`` token by token from a cache
  carried across, then a cache-writing step; the port's decode against
  its own parallel forward at the same positions;
- ``apply_updates`` with float32 moments carried across by
  ``opt_state_from_arrays`` (the clip engaged), and one
  ``make_train_step`` against the reference's (2 microbatches of vision
  batches);
- ``count_params`` of the full config (7,615,616,512), the ``ValueError``
  of ``positions``, ``forward_logits``, ``decode_step`` and
  ``greedy_generate`` on an M-RoPE model without ``pos3``, with the
  reference failing on the same calls, and both LM launchers.

The reference runs eagerly (its decode steps under ``jax.disable_jit``;
its train step jitted, as its own tests run it). Tolerances:
``atol=rtol=1e-4`` on outputs, logits and caches (float32, sums in
another order), ``rtol=1e-5`` on losses, ``atol=1e-6, rtol=1e-4`` on
gradients, ``atol=1e-6`` on parameters and float32 moments after an
optimizer step; ``atol=2e-3`` on parameters after a whole train step
and on decode against the parallel forward
(``tests/test_torch_train.py``'s and ``tests/test_models.py``'s).
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
from repro_torch.launch import serve_lm as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import get_config
from repro_torch.train import optimizer as TO
from repro_torch.train.serve_step import greedy_generate, make_prefill_step
from repro_torch.train.train_step import make_train_step

ARCH = "qwen2-vl-7b"
TOL = 1e-4
PARALLEL_TOL = STEP_ATOL = 2e-3
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 21                   # past the smoke config's 8 vision tokens


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its many small tensor
    operations stall on thread barriers when the test workers share the
    machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


J_CFG, T_CFG = j_smoke(j_get(ARCH)), smoke_config(get_config(ARCH))


def _close(got, want, atol=TOL, rtol=None):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol,
                               rtol=atol if rtol is None else rtol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pos3(rng, b, s, nv, offset=0):
    """M-RoPE positions [B, S, 3] as the data pipelines make them (vision
    tokens on a (0, row, column) grid of side floor(sqrt(nv)), text tokens
    at offset + i in all three streams), each row's text shifted by a
    random amount so that rows differ."""
    text = offset + np.arange(s, dtype=np.int32)
    p = np.broadcast_to(text[None, :, None], (b, s, 3)).copy()
    p += rng.integers(0, 5, (b, 1, 1)).astype(np.int32)
    if nv:
        side = max(1, int(np.sqrt(nv)))
        i = np.arange(nv, dtype=np.int32)
        p[:, :nv] = np.stack([np.zeros_like(i), i // side, i % side], -1)
    return p


def _batch(rng, b, s):
    """A vision batch as numpy: tokens, labels (the next token, a -1
    sentinel at a masked position), mask (vision tokens, the last
    position and a few more masked), ``pos3`` and ``vision_embeds``."""
    nv = min(J_CFG.n_vision_tokens, s)
    toks = rng.integers(0, J_CFG.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    mask = np.ones((b, s), np.float32)
    mask[:, :nv] = 0.0
    mask[:, -1] = 0.0
    if s > nv + 4:
        labels[:, nv + 2] = -1
        mask[:, nv + 2] = 0.0
        mask[-1, nv + 3:nv + 5] = 0.0
    return {"tokens": toks, "labels": labels, "mask": mask,
            "pos3": _pos3(rng, b, s, nv),
            "vision_embeds": (0.5 * rng.standard_normal(
                (b, nv, J_CFG.d_model))).astype(np.float32)}


def _params(rng):
    """A param tree of the reference's shapes drawn with numpy: the
    embedding and unembedding 0.02 N(0, 1), norm scales 1 + 0.2 N(0, 1),
    QKV biases 0.2 N(0, 1), every other weight N(0, 1) / sqrt(d_model)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(J_CFG, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if "'embed'" in name or "'unembed'" in name:
            z = 0.02 * z
        elif "'scale'" in name:
            z = 1 + 0.2 * z
        elif any(f"'{b}'" in name for b in ("bq", "bk", "bv")):
            z = 0.2 * z
        else:
            z = z / np.float32(np.sqrt(J_CFG.d_model))
        return jnp.asarray(z)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, a vision batch, and its loss and
    gradients on it."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    batch = _batch(rng, 2, SEQ)
    loss, grads = jax.value_and_grad(
        lambda p: JM.train_forward(p, _jb(batch), J_CFG))(params)
    return {"params": params, "np": _np(params), "batch": batch,
            "loss": float(loss), "grads": _np(grads)}


def _lm(ref, requires_grad=False):
    return convert.lm_params_from_arrays(
        T_CFG, ref["np"], device="cpu").requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# the rotation and the attention layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sections", ["reference", "short"])
@pytest.mark.parametrize("hd", [16, 128])
def test_apply_mrope_matches_reference(hd, sections):
    """The reference's sections ((4, 2, 2) at hd 16, (22, 21, 21) at 128,
    not Qwen2-VL's published (16, 24, 24)), and sections that cover fewer
    than hd / 2 frequencies (the rest take the temporal stream)."""
    want_sec = (hd // 2 - 2 * (hd // 2 // 3), hd // 2 // 3, hd // 2 // 3)
    assert TL.mrope_sections(hd) == want_sec
    assert TL.mrope_sections(128) == (22, 21, 21)
    sec = want_sec if sections == "reference" else (hd // 8, hd // 8, 1)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 4096, (2, 7, 3)).astype(np.int32)
    for theta in (10000.0, 1e6):
        want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta, sec)
        got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             theta, sec)
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close(got, want)
    # equal streams: M-RoPE is the plain rotary embedding
    same = np.repeat(pos3[..., :1], 3, axis=-1)
    _close(TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                          1e4, sec),
           TL.apply_rope(torch.from_numpy(x),
                         torch.from_numpy(same[..., 0]), 1e4), 1e-6)


def _attn_params(rng, cfg, bias):
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h, hd)) / np.sqrt(d),
         "wk": rng.standard_normal((d, hk, hd)) / np.sqrt(d),
         "wv": rng.standard_normal((d, hk, hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h, hd, d)) / np.sqrt(h * hd)}
    if bias:
        p.update(bq=0.2 * rng.standard_normal((h, hd)),
                 bk=0.2 * rng.standard_normal((hk, hd)),
                 bv=0.2 * rng.standard_normal((hk, hd)))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("cache", [False, True], ids=["no_cache", "kv_cache"])
@pytest.mark.parametrize("bias", [False, True], ids=["plain", "bias"])
def test_attention_with_mrope_matches_reference(bias, cache):
    """``attention_fwd`` on an M-RoPE config (2 kv heads of 4): without a
    cache on 9 tokens, and a 4-token write into a KV cache of 12 slots
    holding 5 (positions given as ``pos3``): output and cache."""
    jcfg = dataclasses.replace(J_CFG, n_kv_heads=2, attn_bias=bias)
    tcfg = dataclasses.replace(T_CFG, n_kv_heads=2, attn_bias=bias)
    rng = np.random.default_rng(3 + bias)
    p = _attn_params(rng, tcfg, bias)
    s, length = (4, 5) if cache else (9, 0)
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    pos3 = _pos3(rng, 2, s, 0 if cache else 4, offset=length)
    jc = tc = None
    if cache:
        kv = rng.standard_normal((2, 2, 12, 2, tcfg.head_dim)).astype(
            np.float32)
        kv[:, :, length:] = 0.0
        jc = {"k": jnp.asarray(kv[0]), "v": jnp.asarray(kv[1]),
              "length": jnp.int32(length)}
        tc = {"k": torch.from_numpy(kv[0]), "v": torch.from_numpy(kv[1]),
              "length": length}
    want, want_c = JL.attention_fwd(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
        pos=jnp.asarray(pos3), cache=jc)
    got, got_c = TL.attention_fwd(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        tcfg, pos=torch.from_numpy(pos3), cache=tc)
    _close(got, want)
    if cache:
        assert got_c["length"] == int(want_c["length"]) == length + s
        _close(got_c["k"], want_c["k"])
        _close(got_c["v"], want_c["v"])
    else:
        assert got_c is None and want_c is None


# ---------------------------------------------------------------------------
# the model: parameters, prefill, training, decode
# ---------------------------------------------------------------------------

def test_params_carried_across(ref):
    lm = _lm(ref)
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    want = convert.lm_arrays_by_name(T_CFG, ref["np"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    assert all("bq" in b.mixer and "bv" in b.mixer for b in lm.blocks)


@pytest.mark.parametrize("s", [SEQ, 5], ids=["long", "shorter_than_vision"])
def test_prefill_with_vision_stub_matches_reference(ref, s):
    """``make_prefill_step`` with ``pos3`` and ``vision_embeds`` of
    min(n_vision_tokens, S) rows: the last position's logits."""
    batch = _batch(np.random.default_rng(10 + s), 2, s)
    assert batch["vision_embeds"].shape[1] == min(J_CFG.n_vision_tokens, s)
    want = j_prefill(J_CFG)(ref["params"], _jb(batch))
    got = make_prefill_step(T_CFG)(_lm(ref), _tb(batch))
    assert got.dtype == torch.float32 and got.shape == (2, J_CFG.vocab)
    _close(got, want)


def test_train_forward_loss_and_every_gradient_match_reference(ref):
    lm = _lm(ref, requires_grad=True)
    loss = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
    _close(loss, ref["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("s", [8, 5], ids=["equal", "shorter"])
def test_train_forward_no_longer_than_vision_tokens(ref, s):
    """A sequence of at most n_vision_tokens (8) is the vision embeddings
    alone (the reference keeps ``x[:, n_vision_tokens:]``, empty there),
    every position is masked, and the loss divides by max(count, 1): 0 in
    both."""
    batch = _batch(np.random.default_rng(20 + s), 2, s)
    assert not batch["mask"].any()
    want = JM.train_forward(ref["params"], _jb(batch), J_CFG)
    got = TM.train_forward(_lm(ref), _tb(batch), T_CFG)
    assert float(want) == float(got) == 0.0


def test_decode_step_with_pos3_matches_reference(ref):
    """Three steps in the reference with explicit ``pos3`` [B, 1, 3], its
    cache carried across by ``decode_cache_from_arrays``, then each
    package's single-token steps from there, and a 3-token cache-writing
    step given its ``pos3``: logits and every layer's cache."""
    lm = _lm(ref)
    b, max_len, n = 2, 12, 9
    rng = np.random.default_rng(4)
    toks = rng.integers(0, J_CFG.vocab, (b, n)).astype(np.int32)
    pos3 = _pos3(rng, b, n, 0)

    def jstep(c, i, j):
        with jax.disable_jit():
            return JM.decode_step(ref["params"], c, jnp.asarray(toks[:, i:j]),
                                  J_CFG, pos=jnp.asarray(pos3[:, i:j]))

    jcache = JM.init_decode_cache(J_CFG, b, max_len, jnp.float32)
    for i in range(3):
        _, jcache = jstep(jcache, i, i + 1)
    tcache = convert.decode_cache_from_arrays(T_CFG, _np(jcache),
                                              device="cpu")
    assert [c["length"] for c in tcache] == [3] * T_CFG.n_layers

    def cache_equal():
        for tl, jl in zip(tcache, convert._unstack(_np(jcache), T_CFG)):
            assert tl["length"] == int(jl["length"])
            _close(tl["k"], jl["k"])
            _close(tl["v"], jl["v"])

    for i, j in ((3, 4), (4, 5), (5, 6), (6, 9)):
        want, jcache = jstep(jcache, i, j)
        got, tcache = TM.decode_step(lm, tcache,
                                     torch.from_numpy(toks[:, i:j]), T_CFG,
                                     pos=torch.from_numpy(pos3[:, i:j]))
        _close(got, want)
        cache_equal()


def _parallel_logits(lm, toks, pos3):
    """The port's parallel forward at explicit M-RoPE positions (what
    ``forward_logits`` computes at positions 0 .. S-1 for a rope model)."""
    x = TM._run_layers(lm, lm.embed[toks], T_CFG, pos=pos3)
    return TM._logits(TM._norm(x, lm.final_norm, T_CFG.norm_eps),
                      lm.unembedding())


def test_decode_with_pos3_matches_parallel_forward(ref):
    """Token-by-token decode with ``pos3``, and a cache-writing prefill of
    6 tokens followed by single-token steps, reproduce the parallel
    forward at the same positions (the vision tokens' grid included)."""
    lm = _lm(ref)
    s = 14
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, J_CFG.vocab, (2, s)).astype(
        np.int32))
    pos3 = torch.from_numpy(_pos3(rng, 2, s, J_CFG.n_vision_tokens))
    want = _parallel_logits(lm, toks, pos3).numpy()
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    got = []
    for i in range(s):
        logits, cache = TM.decode_step(lm, cache, toks[:, i:i + 1], T_CFG,
                                       pos=pos3[:, i:i + 1])
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)
    cache = TM.init_decode_cache(T_CFG, 2, s + 2, torch.float32,
                                 device="cpu")
    whole, cache = TM.decode_step(lm, cache, toks[:, :6], T_CFG,
                                  pos=pos3[:, :6])
    got = [whole.numpy()]
    for i in range(6, s):
        logits, cache = TM.decode_step(lm, cache, toks[:, i:i + 1], T_CFG,
                                       pos=pos3[:, i:i + 1])
        got.append(logits.numpy())
    _close(np.concatenate(got, 1), want, PARALLEL_TOL)


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------

def test_apply_updates_matches_reference(ref):
    """One AdamW step with float32 moments carried across by
    ``opt_state_from_arrays`` (after a first step), on gradients that
    engage the clip: parameters and moments. The QKV biases decay as the
    reference's stacked [L, H, hd] leaves do, the norm scales as its
    [L, d] ones. (The int8 moments are held in ``test_torch_mla.py``.)"""
    rng = np.random.default_rng(6)
    params = ref["params"]

    def rand_tree(scale):
        return jax.tree.map(lambda p: jnp.asarray(
            scale * rng.standard_normal(p.shape).astype(np.float32)), params)

    j_cfg = JO.OptConfig(**OPT)
    p1, st1, _ = JO.apply_updates(params, rand_tree(1e-3),
                                  JO.init_opt_state(params, j_cfg), j_cfg)
    g = rand_tree(1.0)
    p2, st2, want_m = JO.apply_updates(p1, g, st1, j_cfg)
    p1, st1, p2, st2 = _np(p1), _np(st1), _np(p2), _np(st2)

    cfg = TO.OptConfig(**OPT)
    lm = convert.lm_params_from_arrays(T_CFG, p1, device="cpu")
    state = convert.opt_state_from_arrays(T_CFG, st1, device="cpu")
    grads = {n: torch.from_numpy(np.array(a)) for n, a in
             convert.lm_arrays_by_name(T_CFG, _np(g)).items()}
    _, new, metrics = TO.apply_updates(lm, grads, state, cfg,
                                       stacked=TM.scanned_params(lm))
    assert int(new["step"]) == int(st2["step"]) == 2
    assert float(metrics["grad_norm"]) > cfg.grad_clip
    _close(metrics["grad_norm"], want_m["grad_norm"], 0, 1e-6)
    want_p = convert.lm_arrays_by_name(T_CFG, p2)
    for name, p in lm.named_parameters():
        _close(p, want_p[name], 1e-6, 0)
    for mom in ("m", "v"):
        wm = convert.lm_arrays_by_name(T_CFG, st2[mom])
        assert set(new[mom]) == set(wm)
        for name, got in new[mom].items():
            _close(got, wm[name], 1e-6, 0)


def test_train_step_matches_reference(ref):
    """One ``make_train_step`` of 2 microbatches of vision batches against
    the reference's jitted step from the same parameters: loss, gradient
    norm, every parameter after it."""
    rng = np.random.default_rng(7)
    micro = [_batch(rng, 2, SEQ) for _ in range(2)]
    batch = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    j_cfg = JO.OptConfig(**OPT)
    step = jax.jit(j_make_train_step(J_CFG, j_cfg))
    p, _, want_m = step(ref["params"], JO.init_opt_state(ref["params"],
                                                         j_cfg), _jb(batch))
    cfg = TO.OptConfig(**OPT)
    lm = _lm(ref, requires_grad=True)
    lm, state, m = make_train_step(T_CFG, cfg)(
        lm, TO.init_opt_state(lm, cfg), _tb(batch))
    _close(m["loss"], want_m["loss"], 0, 1e-5)
    _close(m["grad_norm"], want_m["grad_norm"], 0, 1e-4)
    want = convert.lm_arrays_by_name(T_CFG, _np(p))
    for name, q in lm.named_parameters():
        _close(q, want[name], STEP_ATOL, 0)
    assert int(state["step"]) == 1


# ---------------------------------------------------------------------------
# the full config, calls without pos3, launchers
# ---------------------------------------------------------------------------

def test_count_params_full_config_on_meta():
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.pos, cfg.frontend, cfg.n_vision_tokens, cfg.attn_bias) == (
        "mrope", "vision_stub", 1024, True)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == 7_615_616_512
    assert next(TM.init_params(cfg, device="meta").parameters()).is_meta


def test_calls_without_pos3_raise(ref):
    """``positions``, ``forward_logits``, ``decode_step`` (one token or
    several) and ``greedy_generate`` on an M-RoPE model with no ``pos3``
    raise ``ValueError``; given ``pos3``, the decode step runs."""
    lm = _lm(ref)
    toks = torch.zeros((2, 3), dtype=torch.int32)
    cache = TM.init_decode_cache(T_CFG, 2, 8, torch.float32, device="cpu")
    calls = [lambda: TM.positions(T_CFG, 2, 3, "cpu"),
             lambda: TM.forward_logits(lm, toks, T_CFG),
             lambda: TM.decode_step(lm, cache, toks[:, :1], T_CFG),
             lambda: TM.decode_step(lm, cache, toks, T_CFG),
             lambda: greedy_generate(lm, T_CFG, toks, 2, 8)]
    for call in calls:
        with pytest.raises(ValueError, match=r"pos3 \[B, S, 3\]"):
            call()
    pos3 = torch.zeros((2, 1, 3), dtype=torch.int32)
    logits, new = TM.decode_step(lm, cache, toks[:, :1], T_CFG, pos=pos3)
    assert logits.shape == (2, 1, T_CFG.vocab) and new[0]["length"] == 1


def test_reference_fails_without_pos3(ref):
    """The reference's ``forward_logits``, and its ``decode_step`` at the
    default position, pass [B, S] positions to ``apply_mrope``, which
    wants [B, S, 3]: both raise (hence the port's ValueError)."""
    toks = jnp.zeros((2, 3), jnp.int32)
    cache = JM.init_decode_cache(J_CFG, 2, 8, jnp.float32)
    for call in (lambda: JM.forward_logits(ref["params"], toks, J_CFG),
                 lambda: JM.decode_step(ref["params"], cache, toks[:, :1],
                                        J_CFG)):
        with pytest.raises(ValueError, match="same number of dimensions"):
            call()


def test_launchers_on_cpu(capsys):
    """``launch/train.py --arch qwen2-vl-7b --smoke`` trains two steps on
    the pipeline's vision batches; ``launch/serve_lm.py --arch
    qwen2-vl-7b`` raises the ``pos3`` error, as the reference's fails."""
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and out.strip().endswith("done")
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="pos3"):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
