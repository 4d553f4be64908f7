"""The port's Whisper encoder-decoder against the JAX reference, at the
smoke size of ``whisper-tiny`` (2 decoder and 2 encoder layers, d_model
64, 4 heads of 16, 16 encoder frames, 64 decoder positions), with the
reference's parameters drawn with numpy in its shapes and carried across
by ``convert`` (its lists ``enc.layers`` and ``cross`` as
``enc.layers.<i>.`` and ``cross.<i>.``):

- ``encoder_fwd``; ``_dec_layers_with_cross`` without caches, with
  precomputed ``cross_kv``, and with ``self_caches`` (a single-token step
  into a half-written cache, a 4-token step into an empty one): outputs
  and new caches;
- the cached cross decode composed from the reference's own pieces
  (``encoder_fwd`` once, each layer's cross keys and values, then per
  token the embedding plus ``dec_pos[length]``, ``_dec_layers_with_cross``
  with both caches, the final LayerNorm and the unembedding) against the
  parallel decoder, in both packages, and the two packages' steps against
  each other;
- ``train_forward``'s loss and every gradient (the lists' included),
  remat on against off; a train step of 2 microbatches with float32
  moments against the reference's; the weight decay that the reference's
  tree gives (its stacked decoder layers' 1-D leaves decayed, the lists'
  not); ``convert`` of parameters and of both moments, quantized too;
- the reference's fault: its ``decode_step`` and ``forward_logits`` run
  the decoder's self-attention alone (no ``dec_pos``, no cross-attention,
  no encoder) and differ from its own encoder-decoder composition, while
  its training loss depends on the encoder's input; the port's
  ``forward_logits``, ``decode_step``, ``make_prefill_step``,
  ``greedy_generate`` and ``serve_lm --arch whisper-tiny`` raise
  ``ValueError`` naming the pieces to compose instead;
- the full config's count on the meta device (57,126,144), its decode
  cache, and ``launch/train.py --arch whisper-tiny --smoke``.

The reference's functions run jitted. Tolerances: encoder, decoder layers,
logits and caches ``atol=rtol=1e-4`` (float32, sums in another order);
``rtol=1e-5`` on losses, ``atol=1e-6, rtol=1e-4`` on gradients,
``atol=1e-6`` on parameters after one optimizer step, ``atol=2e-3`` on
parameters after a whole train step and on the cached decode against the
parallel decoder (the reference test's decode tolerance).
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

ARCH = "whisper-tiny"
TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARALLEL_TOL = STEP_ATOL = 2e-3
OPT = dict(lr=1e-2, warmup_steps=1)
SEQ = 16
ENC_DEC_ERR = "encoder_fwd.*_dec_layers_with_cross"


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
D, H, HD = T_CFG.d_model, T_CFG.n_heads, T_CFG.head_dim
N_ENC = T_CFG.enc_context


def _close(got, want, atol=TOL, rtol=None):
    got = (got.detach().to(torch.float32).numpy()
           if isinstance(got, torch.Tensor) else got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=atol if rtol is None else rtol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _params(rng):
    """A param tree of the reference's shapes drawn with numpy: the
    embedding, unembedding and both position tables 0.02 N(0, 1), norm
    scales 1 + 0.2 N(0, 1), LayerNorm and MLP biases 0.1 N(0, 1), every
    other weight N(0, 1) / sqrt(fan-in)."""
    shapes = jax.eval_shape(lambda k: JM.init_params(J_CFG, k),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        last = name.rsplit("[", 1)[-1]
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if last in ("'embed']", "'unembed']", "'pos']", "'dec_pos']"):
            return jnp.asarray(0.02 * z)
        if last == "'scale']":
            return jnp.asarray(1 + 0.2 * z)
        if last in ("'bias']", "'b1']", "'b2']"):
            return jnp.asarray(0.1 * z)
        shape = leaf.shape[1:] if "'body'" in name else leaf.shape
        fan_in = shape[0] * shape[1] if last == "'wo']" else shape[0]
        return jnp.asarray(z / np.float32(np.sqrt(fan_in)))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(rng, b, s):
    """tokens / labels / mask and ``enc_input`` [B, 16, d] as numpy:
    labels the next token, a -1 sentinel at position 5 (masked), the last
    position and a few more masked."""
    toks = rng.integers(0, J_CFG.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, 5] = -1
    mask = np.ones((b, s), np.float32)
    mask[:, [5, -1]] = 0.0
    mask[-1, 10:14] = 0.0
    enc = (0.5 * rng.standard_normal((b, N_ENC, D))).astype(np.float32)
    return {"tokens": toks, "labels": labels, "mask": mask,
            "enc_input": enc}


# the reference's functions, jitted once for each shape of these tests
_j_loss_grad = jax.jit(jax.value_and_grad(
    lambda p, b: JM.train_forward(p, b, J_CFG)))
_j_encoder = jax.jit(lambda p, e: JM.encoder_fwd(p, e, J_CFG))
_j_logits = jax.jit(lambda p, t: JM.forward_logits(p, t, J_CFG))
_j_decode = jax.jit(lambda p, c, t: JM.decode_step(p, c, t, J_CFG))


@jax.jit
def _j_dec(params, x, memory, self_caches, cross_kv):
    pos = jnp.zeros(x.shape[:2], jnp.int32)     # unused: learned positions
    return JM._dec_layers_with_cross(params, x, memory, J_CFG, pos=pos,
                                     self_caches=self_caches,
                                     cross_kv=cross_kv)


@pytest.fixture(scope="module")
def ref():
    """The reference's parameters, a batch, and its loss and gradients."""
    rng = np.random.default_rng(0)
    params = _params(rng)
    batch = _batch(rng, 2, SEQ)
    loss, grads = _j_loss_grad(params, _jb(batch))
    return {"params": params, "np": _np(params), "batch": batch,
            "loss": float(loss), "grads": _np(grads)}


def _lm(ref, requires_grad=False):
    return convert.lm_params_from_arrays(
        T_CFG, ref["np"], device="cpu").requires_grad_(requires_grad)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_params_carried_across(ref):
    lm = _lm(ref)
    assert sum(p.numel() for p in lm.parameters()) == JM.count_params(J_CFG)
    want = convert.lm_arrays_by_name(T_CFG, ref["np"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name in ("enc.pos", "enc.layers.1.attn.wq", "enc.layers.0.mlp.b2",
                 "enc.ln_post.bias", "dec_pos", "cross.1.ln.scale",
                 "cross.0.attn.wv", "blocks.1.ln1.bias", "blocks.0.ffn.w1"):
        assert name in named, name
    for name, p in named.items():
        np.testing.assert_array_equal(p.numpy(), want[name])
    np.testing.assert_array_equal(named["cross.1.attn.wo"].numpy(),
                                  ref["np"]["cross"][1]["attn"]["wo"])
    np.testing.assert_array_equal(named["enc.layers.1.ln2.scale"].numpy(),
                                  ref["np"]["enc"]["layers"][1]["ln2"]["scale"])
    assert len(lm.enc.layers) == T_CFG.n_enc_layers == 2
    assert len(lm.cross) == T_CFG.n_layers
    assert "bias" in lm.blocks[0].ln1 and "bias" not in lm.cross[0].ln
    assert "bias" in lm.final_norm
    assert TM.positions(T_CFG, 2, 5, "cpu") is None


def test_encoder_fwd_matches_reference(ref):
    """The encoder over 16 frames, and over 11 (``pos[:11]``); with
    ``remat`` the same values."""
    lm = _lm(ref)
    enc = ref["batch"]["enc_input"]
    for e in (enc, enc[:, :11]):
        want = _j_encoder(ref["params"], jnp.asarray(e))
        got = TM.encoder_fwd(lm, torch.from_numpy(e), T_CFG)
        assert got.shape == e.shape and got.dtype == torch.float32
        _close(got, want)
    again = TM.encoder_fwd(_lm(ref, requires_grad=True),
                           torch.from_numpy(enc), T_CFG, remat=True)
    _close(again, TM.encoder_fwd(lm, torch.from_numpy(enc), T_CFG), 0, 0)


def _cross_kv_np(ref, memory):
    """Each layer's cross keys and values of ``memory``, in numpy:
    ``memory @ wk``, ``memory @ wv``."""
    return [(np.einsum("bsd,dhk->bshk", memory, c["attn"]["wk"]),
             np.einsum("bsd,dhk->bshk", memory, c["attn"]["wv"]))
            for c in ref["np"]["cross"]]


def _self_caches(rng, length, s_max=12):
    """One self-attention cache per decoder layer holding ``length``
    random tokens of ``s_max`` (the rest zero), as numpy."""
    out = []
    for _ in range(T_CFG.n_layers):
        k = rng.standard_normal((2, s_max, H, HD)).astype(np.float32)
        v = rng.standard_normal((2, s_max, H, HD)).astype(np.float32)
        k[:, length:], v[:, length:] = 0.0, 0.0
        out.append({"k": k, "v": v, "length": length})
    return out


# (S, self-cache length or None, cross_kv given)
_CASES = {"parallel": (9, None, False), "cross_kv": (9, None, True),
          "cached_step": (1, 5, True), "cached_prefill": (4, 0, False)}


@pytest.mark.parametrize("case", list(_CASES))
def test_dec_layers_with_cross_matches_reference(ref, case):
    """``_dec_layers_with_cross`` on x [2, S, d] and a memory of 16
    frames: without caches, with precomputed ``cross_kv``, and with
    ``self_caches`` (a step at length 5, a 4-token step at length 0):
    output and every layer's new cache."""
    s, length, with_kv = _CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    memory = rng.standard_normal((2, N_ENC, D)).astype(np.float32)
    kv = _cross_kv_np(ref, memory) if with_kv else None
    caches = None if length is None else _self_caches(rng, length)
    want, want_c = _j_dec(
        ref["params"], jnp.asarray(x), jnp.asarray(memory),
        None if caches is None else [
            {"k": jnp.asarray(c["k"]), "v": jnp.asarray(c["v"]),
             "length": jnp.int32(length)} for c in caches],
        None if kv is None else [tuple(map(jnp.asarray, p)) for p in kv])
    got, got_c = TM._dec_layers_with_cross(
        _lm(ref), torch.from_numpy(x),
        None if with_kv else torch.from_numpy(memory), T_CFG, pos=None,
        self_caches=None if caches is None else [
            {"k": torch.from_numpy(c["k"]), "v": torch.from_numpy(c["v"]),
             "length": length} for c in caches],
        cross_kv=None if kv is None else [
            tuple(map(torch.from_numpy, p)) for p in kv])
    assert got.shape == (2, s, D)
    _close(got, want)
    assert len(got_c) == len(want_c) == T_CFG.n_layers
    for gc, wc in zip(got_c, want_c):
        if caches is None:
            assert gc is None and wc is None
            continue
        assert gc["length"] == int(wc["length"]) == length + s
        _close(gc["k"], wc["k"])
        _close(gc["v"], wc["v"])


# ---------------------------------------------------------------------------
# the cached cross decode, composed from the pieces
# ---------------------------------------------------------------------------

def _t_parallel(lm, tokens, enc_in):
    """The port's parallel decoder: logits [B, S, V] of ``tokens`` over
    the encoder's output."""
    memory = TM.encoder_fwd(lm, enc_in, T_CFG)
    x = lm.embed[tokens] + lm.dec_pos[None, :tokens.shape[1]]
    x, _ = TM._dec_layers_with_cross(lm, x, memory, T_CFG, pos=None)
    x = TL.layernorm(x, lm.final_norm, T_CFG.norm_eps)
    return TM._logits(x, lm.unembedding())


def _t_cached(lm, tokens, enc_in, max_len):
    """The port's cached cross decode, one token a step: the encoder once,
    each layer's cross keys and values once, the self-attention caches
    from ``init_decode_cache``."""
    memory = TM.encoder_fwd(lm, enc_in, T_CFG)
    kv = [TM._cross_kv(c.attn, memory, T_CFG) for c in lm.cross]
    caches = TM.init_decode_cache(T_CFG, tokens.shape[0], max_len,
                                  torch.float32, device="cpu")
    out = []
    for i in range(tokens.shape[1]):
        length = caches[0]["length"]
        x = lm.embed[tokens[:, i:i + 1]] + lm.dec_pos[None, length:length + 1]
        x, caches = TM._dec_layers_with_cross(lm, x, None, T_CFG, pos=None,
                                              self_caches=caches,
                                              cross_kv=kv)
        x = TL.layernorm(x, lm.final_norm, T_CFG.norm_eps)
        out.append(TM._logits(x, lm.unembedding()))
    return torch.cat(out, 1)


def _j_final(params, x):
    x = JL.layernorm(x, params["final_norm"], J_CFG.norm_eps)
    return jnp.einsum("bsd,dv->bsv", x, params["unembed"],
                      preferred_element_type=jnp.float32)


@jax.jit
def _j_parallel(params, tokens, enc_in):
    memory = JM.encoder_fwd(params, enc_in, J_CFG)
    x = params["embed"][tokens] + params["dec_pos"][None, :tokens.shape[1]]
    x, _ = JM._dec_layers_with_cross(
        params, x, memory, J_CFG, pos=jnp.zeros(tokens.shape, jnp.int32))
    return _j_final(params, x)


@jax.jit
def _j_cached_step(params, caches, kv, tok):
    """One step of the reference's composed decode; ``caches`` its
    ``init_decode_cache`` unstacked into one per layer."""
    length = caches[0]["length"]
    x = params["embed"][tok] + jax.lax.dynamic_slice_in_dim(
        params["dec_pos"], length, 1)[None]
    x, caches = JM._dec_layers_with_cross(
        params, x, None, J_CFG, pos=jnp.zeros(tok.shape, jnp.int32),
        self_caches=caches, cross_kv=kv)
    return _j_final(params, x), caches


def _j_cached(params, tokens, enc_in, max_len):
    memory = _j_encoder(params, enc_in)
    kv = [(jnp.einsum("bsd,dhk->bshk", memory, c["attn"]["wk"]),
           jnp.einsum("bsd,dhk->bshk", memory, c["attn"]["wv"]))
          for c in params["cross"]]
    stacked = JM.init_decode_cache(J_CFG, tokens.shape[0], max_len,
                                   jnp.float32)
    # the reference stacks its layers' caches ({"body": [...]}, length of
    # shape (L,)); _dec_layers_with_cross indexes one per layer
    caches = [jax.tree.map(lambda a, i=i: a[i], stacked["body"][0])
              for i in range(T_CFG.n_layers)]
    out = []
    for i in range(tokens.shape[1]):
        logits, caches = _j_cached_step(params, caches, kv,
                                        tokens[:, i:i + 1])
        out.append(logits)
    return jnp.concatenate(out, 1)


def test_cross_decode_matches_parallel_decoder_in_both_packages(ref):
    """12 tokens decoded one at a time through the composed cross decode
    against each package's parallel decoder, and the port's steps against
    the reference's."""
    lm = _lm(ref)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, J_CFG.vocab, (2, 12)).astype(np.int32)
    enc = ref["batch"]["enc_input"]
    j_par = _j_parallel(ref["params"], jnp.asarray(toks), jnp.asarray(enc))
    j_cached = _j_cached(ref["params"], jnp.asarray(toks), jnp.asarray(enc),
                         14)
    _close(j_cached, j_par, PARALLEL_TOL)
    t_par = _t_parallel(lm, torch.from_numpy(toks), torch.from_numpy(enc))
    t_cached = _t_cached(lm, torch.from_numpy(toks), torch.from_numpy(enc),
                         14)
    _close(t_cached, t_par.numpy(), PARALLEL_TOL)
    _close(t_par, j_par)
    _close(t_cached, j_cached)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_forward_loss_and_every_gradient_match_reference(ref):
    lm = _lm(ref, requires_grad=True)
    loss = TM.train_forward(lm, _tb(ref["batch"]), T_CFG)
    _close(loss, ref["loss"], 0, 1e-5)
    loss.backward()
    want = convert.lm_arrays_by_name(T_CFG, ref["grads"])
    named = dict(lm.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None, name
        if not name.startswith("dec_pos"):   # rows past S get none
            assert bool(p.grad.abs().max() > 0), name
        _close(p.grad, want[name], GRAD_ATOL, GRAD_RTOL)
    lm_off = _lm(ref, requires_grad=True)
    TM.train_forward(lm_off, _tb(ref["batch"]), T_CFG, remat=False).backward()
    for name, p in lm_off.named_parameters():
        assert torch.equal(p.grad, named[name].grad), name


def test_train_step_matches_reference(ref):
    """One ``make_train_step`` of 2 microbatches with float32 moments
    against the reference's jitted step from the same parameters: loss,
    gradient norm, every parameter after it."""
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


_j_apply = jax.jit(lambda p, g, s: JO.apply_updates(
    p, g, s, JO.OptConfig(**OPT)))


def test_weight_decay_skips_the_lists_as_the_reference(ref):
    """One AdamW step on zero gradients (float32 moments; the reference's
    jitted): only weight decay moves a parameter. The reference's stacked
    decoder layers' 1-D leaves (LayerNorms, MLP biases: [L, d] there)
    decay; those of its lists ``enc.layers`` and ``cross`` (not stacked)
    do not, nor the final norm or ``enc.ln_post``; 2-D leaves everywhere
    do."""
    params = ref["params"]
    zeros = jax.tree.map(jnp.zeros_like, params)
    p1, _, _ = _j_apply(params, zeros, JO.init_opt_state(params,
                                                         JO.OptConfig()))
    lm = _lm(ref)
    named = dict(lm.named_parameters())
    stacked = TM.scanned_params(lm)
    assert not any(n.startswith(("enc.", "cross.")) for n in stacked)
    TO.apply_updates(lm, {n: torch.zeros_like(p) for n, p in named.items()},
                     TO.init_opt_state(lm, TO.OptConfig()),
                     TO.OptConfig(**OPT), stacked=stacked)
    want = convert.lm_arrays_by_name(T_CFG, _np(p1))
    before = convert.lm_arrays_by_name(T_CFG, ref["np"])
    decayed = set()
    for name, p in named.items():
        _close(p, want[name], 1e-7, 0)
        if not np.array_equal(want[name], before[name]):
            decayed.add(name)
    for name in ("blocks.0.ln1.scale", "blocks.1.ffn.b1", "enc.pos",
                 "dec_pos", "cross.0.attn.wq", "enc.layers.1.mlp.w1"):
        assert name in decayed, name
    for name in ("enc.layers.0.ln1.scale", "enc.layers.1.mlp.b2",
                 "cross.1.ln.scale", "enc.ln_post.bias", "final_norm.scale"):
        assert name not in decayed, name


def _moment(rng, tree, quantized):
    """Random moments shaped as the reference's optimizer state for
    ``tree``: float32 leaves, or ``{"code": int8, "scale": float32}`` in
    its layout (blocks of 256 along the last axis)."""
    def one(a):
        if not quantized:
            return rng.standard_normal(a.shape).astype(np.float32)
        nb = -(-a.shape[-1] // 256)
        return {"code": rng.integers(-127, 128, (*a.shape[:-1], nb * 256))
                .astype(np.int8),
                "scale": rng.random((*a.shape[:-1], nb)).astype(np.float32)}
    return jax.tree.map(one, tree)


@pytest.mark.parametrize("quantized", [False, True])
def test_convert_carries_the_lists_of_both_moments(ref, quantized):
    """``opt_state_from_arrays`` of a state in the reference's layout
    (float32 or int8 moments): every parameter's moments under its port
    name, the lists' items included, equal to the reference's leaves."""
    rng = np.random.default_rng(9)
    st = {"step": np.int32(1), "m": _moment(rng, ref["np"], quantized),
          "v": _moment(rng, ref["np"], quantized)}
    state = convert.opt_state_from_arrays(T_CFG, st, device="cpu")
    names = {n for n, _ in _lm(ref).named_parameters()}
    assert int(state["step"]) == 1
    for mom in ("m", "v"):
        assert set(state[mom]) == names
        got = state[mom]["enc.layers.1.attn.wk"]
        want = st[mom]["enc"]["layers"][1]["attn"]["wk"]
        got_c = state[mom]["cross.0.ln.scale"]
        want_c = st[mom]["cross"][0]["ln"]["scale"]
        if quantized:
            for key in ("code", "scale"):
                np.testing.assert_array_equal(got[key].numpy(), want[key])
                np.testing.assert_array_equal(got_c[key].numpy(),
                                              want_c[key])
            assert got["code"].dtype == torch.int8
        else:
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(got_c.numpy(), want_c)


# ---------------------------------------------------------------------------
# serving: the reference's fault, the port's refusal
# ---------------------------------------------------------------------------

def test_reference_serving_ignores_the_encoder(ref):
    """The reference's ``decode_step`` (token by token from its
    ``init_decode_cache``) equals its ``forward_logits``, and both differ
    from its own encoder-decoder composition (``dec_pos``, cross-attention
    over the encoder's output): they run the decoder's self-attention
    layers alone. Its training loss does depend on the encoder's input."""
    toks = np.random.default_rng(8).integers(0, J_CFG.vocab, (2, 10)).astype(
        np.int32)
    params = ref["params"]
    fwd = _j_logits(params, jnp.asarray(toks))
    cache = JM.init_decode_cache(J_CFG, 2, 12, jnp.float32)
    steps = []
    for i in range(toks.shape[1]):
        logits, cache = _j_decode(params, cache, jnp.asarray(toks[:, i:i + 1]))
        steps.append(logits)
    _close(jnp.concatenate(steps, 1), fwd, PARALLEL_TOL)
    composed = _j_parallel(params, jnp.asarray(toks),
                           jnp.asarray(ref["batch"]["enc_input"]))
    assert float(jnp.abs(composed - fwd).max()) > 0.1
    batch = dict(ref["batch"], enc_input=3 * ref["batch"]["enc_input"])
    loss3, _ = _j_loss_grad(params, _jb(batch))
    assert abs(float(loss3) - ref["loss"]) > 1e-4


def test_port_serving_paths_raise_on_enc_dec(ref):
    """``forward_logits``, ``decode_step``, ``make_prefill_step``,
    ``greedy_generate`` and ``serve_lm --arch whisper-tiny`` raise
    ``ValueError`` naming ``encoder_fwd`` and ``_dec_layers_with_cross``
    rather than run the decoder without its encoder."""
    lm = _lm(ref)
    toks = torch.zeros((2, 3), dtype=torch.int32)
    cache = TM.init_decode_cache(T_CFG, 2, 8, torch.float32, device="cpu")
    assert len(cache) == T_CFG.n_layers
    calls = [lambda: TM.forward_logits(lm, toks, T_CFG),
             lambda: TM.decode_step(lm, cache, toks[:, :1], T_CFG),
             lambda: make_prefill_step(T_CFG),
             lambda: greedy_generate(lm, T_CFG, toks, 4, 8),
             lambda: serve_cli.main(["--arch", ARCH, "--smoke", "--device",
                                     "cpu"])]
    for call in calls:
        with pytest.raises(ValueError, match=ENC_DEC_ERR):
            call()


# ---------------------------------------------------------------------------
# the full config, launcher
# ---------------------------------------------------------------------------

def test_full_config_counts_and_decode_cache():
    """The published config copied exactly, 57,126,144 parameters on the
    meta device, and one self-attention cache per decoder layer (448
    positions) from ``init_decode_cache``."""
    cfg, jcfg = get_config(ARCH), j_get(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = TM.count_params(cfg)
    assert n == JM.count_params(jcfg) == cfg.param_count() == 57_126_144
    model = TM.init_params(cfg, device="meta")
    assert tuple(model.enc.pos.shape) == (1500, 384)
    assert tuple(model.dec_pos.shape) == (448, 384)
    assert len(model.enc.layers) == len(model.cross) == 4
    cache = TM.init_decode_cache(cfg, 4, cfg.max_target_len, device="meta")
    assert len(cache) == 4 and all(
        set(c) == {"k", "v", "length"} and tuple(c["k"].shape)
        == (4, 448, 6, 64) for c in cache)


def test_train_launcher_on_cpu(capsys):
    """``launch/train.py --arch whisper-tiny --smoke --device cpu``: two
    finite training steps on batches that carry ``enc_input``."""
    train_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}-smoke" in out and out.strip().endswith("done")
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 2 and all(np.isfinite(losses))
