"""T5 v1.1 / Flan-T5 / mT5 (reference pytorch_models/text/t5.py).

T5 has its own block stack, distinct from the shared core (ref t5.py:15-131):
- RMSNorm without mean subtraction, computed in fp32 (ref t5.py:15-25),
- GEGLU gated MLP with tanh GELU (ref t5.py:29-37),
- log-bucketed relative position bias, 32 buckets / max distance 128, shared
  across layers per stack (ref t5.py:40-71, 99-131),
- bias-free projections; q/k kernels are pre-scaled by ``64**0.25`` at load so
  the standard 1/sqrt(d) attention matches T5X's unscaled attention
  (ref t5.py:176-177).

``T5Generator`` here decodes with a KV cache + ``lax.while_loop`` instead of
the reference's full re-decode per token (ref t5.py:220-223).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ... import transformer as tfm
from ...ops import ACT_FNS, linear
from ...ops import attention as _attn
from ...ops.int8_kv import quantize_kv
from ...utils import StateDict, stack_layers
from pytorch_models_tpu.utils.module import InferenceModel

_F32_EPS = float(np.finfo(np.float32).eps)
NEG_INF = -1e10  # ref t5.py:126

# ref t5.py:157-163
SIZES = dict(
    small=(512, 6, 8, 1024),
    base=(768, 12, 12, 2048),
    large=(1024, 16, 24, 2816),
    xl=(2048, 32, 24, 5120),
    xxl=(4096, 64, 24, 10240),
)


@dataclass(frozen=True)
class T5Config:
    vocab_size: int
    dim: int
    n_heads: int
    n_layers: int
    mlp_dim: int
    n_buckets: int = 32
    max_distance: int = 128
    norm_eps: float = 1e-5
    # Tensor-parallel serving (parallel/serving.py): under shard_map each rank
    # holds local_heads = n_heads/tp heads (incl. its rows of the rel-pos
    # bias table) and all-reduces over tp_axis after o/wo projections.
    local_heads: int | None = None
    tp_axis: str | None = None
    # "xla" forces the einsum attention path — used by code that runs the
    # cached decode under vmap (batched speculative), where per-row cache
    # positions rule out the decode kernel.
    attn_impl: str = "auto"

    @property
    def layer(self) -> tfm.LayerConfig:
        heads = self.n_heads if self.local_heads is None else self.local_heads
        return tfm.LayerConfig(self.dim, heads, 64, bias=False, tp_axis=self.tp_axis,
                               attn_impl=self.attn_impl)


def rms_norm(p: dict, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """T5 LayerNorm: no mean subtraction, fp32 compute (ref t5.py:22-25)."""
    x32 = x.astype(jnp.float32)
    y = x32 * lax.rsqrt(jnp.mean(jnp.square(x32), axis=-1, keepdims=True) + eps)
    return y.astype(x.dtype) * p["scale"].astype(x.dtype)


def relative_position_buckets(rel_pos: jnp.ndarray, bidirectional: bool, n_buckets: int, max_distance: int):
    """Log-bucketed relative positions (ref t5.py:47-70). ``rel_pos`` = key - query."""
    if bidirectional:
        nb = n_buckets // 2
        offset = jnp.where(rel_pos > 0, nb, 0)
        pos = jnp.abs(rel_pos)
    else:
        nb = n_buckets
        offset = jnp.zeros_like(rel_pos)
        pos = jnp.clip(-rel_pos, 0, None)
    max_exact = nb // 2
    scale = (nb - max_exact) / math.log(max_distance / max_exact)
    val_large = max_exact + (jnp.log(pos.astype(jnp.float32) / max_exact + _F32_EPS) * scale).astype(jnp.int32)
    val_large = jnp.minimum(val_large, nb - 1)
    return jnp.where(pos < max_exact, pos, val_large) + offset


def relative_position_bias(bias: jnp.ndarray, q_pos: jnp.ndarray, k_pos: jnp.ndarray, bidirectional: bool, cfg: T5Config):
    """Bias lookup -> (H, Lq, Lk). ``bias``: (H, n_buckets) param."""
    rel = k_pos[None, :] - q_pos[:, None]
    idx = relative_position_buckets(rel, bidirectional, cfg.n_buckets, cfg.max_distance)
    return jnp.take(bias, idx, axis=1)


# ---------------------------------------------------------------------------
# Blocks (ref t5.py:74-96)
# ---------------------------------------------------------------------------


def _t5_mlp_init(key, dim: int, mlp_dim: int) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    return {
        "w": tfm.linear_init(k1, dim, mlp_dim, bias=False),
        "v": tfm.linear_init(k2, dim, mlp_dim, bias=False),
        "wo": tfm.linear_init(k3, mlp_dim, dim, bias=False),
    }


def _t5_mlp_apply(p: dict, x: jnp.ndarray, tp_axis: str | None = None) -> jnp.ndarray:
    return tfm.reduce_linear(
        p["wo"], ACT_FNS["approximate_gelu"](linear(p["w"], x)) * linear(p["v"], x), tp_axis)


def t5_block_init(key, cfg: T5Config, cross_attn: bool) -> dict:
    ks = jax.random.split(key, 3)
    p = {
        "sa_norm": {"scale": jnp.ones((cfg.dim,), jnp.float32)},
        "sa": tfm.mha_init(ks[0], cfg.layer),
        "mlp_norm": {"scale": jnp.ones((cfg.dim,), jnp.float32)},
        "mlp": _t5_mlp_init(ks[1], cfg.dim, cfg.mlp_dim),
    }
    if cross_attn:
        p["ca_norm"] = {"scale": jnp.ones((cfg.dim,), jnp.float32)}
        p["ca"] = tfm.mha_init(ks[2], cfg.layer)
    return p


def t5_block_apply(
    p: dict,
    cfg: T5Config,
    x: jnp.ndarray,
    memory: jnp.ndarray | None = None,
    attn_bias: jnp.ndarray | None = None,
    ca_bias: jnp.ndarray | None = None,
    self_cache: dict | None = None,
    cross_cache: dict | None = None,
    pos=None,
    cache_layer=None,
    pad_lens: jnp.ndarray | None = None,
):
    lc = cfg.layer
    if self_cache is not None:
        out, new_cache = tfm.mha_apply(p["sa"], lc, rms_norm(p["sa_norm"], x), attn_bias=attn_bias,
                                       cache=self_cache, cache_pos=pos, cache_layer=cache_layer,
                                       pad_lens=pad_lens)
        x = x + out
    else:
        new_cache = None
        x = x + tfm.mha_apply(p["sa"], lc, rms_norm(p["sa_norm"], x), attn_bias=attn_bias)
    if "ca" in p:
        h = rms_norm(p["ca_norm"], x)
        if cross_cache is not None:
            x = x + tfm.mha_apply(p["ca"], lc, h, attn_bias=ca_bias, cache=cross_cache)
        else:
            x = x + tfm.mha_apply(p["ca"], lc, h, memory, attn_bias=ca_bias)
    x = x + _t5_mlp_apply(p["mlp"], rms_norm(p["mlp_norm"], x), lc.tp_axis)
    return (x, new_cache) if self_cache is not None else x


# ---------------------------------------------------------------------------
# Encoder / decoder stacks (ref t5.py:99-131)
# ---------------------------------------------------------------------------


def t5_stack_init(key, cfg: T5Config, cross_attn: bool) -> dict:
    keys = jax.random.split(key, cfg.n_layers)
    return {
        "attn_bias": jnp.zeros((cfg.n_heads, cfg.n_buckets), jnp.float32),
        "layers": stack_layers([t5_block_init(k, cfg, cross_attn) for k in keys]),
        "norm": {"scale": jnp.ones((cfg.dim,), jnp.float32)},
    }


def t5_encoder_apply(p: dict, cfg: T5Config, x: jnp.ndarray, pad_bias: jnp.ndarray | None = None) -> jnp.ndarray:
    length = x.shape[-2]
    positions = jnp.arange(length)
    bias = relative_position_bias(p["attn_bias"], positions, positions, True, cfg)
    if pad_bias is not None:
        bias = bias + pad_bias

    def body(h, lp):
        return t5_block_apply(lp, cfg, h, attn_bias=bias), None

    x, _ = lax.scan(body, x, p["layers"])
    return rms_norm(p["norm"], x)


def t5_decoder_apply(p: dict, cfg: T5Config, x: jnp.ndarray, memory: jnp.ndarray,
                     ca_bias: jnp.ndarray | None = None) -> jnp.ndarray:
    length = x.shape[-2]
    positions = jnp.arange(length)
    bias = relative_position_bias(p["attn_bias"], positions, positions, False, cfg)
    causal = jnp.triu(jnp.full((length, length), NEG_INF, jnp.float32), k=1)
    bias = bias + causal

    def body(h, lp):
        return t5_block_apply(lp, cfg, h, memory=memory, attn_bias=bias, ca_bias=ca_bias), None

    x, _ = lax.scan(body, x, p["layers"])
    return rms_norm(p["norm"], x)


def t5_init(key, cfg: T5Config) -> dict:
    ks = jax.random.split(key, 4)
    return {
        "token_embs": jax.random.normal(ks[0], (cfg.vocab_size, cfg.dim), jnp.float32),
        "encoder": t5_stack_init(ks[1], cfg, False),
        "decoder": t5_stack_init(ks[2], cfg, True),
        "classifier": tfm.linear_init(ks[3], cfg.dim, cfg.vocab_size, bias=False),
    }


@partial(jax.jit, static_argnums=1)
def t5_encode(params, cfg: T5Config, tokens):
    return t5_encoder_apply(params["encoder"], cfg, jnp.take(params["token_embs"], tokens, axis=0))


@partial(jax.jit, static_argnums=1)
def t5_decode(params, cfg: T5Config, tokens, memory, ca_bias=None):
    x = t5_decoder_apply(params["decoder"], cfg, jnp.take(params["token_embs"], tokens, axis=0),
                         memory, ca_bias=ca_bias)
    return linear(params["classifier"], x)


# ---------------------------------------------------------------------------
# KV-cached greedy generation (new capability; replaces ref t5.py:211-227 loop)
# ---------------------------------------------------------------------------


def _t5_decode_layers(dec, cfg: T5Config, h, caches, cross_caches, bias, ca_bias, pos):
    """One decode step through all layers, unrolled with per-layer list caches
    (avoids the dynamic_index cache-slice copy; see transformer.decoder_apply)."""
    new_caches = []
    for i in range(cfg.n_layers):
        lp = jax.tree.map(lambda a: a[i], dec["layers"])
        cc = jax.tree.map(lambda a: a[i], cross_caches)
        h, new_c = t5_block_apply(lp, cfg, h, attn_bias=bias, ca_bias=ca_bias,
                                  self_cache=caches[i], cross_cache=cc, pos=pos)
        new_caches.append(new_c)
    return h, new_caches


@partial(jax.jit, static_argnums=(1, 4))
def _t5_generate(params, cfg: T5Config, enc_tokens, n_enc, max_tokens: int, pad_id, eos_id):
    """Greedy encoder-decoder generation, fully on device.

    ``enc_tokens``: (P,) bucket-padded prompt; positions >= n_enc are masked
    out of encoder self-attention and cross-attention.
    """
    p_len = enc_tokens.shape[0]
    enc_valid = jnp.arange(p_len) < n_enc
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[None, None, :]

    x = jnp.take(params["token_embs"], enc_tokens, axis=0)
    memory = t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)

    dec = params["decoder"]
    lc = cfg.layer
    self_caches = tfm.make_kv_cache(cfg.n_layers, (), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=params["token_embs"].dtype, stacked=False)
    # per-row valid memory lengths replace the explicit cross-attn pad bias:
    # the cache's "len" masks padded keys on both the kernel and einsum paths
    cross_caches = tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)
    if _attn.USE_INT8_KV:  # int8 modes (opt-in), as the batched generator
        self_caches = quantize_kv(self_caches)
    if _attn.USE_INT8_KV_CROSS:
        cross_caches = quantize_kv(cross_caches)

    out_buf = jnp.zeros((max_tokens,), jnp.int32).at[0].set(pad_id)

    # full (H, P, L) bias table ONCE outside the loop: the per-step bucket
    # math + (H, L) gather would otherwise run every step
    l_pad = tfm.padded_cache_len(max_tokens)
    bias_table = relative_position_bias(
        dec["attn_bias"], jnp.arange(max_tokens), jnp.arange(l_pad), False, cfg)

    def step(carry):
        buf, pos, caches, done = carry
        tok = lax.dynamic_slice(buf, (pos,), (1,))
        h = jnp.take(params["token_embs"], tok, axis=0)
        bias = lax.dynamic_slice(bias_table, (0, pos, 0), (bias_table.shape[0], 1, l_pad))

        h, caches = _t5_decode_layers(dec, cfg, h, caches, cross_caches, bias, None, pos)
        h = rms_norm(dec["norm"], h)
        nxt = jnp.argmax(linear(params["classifier"], h)[0], axis=-1).astype(jnp.int32)
        buf = lax.dynamic_update_slice(buf, nxt[None], (pos + 1,))
        return buf, pos + 1, caches, nxt == eos_id

    def cond(carry):
        _, pos, _, done = carry
        return jnp.logical_and(jnp.logical_not(done), pos < max_tokens - 1)

    buf, length, _, _ = lax.while_loop(cond, step, (out_buf, jnp.int32(0), self_caches, jnp.bool_(False)))
    return buf, length + 1


def _t5_generate_batch_body(params, cfg: T5Config, enc_tokens, n_enc, max_tokens: int, pad_id, eos_id):
    """Batched greedy generation: (B, P) right-padded prompts with per-row
    lengths ``n_enc`` (B,). Decoder rows are naturally aligned (all start at
    the pad token), so only encoder/cross masks are per-row."""
    b, p_len = enc_tokens.shape
    enc_valid = jnp.arange(p_len)[None, :] < n_enc[:, None]
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[:, None, None, :]

    x = jnp.take(params["token_embs"], enc_tokens, axis=0)
    memory = t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)

    dec = params["decoder"]
    lc = cfg.layer
    self_caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=params["token_embs"].dtype, stacked=False)
    if _attn.USE_INT8_KV:
        # int8 self-KV (opt-in): the cache starts empty (T5 decodes from the
        # pad token), so quantizing the zeros IS the initial int8 state
        self_caches = quantize_kv(self_caches)
    cross_caches = tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)
    if _attn.USE_INT8_KV_CROSS:
        # int8 cross-KV (opt-in): T5's decoder has no cross prefill, so the
        # quantized caches are the only copy the decode loop ever reads
        # (the rel-pos bias applies to self-attention only — cross is legal)
        cross_caches = quantize_kv(cross_caches)

    out_buf = jnp.zeros((b, max_tokens), jnp.int32).at[:, 0].set(pad_id)

    l_pad = tfm.padded_cache_len(max_tokens)
    bias_table = relative_position_bias(
        dec["attn_bias"], jnp.arange(max_tokens), jnp.arange(l_pad), False, cfg)

    def step(carry):
        buf, pos, caches, done = carry
        tok = lax.dynamic_slice(buf, (0, pos), (b, 1))
        h = jnp.take(params["token_embs"], tok, axis=0)
        bias = lax.dynamic_slice(bias_table, (0, pos, 0), (bias_table.shape[0], 1, l_pad))
        h, caches = _t5_decode_layers(dec, cfg, h, caches, cross_caches, bias, None, pos)
        h = rms_norm(dec["norm"], h)
        nxt = jnp.argmax(linear(params["classifier"], h)[:, 0], axis=-1).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(eos_id), nxt)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos + 1))
        return buf, pos + 1, caches, jnp.logical_or(done, nxt == eos_id)

    def cond(carry):
        _, pos, _, done = carry
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < max_tokens - 1)

    buf, length, _, _ = lax.while_loop(cond, step, (out_buf, jnp.int32(0), self_caches,
                                                    jnp.zeros((b,), jnp.bool_)))
    gen = buf[:, 1:]
    generated = jnp.arange(gen.shape[1])[None, :] < length
    is_eos = jnp.logical_and(gen == eos_id, generated)
    lengths = jnp.where(jnp.any(is_eos, axis=1), jnp.argmax(is_eos, axis=1) + 2, length + 1)
    return buf, lengths


_t5_generate_batch = partial(jax.jit, static_argnums=(1, 4))(_t5_generate_batch_body)


def _t5_beam_body(params, cfg: T5Config, enc_tokens, n_enc, max_tokens: int,
                  pad_id, eos_id, beam_width: int, alpha):
    """Beam-search seq2seq generation for ONE prompt (``enc_tokens`` (P,)).

    The W beams ride the batched decode path via the model-agnostic loop in
    models/text/beam.py; encoder memory is projected into cross K/V once and
    broadcast across beams. Returns ``(seqs (W, max_tokens), scores (W,),
    lengths (W,))`` best-first; row layout matches the greedy buffers (pad
    token at index 0, EOS counted in the length).
    """
    from .beam import beam_decode_loop

    w = beam_width
    p_len = enc_tokens.shape[0]
    enc_valid = jnp.arange(p_len) < n_enc
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[None, None, :]
    x = jnp.take(params["token_embs"], enc_tokens, axis=0)
    memory = t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)

    dec = params["decoder"]
    lc = cfg.layer
    self_caches = tfm.make_kv_cache(cfg.n_layers, (w,), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=params["token_embs"].dtype, stacked=False)
    cross_caches = jax.tree.map(
        lambda c: jnp.broadcast_to(c, (c.shape[0], w, *c.shape[2:])),
        tfm.precompute_cross_caches(dec, lc, memory[None], valid_lens=n_enc.reshape(1)))

    l_pad = tfm.padded_cache_len(max_tokens)
    bias_table = relative_position_bias(
        dec["attn_bias"], jnp.arange(max_tokens), jnp.arange(l_pad), False, cfg)

    def forward(tok, caches, pos):
        # token at buffer index pos-1 -> cache/bias position pos-1
        h = jnp.take(params["token_embs"], tok, axis=0)
        bias = lax.dynamic_slice(bias_table, (0, pos - 1, 0), (bias_table.shape[0], 1, l_pad))
        h, caches = _t5_decode_layers(dec, cfg, h, caches, cross_caches, bias, None, pos - 1)
        return linear(params["classifier"], rms_norm(dec["norm"], h))[:, 0], caches

    pad_rows = jnp.full((w, 1), pad_id, jnp.int32)
    last_logits, self_caches = forward(pad_rows, self_caches, 1)
    buf = jnp.zeros((w, max_tokens), jnp.int32).at[:, 0].set(pad_id)

    gather = lambda caches, idx: jax.tree.map(lambda c: jnp.take(c, idx, axis=0), caches)
    return beam_decode_loop(forward, gather, self_caches, last_logits[0], buf,
                            1, max_tokens, w, eos_id, alpha)


_t5_beam = partial(jax.jit, static_argnums=(1, 4, 7))(_t5_beam_body)


def _t5_spec_decode_state(params, cfg: T5Config, enc_tokens, n_enc, cache_len: int):
    """Encode + build one model's decode-side state for speculative decoding:
    ``(self_caches, cross_caches, bias_table, l_pad)``."""
    p_len = enc_tokens.shape[0]
    enc_valid = jnp.arange(p_len) < n_enc
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[None, None, :]
    x = jnp.take(params["token_embs"], enc_tokens, axis=0)
    memory = t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)

    dec = params["decoder"]
    lc = cfg.layer
    self_caches = tfm.make_kv_cache(cfg.n_layers, (), lc.n_heads, cache_len, lc.head_dim,
                                    dtype=params["token_embs"].dtype, stacked=False)
    cross_caches = tfm.precompute_cross_caches(dec, lc, memory, valid_lens=n_enc)
    l_pad = tfm.padded_cache_len(cache_len)
    bias_table = relative_position_bias(
        dec["attn_bias"], jnp.arange(cache_len), jnp.arange(l_pad), False, cfg)
    return self_caches, cross_caches, bias_table, l_pad


def _t5_spec_chunk_forward(params, cfg: T5Config, cross_caches, bias_table,
                           l_pad: int, chunk, caches, pos):
    """Cached decoder forward of a (S,) chunk at positions ``[pos, pos+S)``
    (the verify path; S=1 is a draft step). Returns ``(logits (S, V), caches)``."""
    s = chunk.shape[0]
    h = jnp.take(params["token_embs"], chunk, axis=0)  # (S, d)
    bias = lax.dynamic_slice(bias_table, (0, pos, 0), (bias_table.shape[0], s, l_pad))
    dec = params["decoder"]
    h, caches = _t5_decode_layers(dec, cfg, h, caches, cross_caches, bias, None, pos)
    return linear(params["classifier"], rms_norm(dec["norm"], h)), caches


def _t5_spec_body(params, cfg: T5Config, draft_params, draft_cfg: "T5Config",
                  enc_tokens, max_tokens: int, n_enc, pad_id, eos_id, k: int):
    """Greedy speculative seq2seq generation: a smaller T5 drafts k tokens,
    the target verifies them in one KV-cached (k+1)-position decoder chunk
    (models/text/speculative.py greedy core — token-identical to
    :func:`_t5_generate` for ANY draft). Both models encode ``enc_tokens``
    with their own encoders; buffers run to ``max_tokens + k`` so the edge
    stop never truncates below the plain loop's cap."""
    from .speculative import spec_greedy_decode_loop

    l_buf = max_tokens + k
    t_caches, t_cross, t_bias, t_lpad = _t5_spec_decode_state(
        params, cfg, enc_tokens, n_enc, l_buf)
    d_caches, d_cross, d_bias, d_lpad = _t5_spec_decode_state(
        draft_params, draft_cfg, enc_tokens, n_enc, l_buf)

    def verify_chunk(chunk, caches, pos):
        lg, caches = _t5_spec_chunk_forward(params, cfg, t_cross, t_bias, t_lpad,
                                            chunk, caches, pos)
        return jnp.argmax(lg, axis=-1).astype(jnp.int32), caches

    def draft_step(tok, caches, pos):
        lg, caches = _t5_spec_chunk_forward(draft_params, draft_cfg, d_cross, d_bias,
                                            d_lpad, tok, caches, pos)
        return jnp.argmax(lg[0], axis=-1).astype(jnp.int32), caches

    # decoder position 0 = the pad start token; the target's first step
    # yields token 1, the draft prefills position 0 (logits discarded)
    buf = jnp.zeros((l_buf,), jnp.int32).at[0].set(pad_id)
    first, t_caches = verify_chunk(buf[:1], t_caches, 0)
    _, d_caches = draft_step(buf[:1], d_caches, 0)
    buf = buf.at[1].set(first[0])

    buf, length = spec_greedy_decode_loop(
        draft_step, verify_chunk, t_caches, d_caches, buf, 2,
        first[0] == eos_id, max_tokens, k, eos_id, l_buf)
    return buf, length


_t5_speculative_generate = partial(jax.jit, static_argnums=(1, 3, 5, 9))(_t5_spec_body)


@partial(jax.jit, static_argnums=(1, 3, 5, 9))
def _t5_speculative_generate_batch(params, cfg: T5Config, draft_params,
                                   draft_cfg: "T5Config", enc_bufs, max_tokens: int,
                                   n_encs, pad_id, eos_id, k: int):
    """Batched greedy seq2seq speculative decoding: vmap of the unbatched
    loop over B rows (per-row encoder input/valid length/acceptance; the
    batched while_loop runs until every row's cond closes). Decoder weights
    broadcast, so each draft/verify step reads them ONCE for all rows.

    ``enc_bufs``: (B, P) RIGHT-padded rows; ``n_encs``: (B,). Caller must
    pass configs with ``attn_impl="xla"``: per-row cache positions under vmap
    rule out the decode kernel (see
    models/text/speculative.py:_speculative_generate_batch)."""
    core = lambda enc, n: _t5_spec_body(params, cfg, draft_params, draft_cfg,
                                        enc, max_tokens, n, pad_id, eos_id, k)
    return jax.vmap(core)(enc_bufs, n_encs)


@partial(jax.jit, static_argnums=(1,))
def _t5_score(params, cfg: T5Config, enc_buf, n_enc, dec_buf, n_dec):
    """Teacher-forced seq2seq log-probs. ``enc_buf``: (B, P) right-padded
    inputs with lengths ``n_enc``; ``dec_buf``: (B, T) decoder rows
    ``[pad] + targets`` right-padded with target lengths ``n_dec``. Returns
    (B, T-1) fp32 ``log p(y_t | y_<t, x)``, zeroed past each row's targets."""
    b, p_len = enc_buf.shape
    enc_valid = jnp.arange(p_len)[None, :] < n_enc[:, None]
    pad_bias = jnp.where(enc_valid, 0.0, NEG_INF).astype(jnp.float32)[:, None, None, :]
    x = jnp.take(params["token_embs"], enc_buf, axis=0)
    memory = t5_encoder_apply(params["encoder"], cfg, x, pad_bias=pad_bias)
    logits = t5_decode(params, cfg, dec_buf, memory, ca_bias=pad_bias)
    logp = jax.nn.log_softmax(logits[:, :-1].astype(jnp.float32), axis=-1)
    tgt = dec_buf[:, 1:].astype(jnp.int32)
    ll = jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    return ll * (jnp.arange(dec_buf.shape[1] - 1)[None, :] < n_dec[:, None])


class T5Model(InferenceModel):
    """Public surface mirrors the reference T5Model (t5.py:134-201)."""

    def __init__(self, vocab_size: int, dim: int, n_heads: int, n_layers: int, mlp_dim: int,
                 dropout: float = 0.0, rng: int = 0) -> None:
        self.cfg = T5Config(vocab_size, dim, n_heads, n_layers, mlp_dim)
        self.params = t5_init(jax.random.PRNGKey(rng), self.cfg)

    def encode(self, tokens) -> jnp.ndarray:
        return t5_encode(self.params, self.cfg, jnp.asarray(tokens))

    def decode(self, tokens, memory) -> jnp.ndarray:
        return t5_decode(self.params, self.cfg, jnp.asarray(tokens), memory)

    def __call__(self, x, targets) -> jnp.ndarray:
        return self.decode(targets, self.encode(x))

    forward = __call__

    @staticmethod
    def from_t5x(model_tag: str, *, pretrained: bool = False, **kwargs) -> "T5Model":
        variant, _, size = model_tag.rpartition("-")
        dim, n_heads, n_layers, mlp_dim = SIZES[size]
        vocab_size = 250112 if variant.startswith("mt5") else 32128  # ref t5.py:164
        m = T5Model(vocab_size, dim, n_heads, n_layers, mlp_dim, **kwargs)
        if pretrained:
            from .t5x_loader import get_checkpoint_location, load_t5x_checkpoint

            m.load_t5x_state_dict(load_t5x_checkpoint(get_checkpoint_location(variant, size)))
        return m

    def load_t5x_state_dict(self, flat: dict) -> None:
        """Map flattened t5x keys to our pytree (rename table per ref t5.py:230-252).

        t5x kernels are stored (in, out) — already our layout (the reference
        transposes to torch layout, t5.py:174-175); q/k kernels are scaled by
        ``64**0.25`` to fold T5X's unscaled attention into SDPA (t5.py:176-177).
        """
        sd = StateDict(flat)
        qk_scale = 64**0.25
        cfg = self.cfg

        def lin(key, scale=1.0):
            return {"w": sd.pop(key) * scale}

        def stack(prefix: str, cross: bool) -> dict:
            layers = []
            for i in range(cfg.n_layers):
                b = f"{prefix}.layers_{i}"
                sa = f"{b}.self_attention" if cross else f"{b}.attention"
                lp = {
                    "sa_norm": {"scale": sd.pop(f"{b}.pre_self_attention_layer_norm.scale" if cross
                                                else f"{b}.pre_attention_layer_norm.scale")},
                    "sa": {
                        "q": lin(f"{sa}.query.kernel", qk_scale),
                        "k": lin(f"{sa}.key.kernel", qk_scale),
                        "v": lin(f"{sa}.value.kernel"),
                        "o": lin(f"{sa}.out.kernel"),
                    },
                    "mlp_norm": {"scale": sd.pop(f"{b}.pre_mlp_layer_norm.scale")},
                    "mlp": {
                        "w": lin(f"{b}.mlp.wi_0.kernel"),
                        "v": lin(f"{b}.mlp.wi_1.kernel"),
                        "wo": lin(f"{b}.mlp.wo.kernel"),
                    },
                }
                if cross:
                    ca = f"{b}.encoder_decoder_attention"
                    lp["ca_norm"] = {"scale": sd.pop(f"{b}.pre_cross_attention_layer_norm.scale")}
                    lp["ca"] = {
                        "q": lin(f"{ca}.query.kernel", qk_scale),
                        "k": lin(f"{ca}.key.kernel", qk_scale),
                        "v": lin(f"{ca}.value.kernel"),
                        "o": lin(f"{ca}.out.kernel"),
                    }
                layers.append(lp)
            return {
                "attn_bias": sd.pop(f"{prefix}.relpos_bias.rel_embedding"),
                "layers": stack_layers([jax.tree.map(jnp.asarray, l) for l in layers]),
                "norm": {"scale": sd.pop(f"{prefix}.encoder_norm.scale" if prefix == "encoder"
                                         else f"{prefix}.decoder_norm.scale")},
            }

        p = {
            "token_embs": jnp.asarray(sd.pop("token_embedder.embedding")),
            "encoder": stack("encoder", False),
            "decoder": stack("decoder", True),
            "classifier": {"w": jnp.asarray(sd.pop("decoder.logits_dense.kernel"))},
        }
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)

    @staticmethod
    def get_tokenizer(model_tag: str, cache: str = "tokenizers"):
        """Download + cache the sentencepiece model (ref t5.py:184-201)."""
        from pathlib import Path

        import sentencepiece as spm

        location = "mc4.250000.100extra" if model_tag.startswith("mt5") else "cc_all.32000.100extra"
        cache_path = Path(cache) / location
        # crash-safe cache: download into a .part dir and atomically rename, so
        # a failed download never leaves a half-empty dir that reads as a hit
        # (same pattern as utils/download.py hub_download)
        if not cache_path.exists():
            import os
            import shutil

            import requests

            part = cache_path.with_name(cache_path.name + ".part")
            shutil.rmtree(part, ignore_errors=True)
            part.mkdir(parents=True)
            base = "https://storage.googleapis.com/t5-data/vocabs"
            for filename in ("sentencepiece.model", "sentencepiece.vocab"):
                resp = requests.get(f"{base}/{location}/{filename}", timeout=60)
                resp.raise_for_status()
                with open(part / filename, "wb") as f:
                    f.write(resp.content)
            os.replace(part, cache_path)
        return spm.SentencePieceProcessor(str(cache_path / "sentencepiece.model"))


ENC_BUCKET = 64


class T5Generator:
    """Greedy encoder-decoder generation (reference T5Generator, t5.py:205-227),
    with KV-cached on-device decode instead of per-token full re-decode."""

    def __init__(self, model_tag: str | None = None, model: T5Model | None = None, tokenizer=None) -> None:
        self.model = model if model is not None else T5Model.from_t5x(model_tag, pretrained=True)
        self.tokenizer = tokenizer if tokenizer is not None else T5Model.get_tokenizer(model_tag)

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        token_ids = self.tokenizer.Encode(prompt, add_eos=True)
        out = self.generate_tokens(token_ids, max_tokens, self.tokenizer.pad_id(), self.tokenizer.eos_id())
        return self.tokenizer.Decode(out)

    def generate_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int, eos_id: int) -> list[int]:
        n = len(token_ids)
        pad = -(-n // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((pad,), np.int32)
        buf[:n] = token_ids
        out, length = _t5_generate(self.model.params, self.model.cfg, jnp.asarray(buf), n, max_tokens, pad_id, eos_id)
        return np.asarray(out)[: int(length)].tolist()

    def generate_beam(self, prompt: str, max_tokens: int = 100, beam_width: int = 4,
                      length_penalty: float = 0.0) -> str:
        """Beam-search generation (new vs the reference's greedy-only loop)."""
        token_ids = self.tokenizer.Encode(prompt, add_eos=True)
        out = self.generate_beam_tokens(token_ids, max_tokens, self.tokenizer.pad_id(),
                                        self.tokenizer.eos_id(), beam_width, length_penalty)
        return self.tokenizer.Decode(out)

    def generate_beam_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int,
                             eos_id: int, beam_width: int = 4, length_penalty: float = 0.0,
                             return_all: bool = False):
        """Beam-search continuation; returns the best token sequence (pad +
        generated + EOS, like :meth:`generate_tokens`), or ``(sequences,
        scores)`` for all ``beam_width`` beams when ``return_all`` (best
        first; scores are length-penalized log-probs — models/text/beam.py)."""
        assert beam_width >= 1
        assert length_penalty >= 0.0, "negative length_penalty breaks the early-stop bound"
        n = len(token_ids)
        pad = -(-n // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((pad,), np.int32)
        buf[:n] = token_ids
        seqs, scores, lens = _t5_beam(
            self.model.params, self.model.cfg, jnp.asarray(buf), jnp.int32(n),
            max_tokens, pad_id, eos_id, beam_width, float(length_penalty))
        seqs, scores, lens = np.asarray(seqs), np.asarray(scores), np.asarray(lens)
        outs = [seqs[i, : lens[i]].tolist() for i in range(beam_width)]
        if return_all:
            return outs, scores.tolist()
        return outs[0]

    def score(self, prompt: str, target: str) -> list[float]:
        """Per-token ``log p(y_t | y_<t, x)`` of ``target`` given ``prompt``
        (teacher-forced, one jitted forward; new vs the reference)."""
        inp = self.tokenizer.Encode(prompt, add_eos=True)
        tgt = self.tokenizer.Encode(target, add_eos=True)
        return self.score_tokens(inp, tgt, self.tokenizer.pad_id())

    def score_tokens(self, input_ids: list[int], target_ids: list[int], pad_id: int) -> list[float]:
        return self.score_tokens_batch([input_ids], [target_ids], pad_id)[0]

    def score_tokens_batch(self, input_lists: list[list[int]], target_lists: list[list[int]],
                           pad_id: int) -> list[list[float]]:
        """Batched teacher-forced scoring over right-padded rows."""
        b = len(input_lists)
        assert len(target_lists) == b
        assert all(len(ts) >= 1 for ts in target_lists), "empty target"
        p = -(-max(len(ts) for ts in input_lists) // ENC_BUCKET) * ENC_BUCKET
        t_len = -(-(max(len(ts) for ts in target_lists) + 1) // 16) * 16
        enc = np.zeros((b, p), np.int32)
        dec = np.zeros((b, t_len), np.int32)
        n_enc = np.zeros((b,), np.int32)
        n_dec = np.zeros((b,), np.int32)
        for i, (inp, tgt) in enumerate(zip(input_lists, target_lists)):
            enc[i, : len(inp)] = inp
            n_enc[i] = len(inp)
            dec[i, 0] = pad_id
            dec[i, 1: 1 + len(tgt)] = tgt
            n_dec[i] = len(tgt)
        ll = np.asarray(_t5_score(self.model.params, self.model.cfg, jnp.asarray(enc),
                                  jnp.asarray(n_enc), jnp.asarray(dec), jnp.asarray(n_dec)))
        return [ll[i, : n_dec[i]].tolist() for i in range(b)]

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        """Batched greedy generation (new vs the reference's single-prompt loop)."""
        token_lists = [self.tokenizer.Encode(p, add_eos=True) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens, self.tokenizer.pad_id(), self.tokenizer.eos_id())
        return [self.tokenizer.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int, pad_id: int,
                              eos_id: int) -> list[list[int]]:
        b = len(token_lists)
        max_n = max(len(ts) for ts in token_lists)
        pad = -(-max_n // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((b, pad), np.int32)
        n_enc = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            n_enc[i] = len(ts)
        out, lengths = _t5_generate_batch(self.model.params, self.model.cfg, jnp.asarray(buf),
                                          jnp.asarray(n_enc), max_tokens, pad_id, eos_id)
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, : lengths[i]].tolist() for i in range(b)]


class SpeculativeT5Generator:
    """T5Generator accelerated by a smaller draft T5 (e.g. t5-small drafting
    for t5-large). Greedy and EXACT: output is token-identical to
    :meth:`T5Generator.generate` for ANY draft — accepted drafts equal the
    target argmax by construction, the first mismatch is replaced by it
    (models/text/speculative.py cores; capability beyond the reference).
    Draft and target must share the sentencepiece vocabulary."""

    def __init__(self, model: T5Model, draft_model: T5Model, tokenizer, k: int = 4) -> None:
        assert model.cfg.vocab_size == draft_model.cfg.vocab_size, \
            "draft and target must share a vocabulary"
        assert k >= 1
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k

    @classmethod
    def with_truncated_draft(cls, model: T5Model, tokenizer, n_layers: int,
                             k: int = 4) -> "SpeculativeT5Generator":
        """Zero-extra-weights speculative serving: the draft is the target's
        own first ``n_layers`` of BOTH stacks (shared embeddings, rel-pos
        tables, final norms, classifier). Output stays token-identical to
        :class:`T5Generator` for any draft; depth only moves the
        speed/acceptance trade-off (models/text/speculative.py)."""
        from dataclasses import replace
        from types import SimpleNamespace

        assert 1 <= n_layers <= model.cfg.n_layers
        dp = dict(model.params)
        for stack in ("encoder", "decoder"):
            sd = dict(model.params[stack])
            sd["layers"] = jax.tree.map(lambda a: a[:n_layers], sd["layers"])
            dp[stack] = sd
        draft = SimpleNamespace(params=dp,
                                cfg=replace(model.cfg, n_layers=n_layers))
        return cls(model, draft, tokenizer, k)

    def generate(self, prompt: str, max_tokens: int = 100) -> str:
        token_ids = self.tokenizer.Encode(prompt, add_eos=True)
        out = self.generate_tokens(token_ids, max_tokens, self.tokenizer.pad_id(),
                                   self.tokenizer.eos_id())
        return self.tokenizer.Decode(out)

    def generate_tokens(self, token_ids: list[int], max_tokens: int, pad_id: int,
                        eos_id: int) -> list[int]:
        """Row layout matches :meth:`T5Generator.generate_tokens`: pad token
        at index 0, generation from index 1, first EOS included."""
        n = len(token_ids)
        pad = -(-n // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((pad,), np.int32)
        buf[:n] = token_ids
        out, length = _t5_speculative_generate(
            self.model.params, self.model.cfg, self.draft_model.params,
            self.draft_model.cfg, jnp.asarray(buf), max_tokens, jnp.int32(n),
            pad_id, eos_id, self.k)
        out = np.asarray(out)[: int(length)]
        hits = np.nonzero(out[1:] == eos_id)[0]  # truncate at the first EOS
        if hits.size:
            out = out[: hits[0] + 2]
        return out.tolist()

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        token_lists = [self.tokenizer.Encode(p, add_eos=True) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens,
                                          self.tokenizer.pad_id(), self.tokenizer.eos_id())
        return [self.tokenizer.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int,
                              pad_id: int, eos_id: int) -> list[list[int]]:
        """Batched :meth:`generate_tokens`: B rows draft+verify together with
        per-row acceptance (vmapped loop; decoder weights read once per step
        for all rows). Token-identical per row to the unbatched path."""
        from dataclasses import replace

        b = len(token_lists)
        ns = [len(t) for t in token_lists]
        assert b >= 1 and min(ns) >= 1
        pad = -(-max(ns) // ENC_BUCKET) * ENC_BUCKET
        bufs = np.zeros((b, pad), np.int32)  # RIGHT-padded rows
        for i, t in enumerate(token_lists):
            bufs[i, : ns[i]] = t

        # the vmapped loop can't batch the decode kernel (per-row cache
        # positions): trace with the einsum attention path
        cfg_x = replace(self.model.cfg, attn_impl="xla")
        dcfg_x = replace(self.draft_model.cfg, attn_impl="xla")
        outs, lengths = _t5_speculative_generate_batch(
            self.model.params, cfg_x, self.draft_model.params, dcfg_x,
            jnp.asarray(bufs), max_tokens, jnp.asarray(ns, jnp.int32),
            pad_id, eos_id, self.k)
        outs, lengths = np.asarray(outs), np.asarray(lengths)
        res = []
        for i in range(b):
            out = outs[i, : lengths[i]]
            hits = np.nonzero(out[1:] == eos_id)[0]  # truncate at the first EOS
            if hits.size:
                out = out[: hits[0] + 2]
            res.append(out.tolist())
        return res
