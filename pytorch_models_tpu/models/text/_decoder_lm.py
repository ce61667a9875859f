"""Shared decoder-only LM core for GPT / GPT-2.

Token + learned position embeddings → causal Decoder stack → weight-tied
logits (reference text/gpt.py:25-30, text/gpt2.py:21-27). Adds what the
reference lacks: a KV-cached fixed-shape forward used by the jitted decode
loop (the reference re-forwards the whole prefix per token,
text/generator.py:23-24).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from ... import transformer as tfm
from ...ops import layer_norm


@dataclass(frozen=True)
class DecoderLMConfig:
    vocab_size: int
    max_seq_len: int
    n_layers: int
    d_model: int
    pre_norm: bool
    final_norm: bool
    act: str = "approximate_gelu"
    norm_eps: float = 1e-5
    # "xla" forces the einsum attention path (no kernel dispatch) — used by
    # code that runs the cached forward under vmap (batched speculative),
    # where per-row cache positions rule out the decode kernel.
    attn_impl: str = "auto"
    # Tensor-parallel serving (parallel/serving.py): under shard_map each rank
    # holds local_heads = n_heads/tp heads and all-reduces over tp_axis.
    local_heads: int | None = None
    tp_axis: str | None = None

    @property
    def layer(self) -> tfm.LayerConfig:
        heads = ({} if self.local_heads is None
                 else {"n_heads": self.local_heads, "head_dim": 64})
        return tfm.LayerConfig.make(
            self.d_model, **({"n_heads": self.d_model // 64} | heads), act=self.act,
            pre_norm=self.pre_norm, norm_eps=self.norm_eps, tp_axis=self.tp_axis,
            attn_impl=self.attn_impl,
        )


def decoder_lm_init(key, cfg: DecoderLMConfig) -> dict:
    k_emb, k_dec = jax.random.split(key)
    p = {
        "token_embs": jax.random.normal(k_emb, (cfg.vocab_size, cfg.d_model), jnp.float32),
        "pos_embs": jnp.zeros((cfg.max_seq_len, cfg.d_model), jnp.float32),
        "decoder": tfm.decoder_init(k_dec, cfg.n_layers, cfg.layer),
    }
    if cfg.final_norm:
        p["norm"] = tfm.ln_init(cfg.d_model)
    return p


def _final_hidden(params: dict, cfg: DecoderLMConfig, x: jnp.ndarray) -> jnp.ndarray:
    return layer_norm(params["norm"], x, cfg.norm_eps) if cfg.final_norm else x


def _head(params: dict, cfg: DecoderLMConfig, x: jnp.ndarray) -> jnp.ndarray:
    x = _final_hidden(params, cfg, x)
    from ...ops.layers import dot_precision

    return jnp.matmul(x, params["token_embs"].astype(x.dtype).T, precision=dot_precision(x))


def decoder_lm_apply(params: dict, cfg: DecoderLMConfig, tokens: jnp.ndarray) -> jnp.ndarray:
    """Full forward over ``(..., L)`` int tokens (batched or unbatched)."""
    x = jnp.take(params["token_embs"], tokens, axis=0)
    x = x + params["pos_embs"][: tokens.shape[-1]].astype(x.dtype)
    x = tfm.decoder_apply(params["decoder"], cfg.layer, x)
    return _head(params, cfg, x)


def decoder_lm_forward_cached(params: dict, cfg: DecoderLMConfig, tokens: jnp.ndarray, caches: dict, pos):
    """Forward a token chunk placed at positions ``[pos, pos+S)`` against the KV cache.

    ``tokens``: (S,) int32. Returns ``(logits (S, V), new_caches)``.
    """
    s = tokens.shape[0]
    x = jnp.take(params["token_embs"], tokens, axis=0)
    x = x + lax.dynamic_slice(params["pos_embs"], (pos, 0), (s, cfg.d_model)).astype(x.dtype)
    x, caches = tfm.decoder_apply(params["decoder"], cfg.layer, x, self_caches=caches, pos=pos)
    return _head(params, cfg, x), caches


def decoder_lm_make_cache(cfg: DecoderLMConfig, batch_shape: tuple = (), dtype=jnp.float32,
                          stacked: bool = True):
    lc = cfg.layer
    return tfm.make_kv_cache(cfg.n_layers, batch_shape, lc.n_heads, cfg.max_seq_len, lc.head_dim, dtype,
                             stacked=stacked)


def decoder_lm_forward_cached_batch(params, cfg: DecoderLMConfig, tokens, pos_ids, caches, pos, pad_lens):
    """Batched cached forward with per-row position ids (left-padded decode).

    ``tokens``: (B, S) placed at cache slots ``[pos, pos+S)``; ``pos_ids``:
    (B, S) per-row position-embedding indices; ``pad_lens``: (B,) left-pad
    length per row, masked inside attention (and handled natively by the
    decode kernel). Returns ``(logits, caches)``.
    """
    x = jnp.take(params["token_embs"], tokens, axis=0)
    x = x + jnp.take(params["pos_embs"], pos_ids, axis=0).astype(x.dtype)
    x, caches = tfm.decoder_apply(params["decoder"], cfg.layer, x, self_caches=caches, pos=pos,
                                  pad_lens=pad_lens)
    return _head(params, cfg, x), caches


def decoder_lm_hidden_cached_batch(params, cfg: DecoderLMConfig, tokens, pos_ids, caches, pos, pad_lens):
    """Like :func:`decoder_lm_forward_cached_batch` but stops at the final
    (normed) hidden state (prefill passes that need no logits)."""
    x = jnp.take(params["token_embs"], tokens, axis=0)
    x = x + jnp.take(params["pos_embs"], pos_ids, axis=0).astype(x.dtype)
    x, caches = tfm.decoder_apply(params["decoder"], cfg.layer, x, self_caches=caches, pos=pos,
                                  pad_lens=pad_lens)
    return _final_hidden(params, cfg, x), caches
