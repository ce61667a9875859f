"""Cached per-op decode == the uncached forward.

Every decoder family decodes one position (or a short chunk) against a KV
cache that an earlier cached prefill filled; the result must match a plain
forward over the whole sequence without any cache. Row b's reference runs on
its own un-padded tokens ``x[b, pad_b:]``, so left pads, per-row valid
memory and cache masking are all checked against a path that has none.

Configurations: the (cache length, position) grid, position 0, multi-token
chunks, list vs layer-stacked caches, unbatched rows, post-norm layers,
cross-attention over right-padded memory, T5's relative-position bias, left
pads, int8 weights, w8a8 linears and int8 KV caches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_models_tpu.transformer as tfm
from pytorch_models_tpu.ops import layers
from pytorch_models_tpu.ops.int8_kv import quantize_kv
from pytorch_models_tpu.utils.params import quantize_tree_int8
from tests.oracle import rng

D, H, N_LAYERS = 128, 2, 2
# fp32 paths agree to float rounding; int8 weights / w8a8 compute in bf16;
# int8 KV adds per-key rounding of every cached K/V row
TOL = {"fp32": 2e-4, "int8": 3e-2, "w8a8": 5e-2, "int8_kv": 6e-2}


def _prepare(params, mode, monkeypatch):
    if mode in ("int8", "w8a8"):
        params = quantize_tree_int8(params)
    if mode == "w8a8":
        monkeypatch.setattr(layers, "USE_A8_LINEAR", True)
    return params


def _close(got, want, mode):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if mode == "int8_kv":  # relative to the output range
        assert np.abs(got - want).max() / np.abs(want).max() < TOL[mode]
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[mode], atol=TOL[mode])


# ---------------------------------------------------------------------------
# decoder-only (GPT / GPT-2): causal self-attention
# ---------------------------------------------------------------------------

GPT_CASES = {
    # name: (l_max, pos, chunk, batch, pads, stacked, pre_norm, mode)
    "l128_pos0": (128, 0, 1, 2, None, False, True, "fp32"),
    "l128_pos37": (128, 37, 1, 4, None, False, True, "fp32"),
    "l128_pos127": (128, 127, 1, 2, None, False, True, "fp32"),
    "l256_pos200": (256, 200, 1, 2, None, False, True, "fp32"),
    "l1024_pos960": (1024, 960, 1, 2, None, False, True, "fp32"),
    "l1024_pos1023_b1": (1024, 1023, 1, 1, None, False, True, "fp32"),
    "left_pads_l128": (128, 37, 1, 4, (0, 1, 5, 0), False, True, "fp32"),
    "left_pads_l256": (256, 200, 1, 4, (0, 3, 100, 199), False, True, "fp32"),
    "unbatched": (128, 50, 1, None, None, False, True, "fp32"),
    "stacked_l128": (128, 37, 1, 4, (0, 2, 0, 1), True, True, "fp32"),
    "stacked_l1024": (1024, 960, 1, 2, None, True, True, "fp32"),
    "post_norm": (128, 37, 1, 2, None, False, False, "fp32"),
    "chunk4": (128, 37, 4, 2, None, False, True, "fp32"),
    "int8_weights": (128, 37, 1, 2, None, False, True, "int8"),
    "w8a8": (128, 37, 1, 2, (0, 4), False, True, "w8a8"),
    "int8_kv": (256, 200, 1, 2, (0, 9), False, True, "int8_kv"),
    "int8_kv_stacked": (256, 120, 1, 2, None, True, True, "int8_kv"),
}


@pytest.mark.parametrize("case", list(GPT_CASES))
def test_decoder_lm_cached_step_matches_uncached(case, monkeypatch):
    l_max, pos, s, b, pads, stacked, pre_norm, mode = GPT_CASES[case]
    cfg = tfm.LayerConfig.make(D, n_heads=H, act="approximate_gelu", pre_norm=pre_norm)
    params = _prepare(tfm.decoder_init(jax.random.PRNGKey(0), N_LAYERS, cfg), mode, monkeypatch)
    shape = (pos + s, D) if b is None else (b, pos + s, D)
    x = jnp.asarray(rng(len(case)).standard_normal(shape), jnp.float32)
    pad_lens = None if pads is None else jnp.asarray(pads, jnp.int32)

    caches = tfm.make_kv_cache(N_LAYERS, () if b is None else (b,), H, l_max, D // H,
                               stacked=stacked)
    if pos:
        _, caches = tfm.decoder_apply(params, cfg, x[..., :pos, :], self_caches=caches, pos=0,
                                      pad_lens=pad_lens)
    if mode == "int8_kv":
        caches = quantize_kv(caches)
    out, _ = tfm.decoder_apply(params, cfg, x[..., pos:, :], self_caches=caches, pos=pos,
                               pad_lens=pad_lens)

    rows = [x] if b is None else [x[i:i + 1, (pads or [0] * b)[i]:] for i in range(b)]
    want = [tfm.decoder_apply(params, cfg, r)[..., -s:, :] for r in rows]
    _close(out, want[0] if b is None else jnp.concatenate(want, 0), mode)


# ---------------------------------------------------------------------------
# encoder-decoder (Whisper): causal self-attention + cross-attention over
# right-padded memory with per-row valid lengths
# ---------------------------------------------------------------------------

CROSS_CASES = {
    # name: (l_max, pos, l_mem, valid_lens, pads, mode)
    "l128_pos21_full_memory": (128, 21, 40, (40, 40, 40, 40), None, "fp32"),
    "l128_pos21_valid_lens": (128, 21, 40, (40, 17, 3, 40), None, "fp32"),
    "l1024_pos960_mem1024": (1024, 960, 1024, (1000, 17, 3, 640), None, "fp32"),
    "b1_l512_mem512": (512, 37, 512, (409,), None, "fp32"),
    "pos0": (128, 0, 40, (40, 9), None, "fp32"),
    "left_pads": (128, 21, 40, (40, 17, 3, 40), (0, 2, 0, 1), "fp32"),
    "int8_cross_kv": (128, 21, 300, (300, 150), None, "int8_kv"),
    "int8_self_and_cross_kv": (256, 100, 300, (300, 77), (0, 5), "int8_kv"),
    "w8a8_b1_pos0": (128, 0, 40, (33,), None, "w8a8"),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_decoder_cached_step_matches_uncached(case, monkeypatch):
    l_max, pos, l_mem, valid, pads, mode = CROSS_CASES[case]
    b = len(valid)
    r = rng(100 + len(case))
    cfg = tfm.LayerConfig.make(D, n_heads=H, cross_attn=True)
    params = _prepare(tfm.decoder_init(jax.random.PRNGKey(1), N_LAYERS, cfg), mode, monkeypatch)
    x = jnp.asarray(r.standard_normal((b, pos + 1, D)), jnp.float32)
    memory = jnp.asarray(r.standard_normal((b, l_mem, D)), jnp.float32)
    pad_lens = None if pads is None else jnp.asarray(pads, jnp.int32)

    cross = tfm.precompute_cross_caches(params, cfg, memory, jnp.asarray(valid, jnp.int32))
    caches = tfm.make_kv_cache(N_LAYERS, (b,), H, l_max, D // H, stacked=False)
    if pos:
        _, caches = tfm.decoder_apply(params, cfg, x[:, :pos], self_caches=caches,
                                      cross_caches=cross, pos=0, pad_lens=pad_lens)
    if mode == "int8_kv":
        cross = quantize_kv(cross)
        if pads is not None:
            caches = quantize_kv(caches)
    out, _ = tfm.decoder_apply(params, cfg, x[:, pos:], self_caches=caches, cross_caches=cross,
                               pos=pos, pad_lens=pad_lens)

    want = jnp.concatenate([
        tfm.decoder_apply(params, cfg, x[i:i + 1, (pads or [0] * b)[i]:],
                          memory=memory[i:i + 1, :valid[i]])[:, -1:]
        for i in range(b)], 0)
    _close(out, want, mode)


# ---------------------------------------------------------------------------
# T5: relative-position bias on self-attention, RMSNorm, GEGLU, cross over
# per-row valid memory
# ---------------------------------------------------------------------------

T5_CASES = {
    # name: (pos, valid_lens, pads, mode)
    "pos0": (0, (24, 11), None, "fp32"),
    "pos13": (13, (24, 11, 5), None, "fp32"),
    "pos100": (100, (24, 24), None, "fp32"),
    "left_pads": (13, (24, 11, 5), (0, 4, 12), "fp32"),
    "int8_weights": (13, (24, 11), None, "int8"),
    "int8_self_kv_with_bias": (40, (24, 11), None, "int8_kv"),
}


@pytest.mark.parametrize("case", list(T5_CASES))
def test_t5_cached_step_matches_uncached(case, monkeypatch):
    from pytorch_models_tpu.models.text.t5 import (
        NEG_INF,
        T5Config,
        _t5_decode_layers,
        relative_position_bias,
        rms_norm,
        t5_block_apply,
        t5_decoder_apply,
        t5_stack_init,
    )

    pos, valid, pads, mode = T5_CASES[case]
    b, l_max, l_mem = len(valid), 128, 24
    r = rng(200 + len(case))
    cfg = T5Config(vocab_size=100, dim=D, n_heads=H, n_layers=N_LAYERS, mlp_dim=256)
    dec = t5_stack_init(jax.random.PRNGKey(2), cfg, True)
    dec["attn_bias"] = jnp.asarray(r.standard_normal(dec["attn_bias"].shape), jnp.float32)
    dec = _prepare(dec, mode, monkeypatch)
    x = jnp.asarray(r.standard_normal((b, pos + 1, D)), jnp.float32)
    memory = jnp.asarray(r.standard_normal((b, l_mem, D)), jnp.float32)
    pad_lens = None if pads is None else jnp.asarray(pads, jnp.int32)

    lc = cfg.layer
    cross = tfm.precompute_cross_caches(dec, lc, memory, jnp.asarray(valid, jnp.int32))
    table = relative_position_bias(dec["attn_bias"], jnp.arange(l_max), jnp.arange(l_max), False, cfg)
    if pad_lens is None:  # the generators' unrolled step over per-layer caches
        caches = tfm.make_kv_cache(N_LAYERS, (b,), H, l_max, 64, stacked=False)
        if pos:
            _, caches = _t5_decode_layers(dec, cfg, x[:, :pos], caches, cross, table[:, :pos],
                                          None, 0)
        if mode == "int8_kv":
            caches = quantize_kv(caches)
        out, _ = _t5_decode_layers(dec, cfg, x[:, pos:], caches, cross, table[:, pos:pos + 1],
                                   None, pos)
    else:  # the pool's pad-aware step: cache_layer writes into stacked caches
        def step(h, caches, start, stop):
            for i in range(N_LAYERS):
                lp = jax.tree.map(lambda a: a[i], dec["layers"])
                cc = jax.tree.map(lambda a: a[i], cross)
                h, caches = t5_block_apply(lp, cfg, h, attn_bias=table[:, start:stop],
                                           self_cache=caches, cross_cache=cc, pos=start,
                                           cache_layer=i, pad_lens=pad_lens)
            return h, caches

        caches = tfm.make_kv_cache(N_LAYERS, (b,), H, l_max, 64, stacked=True)
        if pos:
            _, caches = step(x[:, :pos], caches, 0, pos)
        out, _ = step(x[:, pos:], caches, pos, pos + 1)
    out = rms_norm(dec["norm"], out)

    rows = []
    for i in range(b):
        p = (pads or [0] * b)[i]
        ca_bias = jnp.where(jnp.arange(l_mem) < valid[i], 0.0, NEG_INF)[None, None, None, :]
        rows.append(t5_decoder_apply(dec, cfg, x[i:i + 1, p:], memory[i:i + 1],
                                     ca_bias=ca_bias)[:, -1:])
    _close(out, jnp.concatenate(rows, 0), mode)
