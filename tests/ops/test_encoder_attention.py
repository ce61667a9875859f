"""Encoder/prefill attention over merged-head projections (transformer.mha_apply
without a cache: project to (B, L, H*D), split heads, ``sdpa``, merge, out-
project) vs a per-head NumPy oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pytorch_models_tpu.transformer as tfm
from tests.oracle import rng


def _np_mha(p, x, mem, h, causal):
    """Per-head float64 reference of the reference's MultiHeadAttention."""
    f = lambda a: np.asarray(a, np.float64)
    lin = lambda q, w: q @ f(w["w"]) + f(w["b"])
    q, k, v = lin(f(x), p["q"]), lin(f(mem), p["k"]), lin(f(mem), p["v"])
    lq, lk, d = q.shape[-2], k.shape[-2], q.shape[-1] // h
    out = np.zeros_like(q)
    for i in range(h):
        sl = slice(i * d, (i + 1) * d)
        s = q[..., sl] @ np.swapaxes(k[..., sl], -1, -2) / np.sqrt(d)
        if causal:
            s = np.where(np.arange(lk)[None, :] <= np.arange(lq)[:, None], s, -np.inf)
        w = np.exp(s - s.max(-1, keepdims=True))
        out[..., sl] = (w / w.sum(-1, keepdims=True)) @ v[..., sl]
    return lin(out, p["o"])


def _case(seed, shape_q, shape_kv, h, d, causal, cross):
    r = rng(seed)
    cfg = tfm.LayerConfig.make(h * d, n_heads=h)
    p = tfm.mha_init(jax.random.PRNGKey(seed), cfg)
    x = jnp.asarray(r.standard_normal(shape_q + (h * d,)), jnp.float32)
    mem = jnp.asarray(r.standard_normal(shape_kv + (h * d,)), jnp.float32) if cross else x
    out = tfm.mha_apply(p, cfg, x, mem if cross else None, causal=causal)
    want = _np_mha(p, x, mem, h, causal)
    np.testing.assert_allclose(np.asarray(out), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize(
    "b,lq,lk,h,d,causal",
    [
        (2, 197, 197, 12, 64, False),  # ViT-B/16
        (2, 197, 197, 12, 64, True),
        (1, 300, 1500, 8, 64, False),  # decoder queries over Whisper-base memory
        (3, 600, 600, 4, 64, True),    # causal prefill
        (2, 64, 64, 4, 32, True),      # head_dim 32
        (2, 384, 384, 6, 64, True),    # BERT-384
    ],
)
def test_encoder_attention_parity(b, lq, lk, h, d, causal):
    _case(171, (b, lq), (b, lk), h, d, causal, cross=lq != lk)


def test_encoder_attention_unbatched():
    _case(172, (50,), (50,), 4, 64, False, cross=False)


def test_encoder_kernel_end_to_end_vit_block():
    """A bf16 ViT-like encoder layer stays within bf16 rounding of fp32."""
    from pytorch_models_tpu.utils.params import cast_tree

    r = rng(173)
    cfg = tfm.LayerConfig.make(128, n_heads=2)
    params = tfm.layer_init(jax.random.PRNGKey(3), cfg)
    x = jnp.asarray(r.standard_normal((2, 30, 128)), jnp.float32)
    ref = tfm.encoder_layer_apply(params, cfg, x)
    out = tfm.encoder_layer_apply(cast_tree(params, jnp.bfloat16), cfg, x.astype(jnp.bfloat16))
    assert out.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(out, np.float32), np.asarray(ref), rtol=5e-2, atol=5e-2)
