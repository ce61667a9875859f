"""w8a8 encoder linear (ops.layers.USE_A8_LINEAR): wiring + accuracy.

The int8 x int8 -> int32 dot is exact, so the kernel-free XLA path is its
own oracle: a replication of the quantize -> dot -> rescale math must match
bit-for-bit. Model-level accuracy is bounded against the bf16 dense path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pytorch_models_tpu.ops import layers as layers_mod
from pytorch_models_tpu.ops.layers import linear
from pytorch_models_tpu.utils.params import quantize_tree_int8
from tests.oracle import rng


def _quant_linear_params(r, d, out, bias=True):
    p = {"w": jnp.asarray(r.standard_normal((d, out)), jnp.float32)}
    if bias:
        p["b"] = jnp.asarray(r.standard_normal((out,)), jnp.float32)
    return quantize_tree_int8({"fc1": p})["fc1"]


def test_a8_linear_matches_int_oracle():
    r = rng(251)
    d, out = 128, 256
    qp = _quant_linear_params(r, d, out)
    assert qp["w"]["w_q"].dtype == jnp.int8
    x = jnp.asarray(r.standard_normal((2, 5, d)), jnp.bfloat16)  # 3D input

    layers_mod.USE_A8_LINEAR = True
    try:
        got = linear(qp, x)
    finally:
        layers_mod.USE_A8_LINEAR = False

    # oracle: identical math in plain jnp
    x32 = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(x32), axis=-1, keepdims=True)
    r_s = jnp.where(absmax == 0.0, 1.0, absmax) * (1.0 / 127.0)
    xq = jnp.clip(jnp.round(x32 / r_s), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq.reshape(-1, d), qp["w"]["w_q"],
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    ref = (acc.reshape(2, 5, out).astype(jnp.float32) * r_s
           * qp["w"]["w_s"].astype(jnp.float32)).astype(jnp.bfloat16)
    ref = ref + qp["b"].astype(ref.dtype)
    np.testing.assert_array_equal(np.asarray(got, np.float32),
                                  np.asarray(ref, np.float32))
    assert got.dtype == jnp.bfloat16


def test_a8_linear_close_to_dense_and_off_by_default():
    r = rng(252)
    d, out = 256, 256
    p = {"w": jnp.asarray(r.standard_normal((d, out)) / np.sqrt(d), jnp.float32),
         "b": jnp.asarray(0.1 * r.standard_normal((out,)), jnp.float32)}
    qp = quantize_tree_int8({"fc1": p})["fc1"]
    x = jnp.asarray(r.standard_normal((8, d)), jnp.float32)

    dense = np.asarray(linear(p, x), np.float32)
    w8a16 = np.asarray(linear(qp, x), np.float32)  # flag off: cast path
    layers_mod.USE_A8_LINEAR = True
    try:
        w8a8 = np.asarray(linear(qp, x), np.float32)
    finally:
        layers_mod.USE_A8_LINEAR = False

    scale = np.abs(dense).max()
    assert np.abs(w8a16 - dense).max() / scale < 2e-2
    assert np.abs(w8a8 - dense).max() / scale < 3e-2  # adds activation quant
    assert not np.array_equal(w8a8, w8a16)


def test_a8_vit_end_to_end_accuracy():
    """Synthetic ViT: w8a8 logits stay within quantization noise of the bf16
    dense forward (all projections + MLP + pooler/head run the int8 path)."""
    from pytorch_models_tpu.models.image.vit import ViT, vit_apply
    from pytorch_models_tpu.utils.params import cast_tree

    model = ViT.from_google("Ti/16_augreg")
    params = cast_tree(model.params, jnp.bfloat16)
    x = jnp.asarray(rng(253).standard_normal((2, 3, 224, 224)) * 0.5, jnp.bfloat16)
    base = np.asarray(vit_apply(params, model.cfg, x), np.float32)

    qparams = quantize_tree_int8(params)
    layers_mod.USE_A8_LINEAR = True
    try:
        jax.clear_caches()
        a8 = np.asarray(vit_apply(qparams, model.cfg, x), np.float32)
    finally:
        layers_mod.USE_A8_LINEAR = False
        jax.clear_caches()

    scale = max(np.abs(base).max(), 1.0)
    rel = np.abs(a8 - base).max() / scale
    assert rel < 8e-2, rel
    # feature direction preserved: cosine per row
    cos = (a8 * base).sum(-1) / (np.linalg.norm(a8, axis=-1) * np.linalg.norm(base, axis=-1))
    assert cos.min() > 0.99, cos


def test_a8_full_whisper_serving_smoke(monkeypatch):
    """Full w8a8 serving (the BENCH_DTYPE=int8_a8 whisper path): int8 weights
    + USE_A8_LINEAR in every decoder and cross-KV projection must run
    end-to-end and produce valid tokens."""
    from pytorch_models_tpu.models.audio2text.whisper import (
        Whisper,
        _whisper_generate_batch_body,
    )

    m = Whisper(vocab_size=64, n_layers=2, d_model=128)
    m.params = jax.tree.map(
        lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, m.params)
    m = m.quantize_int8()
    r = rng(254)
    memory = jnp.asarray(r.standard_normal((2, 64, 128)) * 0.3, jnp.bfloat16)
    init = jnp.asarray([3, 5], jnp.int32)

    monkeypatch.setattr(layers_mod, "USE_A8_LINEAR", True)
    jax.clear_caches()
    try:
        buf, n = _whisper_generate_batch_body(m.params, m.cfg, memory, init, 12, eot_id=-1)
        buf, n = np.asarray(buf), np.asarray(n)
    finally:
        jax.clear_caches()
    assert buf.shape == (2, 12) and (n == 12).all()
    assert ((buf >= 0) & (buf < 64)).all()
