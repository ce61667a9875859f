"""Triton decode-attention kernel (Pallas interpret mode) vs the einsum path,
and the kernel choice that routes decode reads to it."""

import jax.numpy as jnp
import numpy as np
import pytest

from pytorch_models_tpu.ops.attention import _sdpa_xla, use_decode_kernel
from pytorch_models_tpu.ops.decode_attention import decode_attention, num_splits
from tests.oracle import rng


def _split(x, h):
    b, l, hd = x.shape
    return x.reshape(b, l, h, hd // h).transpose(0, 2, 1, 3)


def _oracle(q, k, v, h, bias):
    qh, kh, vh = _split(q, h), _split(k, h), _split(v, h)
    out = _sdpa_xla(qh, kh, vh, bias, False)  # (B, H, 1, D)
    b = out.shape[0]
    return out.transpose(0, 2, 1, 3).reshape(b, 1, -1)


def _qkv(seed, b, h, l_max, d):
    r = rng(seed)
    return tuple(jnp.asarray(r.standard_normal(s), jnp.float32)
                 for s in ((b, 1, h * d), (b, l_max, h * d), (b, l_max, h * d)))


@pytest.mark.parametrize("pos", [0, 5, 511, 700, 1023])
def test_decode_attention_parity(pos):
    b, h, l_max, d = 2, 3, 1024, 64
    q, k, v = _qkv(161, b, h, l_max, d)
    out = decode_attention(q, k, v, pos + 1, h, interpret=True)

    col = jnp.arange(l_max)
    bias = jnp.where(col <= pos, 0.0, -1e30).astype(jnp.float32)[None, None, None, :]
    expected = _oracle(q, k, v, h, bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5)


def test_decode_attention_unbatched():
    h, l_max, d, pos = 4, 256, 32, 77
    q, k, v = (x[0] for x in _qkv(163, 1, h, l_max, d))
    out = decode_attention(q, k, v, pos + 1, h, interpret=True)

    col = jnp.arange(l_max)
    bias = jnp.where(col <= pos, 0.0, -1e30).astype(jnp.float32)[None, None, None, :]
    expected = _oracle(q[None], k[None], v[None], h, bias)[0]
    assert out.shape == (1, h * d)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5)


def test_decode_attention_per_row_ends():
    """Per-row ends (cross-attention over right-padded memory rows)."""
    b, h, l_max, d = 3, 2, 512, 64
    q, k, v = _qkv(164, b, h, l_max, d)
    ends = jnp.asarray([512, 300, 1], jnp.int32)
    out = decode_attention(q, k, v, ends, h, interpret=True)

    col = jnp.arange(l_max)
    bias = jnp.where(col[None, :] < ends[:, None], 0.0, -1e30).astype(jnp.float32)[:, None, None, :]
    expected = _oracle(q, k, v, h, bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5)


def test_decode_attention_left_padded_rows():
    """Per-row left-pad masking (batched generation) matches the einsum oracle."""
    b, h, l_max, d = 3, 2, 512, 64
    q, k, v = _qkv(162, b, h, l_max, d)
    pos, pads = 300, jnp.asarray([0, 7, 299], jnp.int32)
    out = decode_attention(q, k, v, pos + 1, h, pad_lens=pads, interpret=True)

    col = jnp.arange(l_max)
    valid = (col[None, :] <= pos) & (col[None, :] >= pads[:, None])  # (B, L)
    bias = jnp.where(valid, 0.0, -1e30).astype(jnp.float32)[:, None, None, :]
    expected = _oracle(q, k, v, h, bias)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=2e-5, atol=2e-5)


def test_decode_attention_split_k():
    """A batch too small to fill the card splits the key axis (partial
    results combined outside the kernel); a large one runs one split."""
    assert num_splits(1, 12, 1024) == 16 and num_splits(32, 12, 1024) == 1
    b, h, l_max, d = 1, 2, 512, 64
    q, k, v = _qkv(165, b, h, l_max, d)
    pos, pads = 450, jnp.asarray([3], jnp.int32)
    assert num_splits(b, h, l_max) == 16
    out = decode_attention(q, k, v, pos + 1, h, pad_lens=pads, interpret=True)

    col = jnp.arange(l_max)
    valid = (col <= pos) & (col >= 3)
    bias = jnp.where(valid, 0.0, -1e30).astype(jnp.float32)[None, None, None, :]
    np.testing.assert_allclose(np.asarray(out), np.asarray(_oracle(q, k, v, h, bias)),
                               rtol=2e-5, atol=2e-5)


def test_decode_attention_empty_rows_return_zeros():
    """An empty valid range (an unadmitted pool slot's cross memory) yields
    zeros, in both the single-split and the split-K kernel."""
    for b, h in ((40, 8), (2, 1)):  # 320 programs -> one split; 2 -> split-K
        q, k, v = _qkv(166, b, h, 128, 64)
        ends = jnp.asarray([0] + [64] * (b - 1), jnp.int32)
        out = np.asarray(decode_attention(q, k, v, ends, h, interpret=True))
        assert np.all(out[0] == 0.0) and np.all(np.isfinite(out))
        assert np.any(out[1] != 0.0)


class _Tok:
    eos_token_id = -1

    def encode(self, s):
        return [1, 2, 3]

    def decode(self, t):
        return t


def _tiny_gpt2():
    from pytorch_models_tpu.models.text import GPT2

    GPT2.vocab_size, GPT2.max_seq_len = 128, 128
    try:
        return GPT2(2, 64)
    finally:
        GPT2.vocab_size, GPT2.max_seq_len = 50257, 1024


def test_decode_kernel_end_to_end_generation(request):
    """GPT-2 generation with the decode kernel == the masked-sdpa path."""
    from pytorch_models_tpu.models.text import DecoderGenerator

    gen = DecoderGenerator(_tiny_gpt2(), _Tok())
    baseline = gen.generate_tokens([5, 6, 7], max_tokens=10)
    calls = request.getfixturevalue("decode_kernel_interpret")
    assert gen.generate_tokens([5, 6, 7], max_tokens=10) == baseline
    assert calls["traces"] > 0


def test_decode_kernel_end_to_end_batched_generation(request):
    """LEFT-padded batched generation with the decode kernel engaged (pad_lens
    threaded through decoder_apply/mha_apply) == the masked-sdpa path."""
    from pytorch_models_tpu.models.text import DecoderGenerator

    gen = DecoderGenerator(_tiny_gpt2(), _Tok())
    prompts = [[5, 6, 7], [9] * 40, [11, 12]]  # unequal lengths -> real left-padding
    baseline = gen.generate_tokens_batch(prompts, max_tokens=8)
    calls = request.getfixturevalue("decode_kernel_interpret")
    assert gen.generate_tokens_batch(prompts, max_tokens=8) == baseline
    assert calls["traces"] > 0


def test_decode_kernel_end_to_end_t5_generation(request):
    """T5 stays per-op under the kernel route: its self-attention carries the
    rel-pos bias and its cross-attention memory is valid end to end, so the
    kernel is never traced and generation is unchanged."""
    from pytorch_models_tpu.models.text.t5 import T5Generator, T5Model

    m = T5Model(vocab_size=100, dim=64, n_heads=2, n_layers=2, mlp_dim=128)
    gen = T5Generator(model=m, tokenizer=object())
    prompt = [7, 8, 9, 4, 5]
    baseline = gen.generate_tokens(prompt, 12, 0, 1)
    calls = request.getfixturevalue("decode_kernel_interpret")
    assert gen.generate_tokens(prompt, 12, 0, 1) == baseline
    assert calls["traces"] == 0


@pytest.mark.parametrize("platform,dtype,cache_len,head_dim,has_bias,want", [
    ("gpu", jnp.bfloat16, 1024, 64, False, True),   # GPT-2 decode on the card
    ("gpu", jnp.bfloat16, 1024, 64, True, False),   # T5 rel-pos bias -> per-op
    ("gpu", jnp.float32, 1024, 64, False, False),   # fp32 parity runs -> per-op
    ("cpu", jnp.bfloat16, 1024, 64, False, False),  # no card -> per-op
    ("gpu", jnp.bfloat16, 128, 64, False, False),   # short cache (Whisper self) -> per-op
    ("gpu", jnp.bfloat16, 1040, 64, False, False),  # cache not whole key blocks
    ("gpu", jnp.bfloat16, 1024, 48, False, False),  # head_dim not a power of two
])
def test_decode_kernel_choice(platform, dtype, cache_len, head_dim, has_bias, want):
    assert use_decode_kernel(dtype, cache_len, head_dim, has_bias, platform) is want


@pytest.mark.gpu
def test_decode_kernel_compiled_matches_reference():
    """On the card: the compiled Triton kernel at GPT-2-small's decode width
    (bf16) matches the fp32 einsum reference."""
    import jax

    b, h, l_max, d, pos = 32, 12, 640, 64, 300
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(167, b, h, l_max, d))
    out = decode_attention(q, k, v, pos + 1, h)
    col = jnp.arange(l_max)
    bias = jnp.where(col <= pos, 0.0, -1e30).astype(jnp.float32)[None, None, None, :]
    with jax.default_matmul_precision("highest"):
        want = _oracle(*(x.astype(jnp.float32) for x in (q, k, v)), h, bias)
    assert float(jnp.max(jnp.abs(out.astype(jnp.float32) - want))) < 2e-2
