"""int8 KV in the TENSOR-PARALLEL continuous-batching pools.

int8 K/V shard on the head width and dequantize on read per rank; the
per-key f32 scales replicate (every rank quantizes with the FULL-width scale —
quantize_rows pmaxes the absmax over the tp axis). Outputs must be
TOKEN-IDENTICAL to the single-device int8 pool under the same flags (not to
bf16 — int8 changes numerics by design).
"""

import jax
import numpy as np
import pytest

from pytorch_models_tpu.parallel import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


class Tok:
    eos_token_id = 9


def _tiny_gpt2(n_layers=2):
    from pytorch_models_tpu.models.text import GPT2

    GPT2.vocab_size, GPT2.max_seq_len = 128, 128
    try:
        return GPT2(n_layers, 256)  # 4 heads; 256/tp=2 keeps ranks lane-aligned
    finally:
        GPT2.vocab_size, GPT2.max_seq_len = 50257, 1024


def test_tp_int8_gpt_pool_matches_single_device_int8(int8_modes, tp=2):
    from pytorch_models_tpu.models.text.continuous import ContinuousBatchingGenerator
    from pytorch_models_tpu.parallel.cb_serving import TPContinuousBatchingGenerator

    m = _tiny_gpt2()
    requests = [[5, 6, 7], [9] * 12, [11, 12], [3] * 7, [8, 1, 2, 6]]
    budgets = [8, 5, 11, 8, 3]

    reads = int8_modes(self_kv=True)
    sd = ContinuousBatchingGenerator(m, Tok(), batch_size=2, prompt_bucket=16,
                                     check_every=4)
    ref = sd.generate_tokens_many(requests, budgets)

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2,
                                        prompt_bucket=16, check_every=4)
    n = reads["n"]
    assert gen.generate_tokens_many(requests, budgets) == ref
    assert reads["n"] > n  # non-vacuous: the TP pool read int8 caches


def test_tp_int8_whisper_pool_matches_single_device_int8(int8_modes, tp=2):
    from pytorch_models_tpu.models.audio2text.whisper import Whisper
    from pytorch_models_tpu.models.audio2text.continuous import (
        WhisperContinuousBatchingGenerator,
    )
    from pytorch_models_tpu.parallel.cb_serving import (
        TPWhisperContinuousBatchingGenerator,
    )

    m = Whisper(vocab_size=100, n_layers=2, d_model=256, n_mels=80)  # 4 heads
    rng = np.random.default_rng(11)
    audios = [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(3)]
    init, eot = [50, 51, 52], 99

    reads = int8_modes(self_kv=True, cross_kv=True)
    sd = WhisperContinuousBatchingGenerator(m, batch_size=2, check_every=4,
                                            pool_ctx=64)
    ref = sd.transcribe_tokens_many(audios, init, eot, max_tokens=12)

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPWhisperContinuousBatchingGenerator(m, mesh, batch_size=2,
                                               check_every=4, pool_ctx=64)
    n = reads["n"]
    assert gen.transcribe_tokens_many(audios, init, eot, max_tokens=12) == ref
    assert reads["n"] > n


def test_tp_int8_t5_cross_pool_matches_single_device_int8(int8_modes, tp=2):
    """T5 under TP with int8 cross caches (write-once encoder K/V)."""
    from pytorch_models_tpu.models.text import T5Model
    from pytorch_models_tpu.models.text.t5_continuous import (
        T5ContinuousBatchingGenerator,
    )
    from pytorch_models_tpu.parallel.cb_serving import TPT5ContinuousBatchingGenerator

    m = T5Model(vocab_size=96, dim=256, n_heads=4, n_layers=2, mlp_dim=256)
    rng = np.random.default_rng(13)
    requests = [rng.integers(2, 96, size=n).tolist() for n in (5, 17, 11)]

    reads = int8_modes(cross_kv=True)
    sd = T5ContinuousBatchingGenerator(m, batch_size=2, check_every=4, pool_ctx=64)
    ref = sd.generate_tokens_many(requests, 12, 0, 1)

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPT5ContinuousBatchingGenerator(m, mesh, batch_size=2, check_every=4,
                                          pool_ctx=64)
    n = reads["n"]
    assert gen.generate_tokens_many(requests, 12, 0, 1) == ref
    assert reads["n"] > n


def test_tp_int8_cache_sharding(tp=4):
    """int8 pool layout: int8 K/V of the pool's shape with per-key scales."""
    from pytorch_models_tpu.ops.int8_kv import quantize_kv

    m = _tiny_gpt2()
    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    from pytorch_models_tpu.parallel.cb_serving import TPContinuousBatchingGenerator

    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2)
    caches = quantize_kv(gen._init_pool(gen._sharded_params, m.cfg, 2))
    assert caches["k"].dtype.name == "int8"
    assert caches["ks"].shape == caches["k"].shape[:-1] == (m.cfg.n_layers, 2, 128)
