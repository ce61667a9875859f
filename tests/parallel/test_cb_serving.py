"""Tensor-parallel continuous batching on the 8-device virtual CPU mesh.

Each request scheduled through the tp-sharded slot pool must be
token-identical to the single-device plain greedy generator — admission
masking, epoch resets, and the head-sharded decode compose exactly."""

import jax
import pytest

from pytorch_models_tpu.parallel import make_mesh
from pytorch_models_tpu.parallel.cb_serving import TPContinuousBatchingGenerator

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


class Tok:
    eos_token_id = 9


def _tiny_gpt2(n_layers=2):
    from pytorch_models_tpu.models.text import GPT2

    GPT2.vocab_size, GPT2.max_seq_len = 128, 128
    try:
        return GPT2(n_layers, 256)  # 4 heads
    finally:
        GPT2.vocab_size, GPT2.max_seq_len = 50257, 1024


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_cb_matches_single_device_per_request(tp):
    from pytorch_models_tpu.models.text import DecoderGenerator

    m = _tiny_gpt2()
    requests = [[5, 6, 7], [9] * 12, [11, 12], [3] * 7, [8, 1, 2, 6], [4] * 5]
    budgets = [8, 5, 11, 8, 3, 9]
    plain = DecoderGenerator(m, Tok())
    ref = [plain.generate_tokens(r, max_tokens=mt) for r, mt in zip(requests, budgets)]

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=3,
                                        prompt_bucket=16, check_every=4)
    outs = gen.generate_tokens_many(requests, budgets)
    assert outs == ref


def test_tp_cb_epoch_reset_path(tp=2):
    """More work than one epoch fits: the pool must drain, reset, and still
    reproduce every request."""
    from pytorch_models_tpu.models.text import DecoderGenerator

    m = _tiny_gpt2()
    requests = [[5, 6, 7]] * 6 + [[9] * 10] * 6
    plain = DecoderGenerator(m, Tok())
    ref = [plain.generate_tokens(r, max_tokens=40) for r in requests]

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2,
                                        prompt_bucket=16, check_every=8)
    outs = gen.generate_tokens_many(requests, 40)
    assert outs == ref


def test_tp_cb_shared_prefix_matches_single_device(tp=2):
    """Prefix caching under tp: the prefix KV is computed once per rank
    (head-sharded) and pasted at admission; outputs stay token-identical to
    the single-device generator on prefix + request."""
    from pytorch_models_tpu.models.text import DecoderGenerator

    m = _tiny_gpt2()
    prefix = [2, 7, 1, 8, 2, 8]
    requests = [[5, 6, 7], [9] * 12, [11, 12], [3] * 7]
    budgets = [8, 5, 11, 6]
    plain = DecoderGenerator(m, Tok())
    ref = [plain.generate_tokens(prefix + r, max_tokens=mt)
           for r, mt in zip(requests, budgets)]

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2,
                                        prompt_bucket=16, check_every=4)
    outs = gen.generate_tokens_many(requests, budgets, shared_prefix=prefix)
    assert outs == ref


def test_tp_cb_sampling_matches_single_device(tp=2):
    """Sampling under tp: hidden is psum-complete and token_embs/keys are
    replicated, so per-rank draws agree — outputs must equal the
    single-device pool's (same schedule-invariant fold_in chain)."""
    from pytorch_models_tpu.models.text import ContinuousBatchingGenerator

    m = _tiny_gpt2()
    requests = [[5, 6, 7], [9] * 12, [11, 12]]
    budgets = [8, 5, 9]
    kw = dict(topk=4, temperature=0.9, seed=7)
    ref = ContinuousBatchingGenerator(m, Tok(), batch_size=2, prompt_bucket=16,
                                      check_every=4).generate_tokens_many(
                                          requests, budgets, **kw)

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2,
                                        prompt_bucket=16, check_every=4)
    outs = gen.generate_tokens_many(requests, budgets, **kw)
    assert outs == ref


def test_tp_cb_cache_is_head_sharded():
    m = _tiny_gpt2()
    mesh = make_mesh(4, shape=(4,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2)
    caches = gen._init_pool(gen._sharded_params, m.cfg, 2)
    k = caches["k"]
    assert k.sharding.shard_shape(k.shape)[-1] == k.shape[-1] // 4


@pytest.mark.parametrize("tp", [2])
def test_tp_whisper_cb_matches_single_device_per_segment(tp):
    import numpy as np

    from pytorch_models_tpu.models.audio2text.whisper import Whisper, WhisperGenerator
    from pytorch_models_tpu.parallel.cb_serving import TPWhisperContinuousBatchingGenerator

    m = Whisper(vocab_size=64, n_layers=2, d_model=128)  # 2 heads
    rng = np.random.default_rng(7)
    audios = [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(4)]
    init = [50, 51]
    plain = WhisperGenerator(m)
    ref = [plain.transcribe_tokens(a, init, 63, max_tokens=10) for a in audios]

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPWhisperContinuousBatchingGenerator(m, mesh, batch_size=2,
                                               check_every=3, pool_ctx=48)
    outs = gen.transcribe_tokens_many(audios, init, 63, max_tokens=10)
    assert outs == ref


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_t5_cb_matches_single_device_per_request(tp):
    import numpy as np

    from pytorch_models_tpu.models.text import T5Generator, T5Model
    from pytorch_models_tpu.parallel.cb_serving import TPT5ContinuousBatchingGenerator

    m = T5Model(vocab_size=96, dim=64, n_heads=4, n_layers=2, mlp_dim=128)
    rng = np.random.default_rng(13)
    requests = [rng.integers(2, 96, size=n).tolist() for n in (5, 30, 11, 68, 3)]
    plain = T5Generator(model=m, tokenizer=object())
    ref = [plain.generate_tokens(ts, 14, 0, 1) for ts in requests]

    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPT5ContinuousBatchingGenerator(m, mesh, batch_size=2, check_every=4,
                                          pool_ctx=64)
    outs = gen.generate_tokens_many(requests, 14, 0, 1)
    assert outs == ref


def test_tp_cb_chunked_prefill_long_prompts(tp=2):
    """Prompts longer than prompt_bucket admit via the sharded chunk/paste
    programs and stay token-identical to single-device, with and without a
    shared prefix."""
    from pytorch_models_tpu.models.text import DecoderGenerator

    m = _tiny_gpt2()
    requests = [[i % 120 for i in range(2, 41)], [5, 6], [i * 3 % 117 for i in range(19)]]
    budgets = [6, 9, 5]
    plain = DecoderGenerator(m, Tok())
    mesh = make_mesh(tp, shape=(tp,), axes=("tp",))
    gen = TPContinuousBatchingGenerator(m, Tok(), mesh, batch_size=2,
                                        prompt_bucket=16, check_every=4)
    assert gen.generate_tokens_many(requests, budgets) == [
        plain.generate_tokens(r, max_tokens=mt) for r, mt in zip(requests, budgets)]

    prefix = [7, 3, 1, 8, 2]
    got = gen.generate_tokens_many(requests, budgets, shared_prefix=prefix)
    assert got == [plain.generate_tokens(prefix + r, max_tokens=mt)
                   for r, mt in zip(requests, budgets)]
