"""Whisper continuous batching must be token-identical, per segment, to the
plain greedy generator — including segments admitted mid-flight into slots
whose self/cross caches hold a previous transcript's stale state, and across
epoch resets."""

import numpy as np
import pytest

from pytorch_models_tpu.audio2text import (
    Whisper,
    WhisperContinuousBatchingGenerator,
    WhisperGenerator,
)

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)
INIT = [50, 51, 52]
EOT = 99


@pytest.fixture(scope="module")
def model():
    return Whisper(**TINY)


@pytest.fixture(scope="module")
def plain(model):
    return WhisperGenerator(model)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(7)
    return [(rng.standard_normal(16000) * 0.1).astype(np.float32) for _ in range(5)]


def _oracle(plain, audios, max_tokens):
    return [plain.transcribe_tokens(a, INIT, EOT, max_tokens=max_tokens) for a in audios]


def test_pool_matches_plain_per_segment(model, plain, audios):
    """More segments than slots: mid-flight admissions against stale
    self-KV AND stale cross-KV must reproduce every transcript."""
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                            pool_ctx=128)
    outs = cb.transcribe_tokens_many(audios, INIT, EOT, max_tokens=24)
    assert outs == _oracle(plain, audios, 24)


def test_epoch_reset(model, plain, audios):
    """A pool context small enough that the position budget runs out
    mid-queue: drain, rewind, re-admit — still exact."""
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=8,
                                            pool_ctx=40)
    outs = cb.transcribe_tokens_many(audios, INIT, EOT, max_tokens=18)
    assert outs == _oracle(plain, audios, 18)


def test_single_slot_pool(model, plain, audios):
    cb = WhisperContinuousBatchingGenerator(model, batch_size=1, check_every=5,
                                            pool_ctx=64)
    outs = cb.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=20)
    assert outs == _oracle(plain, audios[:3], 20)


def test_empty_queue(model):
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2)
    assert cb.transcribe_tokens_many([], INIT, EOT) == []


def test_fused_step_path_matches_plain(model, plain, audios, request):
    """The GPU route: pooled decode with self/cross reads through the Triton
    decode kernel and per-row pad_lens (interpret mode)."""
    base = _oracle(plain, audios[:3], 16)
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=3, pool_ctx=64)
    assert cb.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=16) == base
    assert calls["traces"] > 0


def test_streaming_callback_delivers_every_token_once(model, plain, audios):
    """on_tokens streams each transcript token exactly once, in order, at
    scheduling-point granularity — concatenated deliveries equal the final
    output minus the initial tokens (with mid-flight admissions)."""
    streams = {i: [] for i in range(len(audios))}
    calls = []
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                            pool_ctx=128)
    outs = cb.transcribe_tokens_many(
        audios, INIT, EOT, max_tokens=24,
        on_tokens=lambda r, ts: (streams[r].extend(ts), calls.append((r, len(ts)))))
    assert outs == _oracle(plain, audios, 24)
    for i, out in enumerate(outs):
        assert streams[i] == out[len(INIT):]
    assert all(1 <= n <= 4 for _, n in calls)


def _sampling_oracle(model, audio, max_tokens, seed, req_idx, topk, top_p, temp):
    """The documented sampling chain — transcript token g of segment r draws
    ``fold_in(fold_in(PRNGKey(seed), r), g)`` — computed with full UNCACHED
    forwards, independent of the pool/cache machinery under test."""
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.audio2text.whisper import WhisperPreprocessor
    from pytorch_models_tpu.models.text.generator import _sample

    padded = np.pad(audio, (0, 30 * 16000 - len(audio)))
    mel = WhisperPreprocessor("tiny")(padded)[None]
    key_r = jax.random.fold_in(jax.random.PRNGKey(seed), req_idx)
    toks = list(INIT)
    g = 0
    while len(toks) < max_tokens:
        logits = model(mel, jnp.asarray(toks)[None])[0, -1]
        toks.append(int(_sample(logits, jax.random.fold_in(key_r, g), topk, top_p, temp)))
        g += 1
        if toks[-1] == EOT:
            break
    return toks


def test_sampling_schedule_invariant(model, audios):
    """topk/temperature transcription serving: segment r's sample stream
    depends only on (seed, r) — identical across pool sizes and check_every —
    and matches the documented fold_in chain of uncached forwards."""
    kw = dict(topk=5, temperature=0.9, seed=3)
    cb_a = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                              pool_ctx=128)
    cb_b = WhisperContinuousBatchingGenerator(model, batch_size=1, check_every=1,
                                              pool_ctx=128)
    outs = cb_a.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=14, **kw)
    assert outs == cb_b.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=14, **kw)
    assert outs == [_sampling_oracle(model, a, 14, 3, i, 5, None, 0.9)
                    for i, a in enumerate(audios[:3])]


def test_long_audio_windows_match_plain_long_form(model, plain):
    """>30 s audios: every window schedules through the pool and the
    per-window outputs equal WhisperGenerator.transcribe_long_tokens's
    independent-window mode, per audio."""
    rng = np.random.default_rng(13)
    longs = [(rng.standard_normal(16000 * 70) * 0.1).astype(np.float32),   # 3 windows
             (rng.standard_normal(16000 * 12) * 0.1).astype(np.float32)]   # 1 window
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                            pool_ctx=128)
    got = cb.transcribe_long_tokens_many(longs, INIT, EOT, max_tokens=12)
    want = [plain.transcribe_long_tokens(a, INIT, EOT, sot_prev_id=None,
                                         max_tokens=12, batch_size=2)
            for a in longs]
    assert got == want
    assert [len(w) for w in got] == [3, 1]


def test_serving_stats(model, audios):
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                            pool_ctx=128)
    outs = cb.transcribe_tokens_many(audios[:4], INIT, EOT, max_tokens=12)
    st = cb.last_stats
    assert st.requests == st.admissions == 4
    assert st.tokens_generated == sum(len(o) - len(INIT) for o in outs)
    assert 0.0 < st.occupancy <= 1.0 and st.wall_time_s > 0


def test_per_request_sampling_params(model, audios):
    """Per-segment temperature/top_p lists: each segment's stream equals a
    solo-pool run with that segment's scalar params at the same index r."""
    temps, tps = [0.8, 1.1, 0.95], [0.85, 0.6, 0.9]
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=3,
                                            pool_ctx=128)
    mixed = cb.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=12,
                                      topk=6, top_p=tps, temperature=temps, seed=5)
    for r in range(3):
        solo = WhisperContinuousBatchingGenerator(model, batch_size=1, check_every=1,
                                                  pool_ctx=128)
        outs = solo.transcribe_tokens_many(audios[: r + 1], INIT, EOT, max_tokens=12,
                                           topk=6, top_p=tps[r], temperature=temps[r],
                                           seed=5)
        assert mixed[r] == outs[r]


def test_batched_admission_encodes(model, plain, audios):
    """A scheduling point admitting several segments runs ONE batched encoder
    forward (bucketed); outputs stay token-identical per segment."""
    cb = WhisperContinuousBatchingGenerator(model, batch_size=4, check_every=4,
                                            pool_ctx=128)
    outs = cb.transcribe_tokens_many(audios, INIT, EOT, max_tokens=12)
    assert outs == _oracle(plain, audios, 12)
    assert cb.last_stats.admissions == len(audios)


def test_megakernel_pool_matches_plain(audios, request):
    """Decode-kernel pool at a width with several heads (d_model 128: two
    64-wide heads, each its own kernel program) == the plain generator."""
    model = Whisper(vocab_size=100, n_layers=2, d_model=128, n_mels=80)
    base = _oracle(WhisperGenerator(model), audios[:3], 14)
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = WhisperContinuousBatchingGenerator(model, batch_size=2, check_every=3, pool_ctx=64)
    assert cb.transcribe_tokens_many(audios[:3], INIT, EOT, max_tokens=14) == base
    assert calls["traces"] > 0
