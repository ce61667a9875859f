"""T5 continuous batching must be token-identical, per request, to the plain
greedy generator — including requests admitted mid-flight into slots whose
self/cross caches hold a previous request's stale state, and across epoch
resets. The pool's one global rel-pos bias table must reproduce each row's
shifted relative positions exactly."""

import numpy as np
import pytest

from pytorch_models_tpu.text import (
    T5ContinuousBatchingGenerator,
    T5Generator,
    T5Model,
)

TINY = dict(vocab_size=120, dim=64, n_heads=4, n_layers=2, mlp_dim=128)
PAD, EOS = 0, 1


@pytest.fixture(scope="module")
def model():
    return T5Model(**TINY)


@pytest.fixture(scope="module")
def plain(model):
    return T5Generator(model=model, tokenizer=object())


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(2, 120, size=n).tolist() for n in (5, 37, 12, 70, 3)]


def _oracle(plain, prompts, max_tokens):
    return [plain.generate_tokens(ts, max_tokens, PAD, EOS) for ts in prompts]


def test_pool_matches_plain_per_request(model, plain, prompts):
    """More requests than slots: mid-flight admissions against stale self-KV
    AND stale cross-KV (different prompt lengths) must reproduce every
    output."""
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                       pool_ctx=128)
    outs = cb.generate_tokens_many(prompts, 24, PAD, EOS)
    assert outs == _oracle(plain, prompts, 24)


def test_epoch_reset(model, plain, prompts):
    """A pool context small enough that the position budget runs out
    mid-queue: drain, rewind, re-admit — still exact."""
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=8,
                                       pool_ctx=40)
    outs = cb.generate_tokens_many(prompts, 18, PAD, EOS)
    assert outs == _oracle(plain, prompts, 18)


def test_single_slot_pool(model, plain, prompts):
    cb = T5ContinuousBatchingGenerator(model, batch_size=1, check_every=5,
                                       pool_ctx=64)
    outs = cb.generate_tokens_many(prompts[:3], 20, PAD, EOS)
    assert outs == _oracle(plain, prompts[:3], 20)


def test_empty_queue(model):
    cb = T5ContinuousBatchingGenerator(model, batch_size=2)
    assert cb.generate_tokens_many([], 16, PAD, EOS) == []


def test_fused_step_path_matches_plain(model, plain, prompts, request):
    """Under the GPU decode route (kernel in interpret mode) the T5 pool
    stays per-op — rel-pos-biased self-attention, full-length cross memory —
    with per-row pad_lens, and matches the plain generator."""
    base = _oracle(plain, prompts[:3], 16)
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=3, pool_ctx=64)
    assert cb.generate_tokens_many(prompts[:3], 16, PAD, EOS) == base
    assert calls["traces"] == 0


def test_streaming_callback_delivers_every_token_once(model, plain, prompts):
    """on_tokens streams each generated token exactly once, in order, at
    scheduling-point granularity — concatenated deliveries equal the final
    output minus the leading pad token (with mid-flight admissions)."""
    streams = {i: [] for i in range(len(prompts))}
    calls = []
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                       pool_ctx=128)
    outs = cb.generate_tokens_many(
        prompts, 24, PAD, EOS,
        on_tokens=lambda r, ts: (streams[r].extend(ts), calls.append((r, len(ts)))))
    assert outs == _oracle(plain, prompts, 24)
    for i, out in enumerate(outs):
        assert streams[i] == out[1:]
    assert all(1 <= n <= 4 for _, n in calls)


def _sampling_oracle(model, request, max_tokens, seed, req_idx, topk, top_p, temp):
    """The documented sampling chain — generated token g of request r draws
    ``fold_in(fold_in(PRNGKey(seed), r), g)`` — computed with full UNCACHED
    forwards, independent of the pool/cache machinery under test."""
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text.generator import _sample

    memory = model.encode(jnp.asarray(request)[None])
    key_r = jax.random.fold_in(jax.random.PRNGKey(seed), req_idx)
    toks = [PAD]
    g = 0
    while len(toks) < max_tokens:
        logits = model.decode(jnp.asarray(toks)[None], memory)[0, -1]
        toks.append(int(_sample(logits, jax.random.fold_in(key_r, g), topk, top_p, temp)))
        g += 1
        if toks[-1] == EOS:
            break
    return toks


def test_sampling_schedule_invariant(model, prompts):
    """topk/temperature serving: request r's sample stream depends only on
    (seed, r) — identical across pool sizes and check_every — and matches
    the documented fold_in chain of uncached forwards."""
    kw = dict(topk=5, temperature=0.9, seed=3)
    cb_a = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                         pool_ctx=128)
    cb_b = T5ContinuousBatchingGenerator(model, batch_size=1, check_every=1,
                                         pool_ctx=128)
    outs = cb_a.generate_tokens_many(prompts[:3], 14, PAD, EOS, **kw)
    assert outs == cb_b.generate_tokens_many(prompts[:3], 14, PAD, EOS, **kw)
    assert outs == [_sampling_oracle(model, r, 14, 3, i, 5, None, 0.9)
                    for i, r in enumerate(prompts[:3])]


def test_serving_stats(model, prompts):
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=4,
                                       pool_ctx=128)
    outs = cb.generate_tokens_many(prompts[:4], 12, PAD, EOS)
    st = cb.last_stats
    assert st.requests == st.admissions == 4
    assert st.tokens_generated == sum(len(o) - 1 for o in outs)
    assert 0.0 < st.occupancy <= 1.0 and st.wall_time_s > 0


def test_per_request_sampling_params(model, prompts):
    """Per-request temperature/top_p lists: each request's stream equals a
    solo-pool run with that request's scalar params at the same index r."""
    temps, tps = [0.7, 1.2, 1.0], [0.9, 0.6, 0.95]
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=3,
                                       pool_ctx=128)
    mixed = cb.generate_tokens_many(prompts[:3], 12, PAD, EOS, topk=6,
                                    top_p=tps, temperature=temps, seed=5)
    for r in range(3):
        solo = T5ContinuousBatchingGenerator(model, batch_size=1, check_every=1,
                                             pool_ctx=128)
        outs = solo.generate_tokens_many(prompts[: r + 1], 12, PAD, EOS, topk=6,
                                         top_p=tps[r], temperature=temps[r], seed=5)
        assert mixed[r] == outs[r]


def test_megakernel_pool_matches_plain(prompts, request):
    """A pool at a width with several heads (4 heads of 64) under the GPU
    decode route == the plain generator; the kernel is never traced."""
    model = T5Model(vocab_size=120, dim=128, n_heads=4, n_layers=2, mlp_dim=256)
    plain = T5Generator(model=model, tokenizer=object())
    base = [plain.generate_tokens(ts, 12, PAD, EOS) for ts in prompts[:3]]
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = T5ContinuousBatchingGenerator(model, batch_size=2, check_every=3, pool_ctx=64)
    assert cb.generate_tokens_many(prompts[:3], 12, PAD, EOS) == base
    assert calls["traces"] == 0
