"""Continuous batching must be token-identical, per request, to the plain
greedy generator — including requests admitted mid-flight into slots whose
caches hold a previous request's stale state, and across epoch resets.
"""

from types import SimpleNamespace

import jax
import pytest

from pytorch_models_tpu.models.text._decoder_lm import DecoderLMConfig, decoder_lm_init
from pytorch_models_tpu.text import ContinuousBatchingGenerator, DecoderGenerator


class _Tok:
    def __init__(self, eos=-1):
        self.eos_token_id = eos

    def encode(self, s):
        return [ord(c) % 512 for c in s]

    def decode(self, ids):
        return " ".join(map(str, ids))


def _model(seed=0, max_seq_len=256):
    cfg = DecoderLMConfig(vocab_size=512, max_seq_len=max_seq_len, n_layers=2,
                          d_model=128, pre_norm=True, final_norm=True)
    return SimpleNamespace(cfg=cfg, params=decoder_lm_init(jax.random.PRNGKey(seed), cfg))


@pytest.fixture(scope="module")
def model():
    return _model()


PROMPTS = [
    [3, 1, 4, 1, 5],
    [2, 7],
    [9, 2, 6, 5, 3, 5, 8, 9, 7],
    [11],
    [8, 6, 7, 5, 3, 0, 9],
    [1, 2, 3],
    [31, 41, 59],
    [27, 18, 28, 18],
]


def _oracle(model, tok, requests, budgets):
    gen = DecoderGenerator(model, tok)
    return [gen.generate_tokens(r, max_tokens=m) for r, m in zip(requests, budgets)]


def test_staggered_budgets_match_plain(model):
    """More requests than slots + per-request budgets: slots free at
    different steps, so later requests are admitted mid-flight."""
    tok = _Tok()
    budgets = [17, 5, 29, 9, 3, 21, 7, 13]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=3, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(PROMPTS, budgets)
    assert outs == _oracle(model, tok, PROMPTS, budgets)


def test_eos_finish_matches_plain(model):
    """EOS-terminated rows free their slot early; outputs keep the EOS token
    exactly like the plain loop."""
    base = DecoderGenerator(model, _Tok()).generate_tokens(PROMPTS[0], max_tokens=24)
    eos = base[len(PROMPTS[0]) + 4]  # 5th generated token of request 0
    tok = _Tok(eos=eos)
    budgets = [24, 8, 24, 8]
    reqs = PROMPTS[:4]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=3)
    outs = cb.generate_tokens_many(reqs, budgets)
    assert outs == _oracle(model, tok, reqs, budgets)
    assert outs[0][-1] == eos and len(outs[0]) < len(PROMPTS[0]) + 24


def test_epoch_reset(model):
    """max_seq_len small enough that the position budget runs out mid-queue:
    the pool must drain, rewind, and continue correctly on stale buffers."""
    small = _model(seed=3, max_seq_len=64)
    tok = _Tok()
    budgets = [30, 30, 30, 30, 30]
    reqs = PROMPTS[:5]
    # bucket 16 + 30 new <= 64, but two requests back-to-back in one slot
    # exceed 64 -> at least one reset must happen
    cb = ContinuousBatchingGenerator(small, tok, batch_size=2, prompt_bucket=16,
                                     check_every=8)
    outs = cb.generate_tokens_many(reqs, budgets)
    assert outs == _oracle(small, tok, reqs, budgets)


def test_uniform_budget_and_text_api(model):
    tok = _Tok()
    cb = ContinuousBatchingGenerator(model, tok, batch_size=4, prompt_bucket=16)
    outs = cb.generate_many(["abc", "defg"], max_tokens=6)
    plain = DecoderGenerator(model, tok)
    assert outs == [plain.generate(p, max_tokens=6) for p in ["abc", "defg"]]


def test_single_slot_pool(model):
    """batch_size=1 degenerates to sequential serving; still exact."""
    tok = _Tok()
    budgets = [7, 11, 5]
    reqs = PROMPTS[:3]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=1, prompt_bucket=16,
                                     check_every=5)
    assert cb.generate_tokens_many(reqs, budgets) == _oracle(model, tok, reqs, budgets)


def test_rejects_only_max_seq_len(model):
    """Prompts longer than the bucket chunk-prefill; the only hard limit is
    max_seq_len (a prompt leaving no room for a single generated token)."""
    cb = ContinuousBatchingGenerator(model, _Tok(), batch_size=2, prompt_bucket=8)
    with pytest.raises(AssertionError, match="fresh epoch"):
        cb.generate_tokens_many([[1] * 256], 4)  # n == max_seq_len: no room
    big = ContinuousBatchingGenerator(model, _Tok(), batch_size=2, prompt_bucket=64)
    with pytest.raises(AssertionError, match="fresh epoch"):
        big.generate_tokens_many([[1] * 4], 10_000)  # bucket 64 + 255 > 256? clamp -> 64+251>256


def test_chunked_prefill_long_prompts_match_plain(model):
    """Prompts LONGER than prompt_bucket (up to several chunks, odd tails)
    admit via chunked prefill and stay token-identical to the plain
    generator — mixed with short prompts in one pool."""
    tok = _Tok()
    requests = [
        [7] + [i % 512 for i in range(37)],   # 38 = 2 chunks + tail (bucket 16)
        [3, 1, 4],                             # short: ordinary admit
        [i * 7 % 512 for i in range(1, 50)],   # 49 = 4 chunks (one exactly full)
        [i * 3 % 512 for i in range(17)],      # 17 = just over one bucket
    ]
    budgets = [9, 12, 5, 7]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    assert cb.generate_tokens_many(requests, budgets) == _oracle(model, tok, requests, budgets)


def test_chunked_prefill_with_shared_prefix(model):
    """Long suffixes behind a shared prefix: paste + suffix chunks + tail
    admit, token-identical to the plain generator on prefix + request."""
    tok = _Tok()
    prefix = [5, 9, 2, 4, 4, 1, 3]
    requests = [[i % 512 for i in range(2, 40)], [8, 1], [i % 509 for i in range(21)]]
    budgets = [7, 11, 6]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=3)
    got = cb.generate_tokens_many(requests, budgets, shared_prefix=prefix)
    want = _oracle(model, tok, [prefix + r for r in requests], budgets)
    assert got == want


def test_chunked_prefill_epoch_reset(model):
    """A long prompt that cannot fit mid-epoch drains the pool and admits at
    the (long-prompt-sized) fresh epoch base."""
    tok = _Tok()
    requests = [[1, 2, 3], [i % 512 for i in range(100)], [4, 5]]
    budgets = [60, 40, 30]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=5)
    assert cb.generate_tokens_many(requests, budgets) == _oracle(model, tok, requests, budgets)


def test_empty_queue(model):
    cb = ContinuousBatchingGenerator(model, _Tok(), batch_size=2)
    assert cb.generate_tokens_many([], 8) == []


def test_fused_step_path_matches_plain(model, request):
    """The GPU route: _cb_steps with every decode read through the Triton
    decode kernel (interpret mode), with a mid-flight admission against a
    stale cache."""
    tok = _Tok()
    reqs, budgets = PROMPTS[:3], [9, 4, 6]
    base = _oracle(model, tok, reqs, budgets)
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16, check_every=3)
    assert cb.generate_tokens_many(reqs, budgets) == base
    assert calls["traces"] > 0


def test_shared_prefix_matches_plain(model):
    """Prefix caching: outputs must equal the plain generator on
    prefix + request per request, including mid-flight admissions whose
    slots hold a previous request's stale prefix paste."""
    tok = _Tok()
    prefix = [7, 3, 9, 1, 4, 4, 2]
    budgets = [15, 5, 23, 9, 3, 17]
    reqs = PROMPTS[:6]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    assert outs == _oracle(model, tok, [prefix + r for r in reqs], budgets)


def test_long_prefix_exceeds_bucket(model):
    """A prefix longer than prompt_bucket is legal: the per-request prompt
    cap becomes len(prefix) + bucket (the no-prefix path would reject it)."""
    tok = _Tok()
    prefix = [(i * 37) % 512 for i in range(45)]  # kp = 48 > bucket 16
    reqs = PROMPTS[:3]
    budgets = [9, 12, 7]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    assert outs == _oracle(model, tok, [prefix + r for r in reqs], budgets)


def test_prefix_epoch_reset(model):
    """Epoch resets rewind to the prefix-aware base position and re-paste
    into stale slots correctly."""
    small = _model(seed=5, max_seq_len=96)
    tok = _Tok()
    prefix = [5, 8, 13, 21, 34]  # kp = 16, base = 32
    reqs = PROMPTS[:4]
    budgets = [40, 40, 40, 40]  # two back-to-back in one slot exceed 96
    cb = ContinuousBatchingGenerator(small, tok, batch_size=2, prompt_bucket=16,
                                     check_every=8)
    outs = cb.generate_tokens_many(reqs, budgets, shared_prefix=prefix)
    assert outs == _oracle(small, tok, [prefix + r for r in reqs], budgets)


def test_prefix_text_api(model):
    tok = _Tok()
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16)
    outs = cb.generate_many(["ab", "cde"], max_tokens=6, shared_prefix="sys: ")
    plain = DecoderGenerator(model, tok)
    assert outs == [plain.generate("sys: " + p, max_tokens=6) for p in ["ab", "cde"]]


def test_streaming_callback_delivers_every_token_once(model):
    """on_tokens streams each generated token exactly once, in order, at
    scheduling-point granularity — concatenated deliveries equal the final
    output minus the prompt (greedy, with mid-flight admissions)."""
    tok = _Tok()
    reqs = PROMPTS[:5]
    budgets = [11, 4, 17, 7, 9]
    streams = {i: [] for i in range(len(reqs))}
    calls = []
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(
        reqs, budgets, on_tokens=lambda r, ts: (streams[r].extend(ts), calls.append((r, len(ts)))))
    assert outs == _oracle(model, tok, reqs, budgets)
    for i, (req, out) in enumerate(zip(reqs, outs)):
        assert streams[i] == out[len(req):]
    # chunked delivery: no call exceeds the scheduling chunk
    assert all(1 <= n <= 4 for _, n in calls)


def test_streaming_with_prefix_and_sampling(model):
    tok = _Tok()
    prefix = [7, 3, 9]
    reqs = PROMPTS[:3]
    streams = {i: [] for i in range(len(reqs))}
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=3)
    outs = cb.generate_tokens_many(reqs, 8, shared_prefix=prefix, topk=4, seed=9,
                                   on_tokens=lambda r, ts: streams[r].extend(ts))
    for i, (req, out) in enumerate(zip(reqs, outs)):
        assert streams[i] == out[len(prefix) + len(req):]


def _sampling_oracle(model, request, max_new, seed, req_idx, topk, top_p, temp):
    """The documented sampling chain — token g of request r draws
    ``fold_in(fold_in(PRNGKey(seed), r), g)`` — computed with full UNCACHED
    forwards, independent of the pool/cache machinery under test."""
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text._decoder_lm import decoder_lm_apply
    from pytorch_models_tpu.models.text.generator import _sample

    key_r = jax.random.fold_in(jax.random.PRNGKey(seed), req_idx)
    toks = list(request)
    for g in range(max_new):
        logits = decoder_lm_apply(model.params, model.cfg, jnp.asarray(toks)[None])[0, -1]
        toks.append(int(_sample(logits, jax.random.fold_in(key_r, g), topk, top_p, temp)))
    return toks


def test_sampling_schedule_invariant(model):
    """topk/temperature serving: request r's sample stream depends only on
    (seed, r) — identical across pool sizes, admission orders, and
    check_every — and matches the documented fold_in chain."""
    tok = _Tok()
    reqs = PROMPTS[:4]
    budgets = [9, 5, 12, 7]
    kw = dict(topk=5, temperature=0.9, seed=3)
    cb_a = ContinuousBatchingGenerator(model, tok, batch_size=3, prompt_bucket=16,
                                       check_every=4)
    cb_b = ContinuousBatchingGenerator(model, tok, batch_size=1, prompt_bucket=16,
                                       check_every=1)
    outs = cb_a.generate_tokens_many(reqs, budgets, **kw)
    assert outs == cb_b.generate_tokens_many(reqs, budgets, **kw)
    assert outs == [_sampling_oracle(model, r, m, 3, i, 5, None, 0.9)
                    for i, (r, m) in enumerate(zip(reqs, budgets))]


def test_topp_sampling_matches_oracle(model):
    tok = _Tok()
    reqs = PROMPTS[:3]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=3)
    outs = cb.generate_tokens_many(reqs, 8, top_p=0.9, temperature=1.1, seed=11)
    assert outs == [_sampling_oracle(model, r, 8, 11, i, 1, 0.9, 1.1)
                    for i, r in enumerate(reqs)]


def test_sampling_with_shared_prefix(model):
    """Sampling composes with prefix caching: the chain indexes by request,
    the prompt is prefix + request."""
    tok = _Tok()
    prefix = [7, 3, 9, 1]
    reqs = PROMPTS[:3]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=4)
    outs = cb.generate_tokens_many(reqs, 7, shared_prefix=prefix, topk=4, seed=5)
    assert outs == [_sampling_oracle(model, prefix + r, 7, 5, i, 4, None, 1.0)
                    for i, r in enumerate(reqs)]


def test_fused_sampling_path_matches_xla(model, request):
    """The GPU sampling route (decode kernel + XLA head matmul + per-row
    fold_in draw) in interpret mode must reproduce the einsum path."""
    tok = _Tok()
    reqs, budgets = PROMPTS[:3], [7, 4, 6]
    kw = dict(topk=3, temperature=0.8, seed=2)
    base = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                       check_every=3).generate_tokens_many(reqs, budgets, **kw)
    calls = request.getfixturevalue("decode_kernel_interpret")
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16, check_every=3)
    assert cb.generate_tokens_many(reqs, budgets, **kw) == base
    assert calls["traces"] > 0


def test_serving_stats_consistency(model):
    """last_stats bookkeeping: admissions/requests/tokens line up with the
    outputs, occupancy is a sane fraction, and epoch resets are counted."""
    small = _model(seed=3, max_seq_len=64)
    tok = _Tok()
    requests = [[1, 2, 3], [i % 512 for i in range(14)], [4, 5], [6] * 7]
    budgets = [30, 30, 30, 10]  # two back-to-back 30s overflow 64: reset
    cb = ContinuousBatchingGenerator(small, tok, batch_size=2, prompt_bucket=16,
                                     check_every=5)
    outs = cb.generate_tokens_many(requests, budgets)
    st = cb.last_stats
    assert st.requests == st.admissions == len(requests)
    assert st.tokens_generated == sum(len(o) - len(r) for o, r in zip(outs, requests))
    assert 0.0 < st.occupancy <= 1.0
    assert st.decode_steps >= max(len(o) - len(r) for o, r in zip(outs, requests))
    assert st.slot_steps == st.decode_steps * 2
    assert st.live_slot_steps <= st.slot_steps
    assert st.scheduling_points >= 1 and st.wall_time_s > 0
    assert st.epoch_resets >= 1  # budgets above force at least one reset
    assert st.tokens_per_s > 0


def test_per_request_sampling_params(model):
    """Per-request temperature / top_p lists: each request's sample stream
    equals a single-request pool run with that request's scalar params and
    its own (seed, r) key chain."""
    tok = _Tok()
    reqs = [[3, 1, 4], [9, 2, 6, 5], [2, 7]]
    temps = [0.7, 1.3, 1.0]
    tps = [0.9, 0.5, 0.95]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=3)
    mixed = cb.generate_tokens_many(reqs, 10, topk=8, top_p=tps,
                                    temperature=temps, seed=4)
    # oracle: run each request through its OWN pool with scalar params but
    # the same request index r (pad the queue with dummies that keep r)
    for r in range(3):
        solo = ContinuousBatchingGenerator(model, tok, batch_size=1,
                                           prompt_bucket=16, check_every=1)
        outs = solo.generate_tokens_many(reqs[: r + 1], 10, topk=8,
                                         top_p=tps[r], temperature=temps[r],
                                         seed=4)
        assert mixed[r] == outs[r]


def test_per_request_temperature_only(model):
    tok = _Tok()
    reqs = [[3, 1, 4], [9, 2, 6]]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=16,
                                     check_every=2)
    mixed = cb.generate_tokens_many(reqs, 8, topk=5, temperature=[0.6, 1.4], seed=2)
    for r in range(2):
        solo = ContinuousBatchingGenerator(model, tok, batch_size=1, prompt_bucket=16,
                                           check_every=1)
        outs = solo.generate_tokens_many(reqs[: r + 1], 8, topk=5,
                                         temperature=[0.6, 1.4][r], seed=2)
        assert mixed[r] == outs[r]


def test_long_prompt_near_max_seq_len(model):
    """A long prompt close to max_seq_len must serve (the epoch base is NOT
    bucket-rounded past feasibility), alone and mixed with short requests."""
    tok = _Tok()
    requests = [[i % 512 for i in range(200)], [5, 6, 7]]
    budgets = [10, 40]
    cb = ContinuousBatchingGenerator(model, tok, batch_size=2, prompt_bucket=64,
                                     check_every=4)
    assert cb.generate_tokens_many(requests, budgets) == _oracle(model, tok, requests, budgets)
