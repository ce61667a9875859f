"""Benchmark harness: one model's serving metric on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
The reference publishes no throughput numbers (BASELINE.md), so
``vs_baseline`` is the fraction of the card's analytic roofline — per-model
floors computed from the published bf16 peak FLOP/s and memory bandwidth in
``DEVICE_PEAKS`` (batch-1 decode is bandwidth-bound, so its roofline is
weight+cache traffic, not FLOPs). Details go to stderr.

``BENCH_MODEL`` picks the workload: ``vit`` (ViT-B/16 images/sec, default),
``whisper`` (Whisper-base real-time factor, one 30 s segment), ``whisper_batch``
(16 segments), ``gpt2`` (GPT-2-small batched decode tokens/sec), ``gpt2_spec``,
``t5`` and ``encodec``. ``BENCH_DTYPE=int8`` benches weight-only int8,
``int8_a8`` w8a8 linears (``ops.layers.USE_A8_LINEAR``), ``int8_kv`` bf16
weights over int8 self-KV caches. ``BENCH_PROFILE=<dir>`` writes a
``jax.profiler`` trace of the run.

A device missing from ``DEVICE_PEAKS`` is an error: numbers are only ever
reported against a known card.
"""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

# Published dense peaks by device kind (substring of jax's ``device_kind``):
# bf16 FLOP/s and memory bytes/s. Source: NVIDIA H100 SXM data sheet.
DEVICE_PEAKS = {
    "H100": (989e12, 3.35e12),
}

METRICS = {
    "vit": ("vit_b16_images_per_sec_per_chip", "images/sec"),
    "whisper": ("whisper_base_rtf", "x_realtime"),
    "gpt2": ("gpt2_small_decode_tokens_per_sec", "tokens/sec"),
    "encodec": ("encodec_24khz_roundtrip_rtf", "x_realtime"),
    "t5": ("t5_base_generate_tokens_per_sec", "tokens/sec"),
    "whisper_batch": ("whisper_base_batch16_rtf", "x_realtime"),
    "gpt2_spec": ("gpt2_small_speculative_b1_floor_tokens_per_sec", "tokens/sec"),
}


def device_peaks(device_kind: str) -> tuple[float, float]:
    """(bf16 peak FLOP/s, memory bytes/s) of a known card; unknown raises."""
    for key, peaks in DEVICE_PEAKS.items():
        if key.lower() in device_kind.lower():
            return peaks
    raise ValueError(f"no published peaks for device {device_kind!r}; known: {sorted(DEVICE_PEAKS)}")


def _device_caps():
    import jax

    dev = jax.devices()[0]
    peak, bw = device_peaks(dev.device_kind)
    print(f"device: {dev.device_kind}, peak bf16 {peak/1e12:.0f} TFLOP/s, memory {bw/1e9:.0f} GB/s",
          file=sys.stderr)
    return peak, bw


def vit_flops_per_image(n_layers=12, d=768, patch=16, img=224, mlp_ratio=4) -> float:
    """Analytic forward FLOPs (2 * MACs) for ViT with cls token."""
    n_tok = (img // patch) ** 2 + 1
    patch_macs = (img // patch) ** 2 * (patch * patch * 3) * d
    qkvo = 4 * n_tok * d * d
    attn = 2 * n_tok * n_tok * d
    mlp = 2 * n_tok * d * (d * mlp_ratio)
    return 2.0 * (patch_macs + n_layers * (qkvo + attn + mlp))


def vit_a8_roofline_ips(peak, n_layers=12, d=768, patch=16, img=224, mlp_ratio=4) -> float:
    """img/s ceiling for w8a8 ViT serving: projection/MLP flops run at the
    int8 tensor-core peak (2x bf16), attention einsums and the conv stem stay
    bf16 (quantize_tree_int8 leaves conv kernels alone; scores/softmax are
    not quantized)."""
    n_tok = (img // patch) ** 2 + 1
    f_int8 = 2.0 * n_layers * (4 * n_tok * d * d + 2 * n_tok * d * (d * mlp_ratio))
    f_bf16 = 2.0 * ((img // patch) ** 2 * (patch * patch * 3) * d
                    + n_layers * 2 * n_tok * n_tok * d)
    return 1.0 / (f_int8 / (2.0 * peak) + f_bf16 / peak)


def transformer_layer_macs(L, d, d_ff, ctx=None):
    """MACs for one encoder layer at seq len L (attention context ctx or L)."""
    ctx = L if ctx is None else ctx
    return 4 * L * d * d + 2 * L * ctx * d + 2 * L * d * d_ff


def whisper_base_floor(peak, bw, n_tok=64, dtype_bytes=2, kv_bytes=None):
    """Analytic time floor for 30 s audio -> encoder -> n_tok greedy tokens.

    Encoder (L=1500, batch 1) is compute-bound; batch-1 decode is
    bandwidth-bound: every step must read the decoder weights, the logits
    embedding, the cross-KV cache, and the growing self-KV cache from HBM.
    ``kv_bytes`` separates cache bytes from weight bytes (w8a8 halves only
    the weights; caches stay bf16) — defaults to ``dtype_bytes``.
    """
    kv_bytes = dtype_bytes if kv_bytes is None else kv_bytes
    d, d_ff, n_layers, L_enc, vocab, n_mels = 512, 2048, 6, 1500, 51865, 80
    stem = 3000 * 3 * n_mels * d + 1500 * 3 * d * d
    enc_macs = stem + n_layers * transformer_layer_macs(L_enc, d, d_ff)
    t_enc = 2.0 * enc_macs / peak

    # one-time cross-KV projection of the encoder memory
    t_cross = 2.0 * n_layers * 2 * L_enc * d * d / peak

    dec_param_bytes = dtype_bytes * (
        n_layers * (4 * d * d + 4 * d * d + 2 * d * d_ff)  # self + cross + mlp
        + vocab * d  # tied embedding read by the logits matmul
        + 448 * d
    )
    cross_kv_bytes = kv_bytes * n_layers * 2 * L_enc * d
    self_kv_bytes = kv_bytes * n_layers * 2 * (n_tok / 2) * d  # average position
    t_dec = n_tok * (dec_param_bytes + cross_kv_bytes + self_kv_bytes) / bw
    return t_enc + t_cross + t_dec


def gpt2_decode_roofline(peak, bw, batch, prompt_len, new_tokens, proj_bytes=2,
                         head_bytes=2, kv_bytes=2):
    """Tokens/sec floor-derived ceiling for batched greedy decode.

    Each step reads the weights once (amortized over the batch) plus each
    row's KV cache; compute is 2 * params * batch FLOPs. tokens/sec ceiling =
    batch / max(bytes / bw, flops / peak). ``proj_bytes=1`` models weight-only
    int8 (projection kernels only; embeddings/caches stay bf16).
    """
    d, d_ff, n_layers, vocab, ctx = 768, 3072, 12, 50257, 1024
    proj_params = n_layers * (4 * d * d + 2 * d * d_ff)
    other_params = vocab * d + ctx * d  # embeddings (logits matmul reads all of it)
    avg_pos = prompt_len + new_tokens / 2
    # w8a8 (head_bytes=1) streams the greedy-head table as int8 too
    # int8 KV (kv_bytes=1) adds 2 f32 scale planes per key: + 2*4 bytes/key
    kv_row = kv_bytes * 2 * d + (8 if kv_bytes == 1 else 0)
    step_bytes = proj_bytes * proj_params + head_bytes * vocab * d + 2 * ctx * d \
        + batch * n_layers * avg_pos * kv_row
    step_flops = 2.0 * batch * (proj_params + other_params + n_layers * 2 * avg_pos * d)
    t_step = max(step_bytes / bw, step_flops / peak)
    return batch / t_step


def encodec_24k_floor(peak, bw, seconds, dtype_bytes=4):
    """Encode+decode time floor: conv FLOPs at 24 kHz plus one weight read."""
    # dominant conv stacks: channels double 32->512 over strides (2,4,5,8);
    # approximate MACs per input sample for encoder+decoder round trip.
    macs = 0
    ch, rate = 32, 24_000 * seconds
    for stride in (2, 4, 5, 8):
        # residual block (k3 + k1) at ch, then strided down-conv ch->2ch (k=2*stride)
        macs += rate * (3 * ch * ch / 2 + ch * ch / 2)
        macs += (rate // stride) * (2 * stride) * ch * (2 * ch)
        ch, rate = ch * 2, rate // stride
    macs += rate * 7 * ch * ch * 2  # first/last k7 convs at full width
    macs *= 2  # decoder mirrors the encoder
    params_bytes = 15e6 * dtype_bytes
    return max(2.0 * macs / peak, params_bytes / bw) + params_bytes / bw


def _maybe_a8(model):
    """BENCH_DTYPE=int8_a8: w8a8 serving — int8 weights + per-row activation
    quantization in every linear (ops.layers.USE_A8_LINEAR)."""
    if os.environ.get("BENCH_DTYPE") != "int8_a8":
        return model, False
    from pytorch_models_tpu.ops import layers as layers_mod

    layers_mod.USE_A8_LINEAR = True
    return model.quantize_int8(), True


def bench_whisper(peak, bw):
    """Whisper-base RTF: 30 s of audio -> mel -> encoder -> 64 greedy tokens."""
    from pytorch_models_tpu.models.audio2text.whisper import Whisper, WhisperGenerator

    import jax.numpy as jnp

    model = Whisper.from_openai("base").to_bf16()  # random weights: timing-only (no network)
    model, a8 = _maybe_a8(model)
    gen = WhisperGenerator(model)
    # pre-staged on device: the upload is set-up, not serving time
    audio = jnp.asarray(np.random.default_rng(0).standard_normal(30 * 16_000).astype(np.float32) * 0.1)
    audio.block_until_ready()
    init = [50258, 50259, 50359, 50363]
    n_tok = 64
    # time N sequential single-segment transcriptions with ONE host sync:
    # each call is the exact jit under transcribe_tokens; the segments run
    # strictly one after another on device (batch 1).
    wav = audio.astype(jnp.float32)[None]
    init_arr = jnp.asarray(init, jnp.int32)
    fn = gen._transcribe_full_batch
    reps = 8
    np.asarray(fn(model.params, wav, n_tok, init_arr, -1)[0])  # compile + warm
    t0 = time.perf_counter()
    out = [fn(model.params, wav, n_tok, init_arr, -1) for _ in range(reps)][-1]
    np.asarray(out[0])  # one sync: the device ran the calls back-to-back
    dt = (time.perf_counter() - t0) / reps
    rtf = 30.0 / dt
    # a8: weight streams halve (approx — KV/embeds stay bf16) and the encoder
    # runs on the 2x int8 peak; approximate the floor with 1-byte weights
    floor = whisper_base_floor(2 * peak if a8 else peak, bw, n_tok=n_tok,
                               dtype_bytes=1 if a8 else 2, kv_bytes=2)
    rtf_roof = 30.0 / floor
    print(f"whisper-base{' w8a8' if a8 else ''}: {dt*1e3:.0f} ms for 30 s audio "
          f"+ {n_tok} tokens -> RTF {rtf:.1f}x "
          f"(analytic floor {floor*1e3:.1f} ms -> {rtf_roof:.0f}x)", file=sys.stderr)
    return rtf, rtf / rtf_roof


def bench_whisper_batch(peak, bw):
    """Whisper-base serving throughput: 16 segments transcribed in one batched
    call (amortizes the per-step decode overhead that dominates at batch 1)."""
    from pytorch_models_tpu.models.audio2text.whisper import Whisper, WhisperGenerator

    import jax.numpy as jnp

    model = Whisper.from_openai("base").to_bf16()  # random weights: timing-only
    model, a8 = _maybe_a8(model)
    gen = WhisperGenerator(model)
    b, n_tok = 16, 64
    r = np.random.default_rng(0)
    # pre-staged device batch (see bench_whisper)
    audios = jnp.asarray(r.standard_normal((b, 30 * 16_000)).astype(np.float32) * 0.1)
    audios.block_until_ready()
    init = [50258, 50259, 50359, 50363]
    init_arr = jnp.asarray(init, jnp.int32)
    fn = gen._transcribe_full_batch
    reps = 4
    np.asarray(fn(model.params, audios, n_tok, init_arr, -1)[0])  # compile + warm
    t0 = time.perf_counter()
    out = [fn(model.params, audios, n_tok, init_arr, -1) for _ in range(reps)][-1]
    np.asarray(out[0])
    dt = (time.perf_counter() - t0) / reps
    rtf = b * 30.0 / dt
    # floor: batch-b encoder compute + decode weight read amortized over b rows
    d, d_ff, n_layers, L_enc, vocab, n_mels = 512, 2048, 6, 1500, 51865, 80
    wb, enc_peak = (1, 2 * peak) if a8 else (2, peak)  # w8a8: int8 weights + 2x peak
    stem = 3000 * 3 * n_mels * d + 1500 * 3 * d * d
    t_enc = 2.0 * b * (stem + n_layers * transformer_layer_macs(L_enc, d, d_ff)) / enc_peak
    t_cross = 2.0 * b * n_layers * 2 * L_enc * d * d / enc_peak
    step_bytes = wb * (n_layers * (8 * d * d + 2 * d * d_ff) + vocab * d + 448 * d) + \
        2 * b * n_layers * 2 * (1536 + n_tok / 2) * d
    t_dec = n_tok * step_bytes / bw
    rtf_roof = b * 30.0 / (t_enc + t_cross + t_dec)
    print(f"whisper-base batch {b}{' w8a8' if a8 else ''}: {dt*1e3:.0f} ms for "
          f"{b}x30 s -> throughput RTF {rtf:.0f}x "
          f"(analytic {rtf_roof:,.0f}x)", file=sys.stderr)
    return rtf, rtf / rtf_roof


def bench_gpt2_decode(peak, bw):
    """GPT-2-small batched greedy decode throughput (tokens/sec/chip).

    ``BENCH_DTYPE=int8`` benches weight-only int8 (halves the per-step weight
    traffic that bounds batched decode; roofline scales accordingly);
    ``BENCH_DTYPE=int8_a8`` adds w8a8 linears; ``BENCH_DTYPE=int8_kv`` keeps
    bf16 weights but stores the KV caches as per-key int8 (ops/int8_kv.py)."""
    from pytorch_models_tpu.models.text import GPT2, DecoderGenerator
    from pytorch_models_tpu.ops import attention as attn_mod
    from pytorch_models_tpu.ops import layers as layers_mod

    dtype_mode = os.environ.get("BENCH_DTYPE", "bf16")
    int8_kv = dtype_mode == "int8_kv"  # bf16 weights + int8 self-KV caches
    int8 = dtype_mode.startswith("int8") and not int8_kv
    if dtype_mode == "int8_a8":
        layers_mod.USE_A8_LINEAR = True
    if int8_kv:
        attn_mod.USE_INT8_KV = True
    model = GPT2(12, 768).to_bf16()  # random weights: timing-only (no network)
    if int8:
        model = model.quantize_int8()

    class Tok:  # generate_tokens_batch only reads eos_token_id
        eos_token_id = -1  # never stop early

    gen = DecoderGenerator(model, Tok())
    # 512 new tokens: the fixed per-call cost (prefill, dispatch) is small
    # next to the decode loop
    batch, prompt_len, new_tokens = 32, 32, 512
    prompts = [[1] * prompt_len] * batch
    gen.generate_tokens_batch(prompts, max_tokens=new_tokens)  # compile
    # time repeated full-generation calls (the jit under
    # generate_tokens_batch on pre-staged prompts) with ONE host sync
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text.generator import _generate_batch
    buf = jnp.asarray(np.full((batch, prompt_len), 1, np.int32))
    pad = jnp.zeros((batch,), jnp.int32)
    limit = prompt_len + new_tokens
    key = jax.random.PRNGKey(0)
    args = (model.params, model.cfg, buf, pad, limit, 1, -1, key)
    reps = 3
    np.asarray(_generate_batch(*args)[0])  # compile + warm
    t0 = time.perf_counter()
    out = [_generate_batch(*args) for _ in range(reps)][-1]
    np.asarray(out[0])  # one sync: the device ran the calls back-to-back
    dt = (time.perf_counter() - t0) / reps
    tps = batch * new_tokens / dt
    roof = gpt2_decode_roofline(peak, bw, batch, prompt_len, new_tokens,
                                proj_bytes=1 if int8 else 2,
                                head_bytes=1 if dtype_mode == "int8_a8" else 2,
                                kv_bytes=1 if int8_kv else 2)
    print(f"gpt2 batched decode ({dtype_mode}): {tps:,.0f} tok/s "
          f"(batch {batch}, {new_tokens} new; bandwidth roofline {roof:,.0f} tok/s)", file=sys.stderr)
    return tps, tps / roof


def bench_gpt2_speculative(peak, bw):
    """Speculative-decoding WORST-CASE throughput (B=1 GPT-2-small, k=4).

    Random weights make the draft's acceptance rate ~0, so this measures the
    speculative loop's overhead floor: every iteration pays k 2-layer draft
    steps + one (k+1)-token verify chunk and emits ONE token. Real
    distilled drafts (acceptance a) scale it by ~(1 + a*k): the reported
    number is the guaranteed lower bound of the serving win.
    ``vs_baseline`` = floor tok/s / plain greedy tok/s measured in the same
    run (>1 means speculative can never lose at these shapes). Bracket
    details: tools/spec_bench.py.
    """
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.text import GPT2
    from pytorch_models_tpu.models.text.generator import _generate_batch
    from pytorch_models_tpu.models.text.speculative import _speculative_generate

    target = GPT2(12, 768).to_bf16()  # random weights: timing-only (no network)
    draft = GPT2(2, 768).to_bf16()
    k, new_tokens, n, pad = 4, 128, 8, 64
    prompt_buf = np.zeros((pad,), np.int32)
    prompt_buf[:n] = 1

    def timed(fn, args, reps=4):
        np.asarray(jax.tree.leaves(fn(*args))[0])  # compile + warm
        t0 = time.perf_counter()
        out = [fn(*args) for _ in range(reps)][-1]
        np.asarray(jax.tree.leaves(out)[0])  # one sync
        return (time.perf_counter() - t0) / reps

    bbuf = jnp.asarray(prompt_buf[None])
    pads = jnp.asarray([pad - n], jnp.int32)
    plain_args = (target.params, target.cfg, bbuf, pads, pad + new_tokens, 1, -1,
                  jax.random.PRNGKey(0))
    t_plain = timed(_generate_batch, plain_args)

    spec_args = (target.params, target.cfg, draft.params, draft.cfg,
                 jnp.asarray(prompt_buf), n, n + new_tokens, k, -1)
    t_spec = timed(_speculative_generate, spec_args)

    tps_plain, tps_spec = new_tokens / t_plain, new_tokens / t_spec
    print(f"gpt2 B=1 plain {tps_plain:,.0f} tok/s; speculative k={k} acceptance~0 "
          f"floor {tps_spec:,.0f} tok/s ({tps_spec / tps_plain:.2f}x; a=1 bound ~{(1 + k) * tps_spec:,.0f})",
          file=sys.stderr)
    return tps_spec, tps_spec / tps_plain


def t5_generate_roofline(peak, bw, batch, enc_len, new_tokens, dtype_bytes=2,
                         kv_bytes=None):
    """Tokens/sec ceiling for batched T5-base generation (encode + decode).

    The encoder and one-time cross-KV projections are compute-bound; each
    decode step reads the decoder weights once plus every row's cross- and
    self-KV caches (bandwidth-bound at batch 32). ``kv_bytes`` separates
    cache bytes from weight bytes (w8a8 halves only the weights)."""
    kv_bytes = dtype_bytes if kv_bytes is None else kv_bytes
    d, n_layers, mlp, vocab = 768, 12, 2048, 32128
    enc_macs = n_layers * (4 * enc_len * d * d + 2 * enc_len * enc_len * d + 3 * enc_len * d * mlp)
    t_enc = 2.0 * batch * enc_macs / peak
    t_cross = 2.0 * batch * n_layers * 2 * enc_len * d * d / peak

    enc_pad = -(-enc_len // 128) * 128  # caches padded to whole kernel blocks
    dec_params = n_layers * (4 * d * d + 2 * d * d + 3 * d * mlp) + vocab * d
    cache_rows = n_layers * 2 * (enc_pad + new_tokens / 2) * d
    step_bytes = dtype_bytes * dec_params + kv_bytes * batch * cache_rows
    step_flops = 2.0 * batch * (dec_params + cache_rows)
    t_step = max(step_bytes / bw, step_flops / peak)
    return batch * new_tokens / (t_enc + t_cross + new_tokens * t_step)


def bench_t5_generate(peak, bw):
    """T5-base batched greedy generation tokens/sec (rel-pos-biased self
    attention per-op; cross-attention reads per-row valid memory)."""
    from pytorch_models_tpu.models.text.t5 import T5Generator, T5Model

    model = T5Model(32128, *_t5_dims()).to_bf16()  # random weights: timing-only
    model, a8 = _maybe_a8(model)
    gen = T5Generator(model=model, tokenizer=object())
    batch, enc_len, new_tokens = 32, 64, 64
    prompts = [[7] * enc_len] * batch
    outs = gen.generate_tokens_batch(prompts, new_tokens, pad_id=0, eos_id=-1)  # compile
    # sequential calls with one host sync (see bench_whisper); each call is
    # the exact jit under generate_tokens_batch on pre-staged prompts
    import jax.numpy as jnp
    from pytorch_models_tpu.models.text.t5 import _t5_generate_batch
    buf = jnp.asarray(np.full((batch, enc_len), 7, np.int32))
    n_enc = jnp.asarray(np.full((batch,), enc_len, np.int32))
    reps = 4
    np.asarray(_t5_generate_batch(model.params, model.cfg, buf, n_enc, new_tokens, 0, -1)[0])
    t0 = time.perf_counter()
    out = [_t5_generate_batch(model.params, model.cfg, buf, n_enc, new_tokens, 0, -1)
           for _ in range(reps)][-1]
    np.asarray(out[0])
    dt = (time.perf_counter() - t0) / reps
    n_generated = sum(len(o) - 1 for o in outs)  # minus the pad start token
    tps = n_generated / dt
    roof = t5_generate_roofline(2 * peak if a8 else peak, bw, batch, enc_len,
                                new_tokens, dtype_bytes=1 if a8 else 2, kv_bytes=2)
    print(f"t5-base batched generate{' w8a8' if a8 else ''}: {tps:,.0f} tok/s "
          f"(batch {batch}, enc {enc_len}, "
          f"{new_tokens} new; roofline {roof:,.0f} tok/s)", file=sys.stderr)
    return tps, tps / roof


def _t5_dims():
    from pytorch_models_tpu.models.text.t5 import SIZES

    return SIZES["base"]


def bench_encodec(peak, bw):
    """EnCodec-24khz round-trip (encode+decode) realtime factor on 10 s of audio."""
    from pytorch_models_tpu.models.audio import EnCodec

    model = EnCodec.from_facebook("24khz")  # random weights: timing-only
    seconds = 10
    audio = np.random.default_rng(0).standard_normal((1, 1, seconds * 24_000)).astype(np.float32) * 0.1

    def roundtrip():
        codes, scale = model.encode(audio)
        return np.asarray(model.decode(codes, scale))

    roundtrip()  # compile
    t0 = time.perf_counter()
    roundtrip()
    dt = time.perf_counter() - t0
    rtf = seconds / dt
    floor = encodec_24k_floor(peak, bw, seconds)
    rtf_roof = seconds / floor
    print(f"encodec-24khz round-trip: {dt*1e3:.0f} ms for {seconds}s -> RTF {rtf:.1f}x "
          f"(analytic floor {floor*1e3:.1f} ms -> {rtf_roof:.0f}x)", file=sys.stderr)
    return rtf, rtf / rtf_roof


def bench_vit(peak, bw):
    import jax
    import jax.numpy as jnp

    from pytorch_models_tpu.models.image.vit import ViT, vit_apply
    from pytorch_models_tpu.utils.params import cast_tree

    model = ViT.from_google("B/16_augreg")
    params = cast_tree(model.params, jnp.bfloat16)
    cfg = model.cfg
    flops = vit_flops_per_image()
    a8 = os.environ.get("BENCH_DTYPE") == "int8_a8"
    if a8:  # w8a8 serving: int8 projections/MLP on the 2x-peak int8 path
        from pytorch_models_tpu.ops import layers as _layers
        from pytorch_models_tpu.utils.params import quantize_tree_int8

        params = quantize_tree_int8(params)
        _layers.USE_A8_LINEAR = True

    n1, n2 = 10, 40
    best = 0.0
    for batch in (128,):
        x = jnp.asarray(np.random.default_rng(0).standard_normal((batch, 3, 224, 224)), jnp.bfloat16)

        # run the whole iteration loop on device and time it at two loop
        # counts: the slope cancels the fixed dispatch + host pull cost
        def make_loop(n_iters):
            @jax.jit
            def loop(p, v):
                def body(i, acc):
                    # iteration-dependent input: without it XLA hoists the
                    # whole forward out of the loop and times ~1 iteration
                    vi = v + i.astype(v.dtype) * v.dtype.type(1e-6)
                    return acc + vit_apply(p, cfg, vi).astype(jnp.float32).sum()
                return jax.lax.fori_loop(0, n_iters, body, jnp.float32(0))
            return loop

        loop1, loop2 = make_loop(n1), make_loop(n2)
        ts = {}
        for n, loop in ((n1, loop1), (n2, loop2)):
            float(loop(params, x))  # compile + warm
            t0 = time.perf_counter()
            float(loop(params, x))
            ts[n] = time.perf_counter() - t0
        ips = batch * (n2 - n1) / (ts[n2] - ts[n1])
        # a8: report utilization against the mixed int8/bf16 ceiling (same
        # basis as the returned score), not the bf16 flops/peak MFU
        mfu = ips / vit_a8_roofline_ips(peak) if a8 else ips * flops / peak
        print(f"batch {batch}: {ips:,.0f} img/s  "
              f"({'util' if a8 else 'MFU'} {mfu:.1%})", file=sys.stderr)
        best = max(best, ips)

    roofline = vit_a8_roofline_ips(peak) if a8 else peak / flops
    return best, best / roofline


def emit(which, value, vs_baseline):
    import jax

    metric, unit = METRICS[which]
    dev = jax.devices()[0]
    line = {"metric": metric, "value": round(value, 4 if value < 1000 else 1),
            "unit": unit, "vs_baseline": round(vs_baseline, 4),
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}}
    print(json.dumps(line), flush=True)


def main():
    which = os.environ.get("BENCH_MODEL", "vit")
    if which not in METRICS:
        raise SystemExit(f"unknown BENCH_MODEL={which!r}; expected one of {sorted(METRICS)}")

    import jax

    from pytorch_models_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache(Path(__file__).resolve().parent)}", file=sys.stderr)
    peak, bw = _device_caps()
    fn = {"vit": bench_vit, "whisper": bench_whisper, "whisper_batch": bench_whisper_batch,
          "gpt2": bench_gpt2_decode, "encodec": bench_encodec, "t5": bench_t5_generate,
          "gpt2_spec": bench_gpt2_speculative}[which]
    trace_dir = os.environ.get("BENCH_PROFILE")
    if trace_dir:
        jax.profiler.start_trace(trace_dir)
    try:
        value, vs = fn(peak, bw)
    finally:
        if trace_dir:
            jax.profiler.stop_trace()
            print(f"profiler trace written to {trace_dir}", file=sys.stderr)
    emit(which, value, vs)


if __name__ == "__main__":
    main()
