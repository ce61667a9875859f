"""Whisper speech recognition (reference pytorch_models/audio2text/whisper.py).

Encoder: Conv1d stem (s1 then s2) + GELU, position embeddings stored as a
loaded buffer (OpenAI's sinusoids don't bit-match, ref whisper.py:22-25),
pre-norm Encoder, final LN (ref whisper.py:11-34). Decoder: token + learned
PE, pre-norm Decoder with cross-attention, weight-tied logits (ref
whisper.py:37-53).

Beyond the reference (which ships no decode loop — README TODO), this module
adds ``WhisperGenerator``: KV-cached greedy transcription with precomputed
cross-attention K/V and a ``lax.while_loop`` (SURVEY §3.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm
from ...ops import attention as _attn
from ...ops.int8_kv import quantize_kv
from ...ops.layers import conv1d, conv1d_init, dot_precision
from ...utils import StateDict, hub_download, stack_layers
from pytorch_models_tpu.utils.module import InferenceModel
from ..audio.spectrogram import MelSpectrogram

ENC_MAX_LEN = 3000  # mel frames (ref whisper.py:12)
DEC_MAX_LEN = 448  # ref whisper.py:38

# ref whisper.py:67-79
VARIANTS = {
    "tiny": (4, 384, "65147644a518d12f04e32d6f3b26facc3f8dd46e5390956a9424a650c0ce22b9"),
    "tiny.en": (4, 384, "d3dd57d32accea0b295c96e26691aa14d8822fac7d9d27d5dc00b4ca2826dd03"),
    "base": (8, 512, "ed3a0b6b1c0edf879ad9b11b1af5a0e6ab5db9205f891f668f8b0e6c6326e34e"),
    "base.en": (8, 512, "25a8566e1d0c1e2231d1c762132cd20e0f96a85d16145c3a00adf5d1ac670ead"),
    "small": (12, 768, "9ecf779972d90ba49c06d968637d720dd632c55bbf19d441fb42bf17a411e794"),
    "small.en": (12, 768, "f953ad0fd29cacd07d5a9eda5624af0f6bcf2258be67c92b79389873d91e0872"),
    "medium": (24, 1024, "345ae4da62f9b3d59415adc60127b97c714f32e89e936602e85993674d08dcb1"),
    "medium.en": (24, 1024, "d7440d1dc186f76616474e0ff0b3b6b879abc9d1a4926b7adfa41db2d497ab4f"),
    "large-v1": (32, 1280, "e4b87e7e0bf463eb8e6956e646f1e277e901512310def2c24bf0e11bd3c28e9a"),
    "large-v2": (32, 1280, "81f7c96c852ee8fc832187b0132e569d6c3065a3252ed18e56effd0b6a73e524"),
    "large-v3": (32, 1280, "e5b1a55b89c1367dacf97e3e19bfd829a01529dbfdeefa8caeb59b3f1b81dadb"),
}


@dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int
    n_layers: int
    d_model: int
    n_mels: int = 80
    # Tensor-parallel serving (parallel/serving.py): local head count + the
    # mesh axis the o/fc2 projections all-reduce over under shard_map.
    local_heads: int | None = None
    tp_axis: str | None = None
    # "xla" forces the einsum attention path — used by code that runs the
    # cached decode under vmap (batched speculative), where per-row cache
    # positions rule out the decode kernel.
    attn_impl: str = "auto"

    def _heads(self) -> dict:
        if self.local_heads is None:
            return {}
        return {"n_heads": self.local_heads, "head_dim": 64}

    @property
    def enc_layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, tp_axis=self.tp_axis,
                                    attn_impl=self.attn_impl, **self._heads())

    @property
    def dec_layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, cross_attn=True, tp_axis=self.tp_axis,
                                    attn_impl=self.attn_impl, **self._heads())


def whisper_init(key, cfg: WhisperConfig) -> dict:
    ks = jax.random.split(key, 5)
    d = cfg.d_model
    return {
        "encoder": {
            "conv1": conv1d_init(ks[0], 3, cfg.n_mels, d),
            "conv2": conv1d_init(ks[1], 3, d, d),
            "pos_embs": jnp.zeros((ENC_MAX_LEN // 2, d), jnp.float32),
            **tfm.encoder_init(ks[2], cfg.n_layers, cfg.enc_layer),
            "norm": tfm.ln_init(d),
        },
        "decoder": {
            "token_embs": jax.random.normal(ks[3], (cfg.vocab_size, d), jnp.float32),
            "pos_embs": jnp.zeros((DEC_MAX_LEN, d), jnp.float32),
            **tfm.decoder_init(ks[4], cfg.n_layers, cfg.dec_layer),
            "norm": tfm.ln_init(d),
        },
    }


def _whisper_encode_body(params, cfg: WhisperConfig, mel: jnp.ndarray) -> jnp.ndarray:
    """(B, n_mels, T) mel -> (B, T//2, d) memory (ref whisper.py:29-34)."""
    p = params["encoder"]
    x = jnp.swapaxes(mel, 1, 2)  # NLC
    x = ACT_FNS["gelu"](conv1d(p["conv1"], x, stride=1, padding=1))
    x = ACT_FNS["gelu"](conv1d(p["conv2"], x, stride=2, padding=1))
    x = x + p["pos_embs"][: x.shape[1]].astype(x.dtype)
    x = tfm.encoder_apply(p, cfg.enc_layer, x)
    return layer_norm(p["norm"], x)


whisper_encode = partial(jax.jit, static_argnums=1)(_whisper_encode_body)


def _decoder_head(p, x):
    x = layer_norm(p["norm"], x)
    return jnp.matmul(x, p["token_embs"].astype(x.dtype).T, precision=dot_precision(x))


@partial(jax.jit, static_argnums=1)
def whisper_decode(params, cfg: WhisperConfig, tokens: jnp.ndarray, memory: jnp.ndarray) -> jnp.ndarray:
    """Teacher-forced decode (ref whisper.py:47-53). tokens: (B, L) int."""
    p = params["decoder"]
    x = jnp.take(p["token_embs"], tokens, axis=0)
    x = x + p["pos_embs"][: tokens.shape[-1]].astype(x.dtype)
    x = tfm.decoder_apply(p, cfg.dec_layer, x, memory=memory)
    return _decoder_head(p, x)


def _decoder_hidden_chunk(p, lc, cross, tokens, caches, pos):
    """Embed + position slice + KV-cached decoder + final LN for a (S,) chunk
    at positions ``[pos, pos+S)`` of one whisper decoder ``p``. The single
    source of truth for the decode-side forward: the plain generator, the
    speculative target/draft, and the beam forward all call it."""
    s = tokens.shape[-1]
    x = jnp.take(p["token_embs"], tokens, axis=0)
    d = p["pos_embs"].shape[-1]
    x = x + lax.dynamic_slice(p["pos_embs"], (pos, 0), (s, d)).astype(x.dtype)
    x, caches = tfm.decoder_apply(p, lc, x, self_caches=caches,
                                  cross_caches=cross, pos=pos)
    return layer_norm(p["norm"], x), caches


def _decoder_logits_chunk(p, lc, cross, tokens, caches, pos):
    """:func:`_decoder_hidden_chunk` + tied-embedding logits."""
    hn, caches = _decoder_hidden_chunk(p, lc, cross, tokens, caches, pos)
    return jnp.matmul(hn, p["token_embs"].astype(hn.dtype).T,
                      precision=dot_precision(hn)), caches


def _whisper_generate_body(params, cfg: WhisperConfig, memory, initial_tokens, max_tokens: int, eot_id):
    """KV-cached greedy transcription over one encoded segment (unbatched)."""
    p = params["decoder"]
    lc = cfg.dec_layer
    n_init = initial_tokens.shape[0]

    self_caches = tfm.make_kv_cache(cfg.n_layers, (), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=p["token_embs"].dtype, stacked=False)
    cross_caches = tfm.precompute_cross_caches(p, lc, memory)
    # int8 modes (opt-in) quantize at the batched generator's points: cross
    # for the decode loop only, self after the prefill
    dec_cross = quantize_kv(cross_caches) if _attn.USE_INT8_KV_CROSS else cross_caches

    def forward_chunk(tokens, caches, pos, s):
        return _decoder_logits_chunk(p, lc, dec_cross, tokens, caches, pos)

    buf = jnp.zeros((max_tokens,), jnp.int32)
    buf = lax.dynamic_update_slice(buf, initial_tokens.astype(jnp.int32), (0,))
    logits, self_caches = _decoder_logits_chunk(p, lc, cross_caches, initial_tokens,
                                                self_caches, 0)
    if _attn.USE_INT8_KV:
        self_caches = quantize_kv(self_caches)
    first = jnp.argmax(logits[n_init - 1], axis=-1).astype(jnp.int32)
    buf = buf.at[n_init].set(first)
    state = (buf, jnp.int32(n_init + 1), self_caches, first == eot_id)

    def cond(s):
        _, pos, _, done = s
        return jnp.logical_and(jnp.logical_not(done), pos < max_tokens)

    def body(s):
        buf, pos, caches, _ = s
        tok = lax.dynamic_slice(buf, (pos - 1,), (1,))
        logits, caches = forward_chunk(tok, caches, pos - 1, 1)
        nxt = jnp.argmax(logits[0], axis=-1).astype(jnp.int32)
        buf = lax.dynamic_update_slice(buf, nxt[None], (pos,))
        return buf, pos + 1, caches, nxt == eot_id

    buf, length, _, _ = lax.while_loop(cond, body, state)
    return buf, length


def _whisper_speculative_body(params, cfg: WhisperConfig, draft_params,
                              draft_cfg: WhisperConfig, memory, d_memory,
                              initial_tokens, max_tokens: int, eot_id, k: int):
    """Greedy speculative transcription: a smaller Whisper drafts k tokens,
    the target verifies them in one KV-cached (k+1)-position decoder chunk
    (models/text/speculative.py greedy core — token-identical to
    :func:`_whisper_generate_body` for ANY draft). Each model attends its own
    encoding of the same segment (``memory`` / ``d_memory``)."""
    from ..text.speculative import spec_greedy_decode_loop

    p, dp = params["decoder"], draft_params["decoder"]
    lc, dlc = cfg.dec_layer, draft_cfg.dec_layer
    n_init = initial_tokens.shape[0]
    # headroom for the draft scratch; at the 448-position table edge the loop
    # stops up to k tokens early instead (decoder-LM convention)
    l_buf = min(max_tokens + k, DEC_MAX_LEN)

    t_caches = tfm.make_kv_cache(cfg.n_layers, (), lc.n_heads, l_buf, lc.head_dim,
                                 dtype=p["token_embs"].dtype, stacked=False)
    d_caches = tfm.make_kv_cache(draft_cfg.n_layers, (), dlc.n_heads, l_buf, dlc.head_dim,
                                 dtype=dp["token_embs"].dtype, stacked=False)
    t_cross = tfm.precompute_cross_caches(p, lc, memory)
    d_cross = tfm.precompute_cross_caches(dp, dlc, d_memory)

    fwd = _decoder_logits_chunk  # the shared decode-side forward

    def verify_chunk(chunk, caches, pos):
        lg, caches = fwd(p, lc, t_cross, chunk, caches, pos)
        return jnp.argmax(lg, axis=-1).astype(jnp.int32), caches

    def draft_step(tok, caches, pos):
        lg, caches = fwd(dp, dlc, d_cross, tok, caches, pos)
        return jnp.argmax(lg[0], axis=-1).astype(jnp.int32), caches

    buf = jnp.zeros((l_buf,), jnp.int32)
    buf = lax.dynamic_update_slice(buf, initial_tokens.astype(jnp.int32), (0,))
    lg, t_caches = fwd(p, lc, t_cross, initial_tokens, t_caches, 0)
    first = jnp.argmax(lg[n_init - 1], axis=-1).astype(jnp.int32)
    _, d_caches = fwd(dp, dlc, d_cross, initial_tokens, d_caches, 0)  # draft prefill
    buf = buf.at[n_init].set(first)

    return spec_greedy_decode_loop(draft_step, verify_chunk, t_caches, d_caches,
                                   buf, n_init + 1, first == eot_id, max_tokens,
                                   k, eot_id, l_buf)


def _whisper_generate_batch_body(params, cfg: WhisperConfig, memory, initial_tokens, max_tokens: int, eot_id):
    """Batched greedy transcription: ``memory`` (B, T, d); shared initial tokens.

    All rows decode in lockstep (same initial prompt), so caches/positions are
    shared; finished rows park on EOT.
    """
    p = params["decoder"]
    lc = cfg.dec_layer
    b = memory.shape[0]
    n_init = initial_tokens.shape[0]

    self_caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=p["token_embs"].dtype, stacked=False)
    cross_caches = tfm.precompute_cross_caches(p, lc, memory)
    # int8 cross-KV (opt-in): the DECODE loop reads quantized caches; the
    # prefill below keeps the full-precision cross, dead after it runs
    dec_cross = quantize_kv(cross_caches) if _attn.USE_INT8_KV_CROSS else cross_caches

    buf = jnp.zeros((b, max_tokens), jnp.int32)
    init_rows = jnp.broadcast_to(initial_tokens.astype(jnp.int32), (b, n_init))
    buf = lax.dynamic_update_slice(buf, init_rows, (0, 0))
    logits, self_caches = _decoder_logits_chunk(p, lc, cross_caches, init_rows, self_caches, 0)
    if _attn.USE_INT8_KV:  # int8 self-KV: quantize the prefilled cache once (opt-in)
        self_caches = quantize_kv(self_caches)
    first = jnp.argmax(logits[:, n_init - 1], axis=-1).astype(jnp.int32)
    buf = buf.at[:, n_init].set(first)
    state = (buf, jnp.int32(n_init + 1), self_caches, first == eot_id)

    def cond(s):
        _, pos, _, done = s
        return jnp.logical_and(jnp.logical_not(jnp.all(done)), pos < max_tokens)

    def body(s):
        buf, pos, caches, done = s
        tok = lax.dynamic_slice(buf, (0, pos - 1), (b, 1))
        logits, caches = _decoder_logits_chunk(p, lc, dec_cross, tok, caches, pos - 1)
        nxt = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
        nxt = jnp.where(done, jnp.int32(eot_id), nxt)
        buf = lax.dynamic_update_slice(buf, nxt[:, None], (0, pos))
        return buf, pos + 1, caches, jnp.logical_or(done, nxt == eot_id)

    buf, length, _, _ = lax.while_loop(cond, body, state)
    gen = buf[:, n_init:]
    generated = jnp.arange(gen.shape[1])[None, :] < (length - n_init)
    is_eot = jnp.logical_and(gen == eot_id, generated)
    lengths = jnp.where(jnp.any(is_eot, axis=1), n_init + jnp.argmax(is_eot, axis=1) + 1, length)
    return buf, lengths


def _whisper_beam_body(params, cfg: WhisperConfig, memory, initial_tokens,
                       max_tokens: int, eot_id, beam_width: int, alpha):
    """Beam-search transcription over ONE encoded segment (``memory`` (T, d)).

    The W beams ride the batched decode path via the model-agnostic loop in
    models/text/beam.py. Cross-attention K/V are
    projected once and broadcast across beams (identical for every beam);
    only the self caches reorder by parent beam each step. Returns
    ``(seqs (W, max_tokens), scores (W,), lengths (W,))`` best-first;
    lengths count prompt + generated + EOT like the greedy paths.
    """
    from ..text.beam import beam_decode_loop

    p = params["decoder"]
    lc = cfg.dec_layer
    w = beam_width
    n_init = initial_tokens.shape[0]

    self_caches = tfm.make_kv_cache(cfg.n_layers, (w,), lc.n_heads, max_tokens, lc.head_dim,
                                    dtype=p["token_embs"].dtype, stacked=False)
    cross_caches = jax.tree.map(
        lambda c: jnp.broadcast_to(c, (c.shape[0], w, *c.shape[2:])),
        tfm.precompute_cross_caches(p, lc, memory[None]))

    def forward_hidden(tokens, caches, pos, s):
        return _decoder_hidden_chunk(p, lc, cross_caches, tokens, caches, pos)

    def logits_of(hn):
        return jnp.matmul(hn, p["token_embs"].astype(hn.dtype).T, precision=dot_precision(hn))

    init_rows = jnp.broadcast_to(initial_tokens.astype(jnp.int32), (w, n_init))
    hn, self_caches = forward_hidden(init_rows, self_caches, 0, n_init)
    last_logits = logits_of(hn[0, -1])

    buf = jnp.zeros((w, max_tokens), jnp.int32)
    buf = lax.dynamic_update_slice(buf, init_rows, (0, 0))

    def forward(tok, caches, pos):
        hn, caches = forward_hidden(tok, caches, pos - 1, 1)
        return logits_of(hn[:, 0]), caches

    gather = lambda caches, idx: jax.tree.map(lambda c: jnp.take(c, idx, axis=0), caches)
    return beam_decode_loop(forward, gather, self_caches, last_logits, buf,
                            n_init, max_tokens, w, eot_id, alpha)


class Whisper(InferenceModel):
    def __init__(self, vocab_size: int, n_layers: int, d_model: int, n_mels: int = 80,
                 dropout: float = 0.0, rng: int = 0) -> None:
        self.cfg = WhisperConfig(vocab_size, n_layers, d_model, n_mels)
        self.params = whisper_init(jax.random.PRNGKey(rng), self.cfg)

    def encode(self, mel) -> jnp.ndarray:
        return whisper_encode(self.params, self.cfg, jnp.asarray(mel))

    def __call__(self, mel, targets) -> jnp.ndarray:
        return whisper_decode(self.params, self.cfg, jnp.asarray(targets), self.encode(mel))

    forward = __call__

    @staticmethod
    def from_openai(model_tag: str, *, pretrained: bool = False, **kwargs) -> "Whisper":
        n_layers, d_model, ckpt_hash = VARIANTS[model_tag]
        if model_tag == "large-v3":
            n_mels, vocab_size = 128, 51866
        else:
            n_mels, vocab_size = 80, 51864 if model_tag.endswith(".en") else 51865
        m = Whisper(vocab_size, n_layers, d_model, n_mels, **kwargs)
        if pretrained:
            from ...utils.torch_ckpt import load_torch_checkpoint

            url = f"https://openaipublic.azureedge.net/main/whisper/models/{ckpt_hash}/{model_tag}.pt"
            m.load_openai_state_dict(load_torch_checkpoint(hub_download(url))["model_state_dict"])
        return m

    def load_openai_state_dict(self, state_dict: dict) -> None:
        """OpenAI checkpoint keys (ref whisper.py:96-135; k_proj has no bias)."""
        sd = StateDict(state_dict)
        cfg = self.cfg

        def attn(pfx: str) -> dict:
            return {
                "q": sd.pop_linear(f"{pfx}.query"),
                "k": {"w": sd.pop(f"{pfx}.key.weight").T,
                      "b": sd.pop(f"{pfx}.key.bias", np.zeros(cfg.d_model, np.float32))},
                "v": sd.pop_linear(f"{pfx}.value"),
                "o": sd.pop_linear(f"{pfx}.out"),
            }

        def block(pfx: str, cross: bool) -> dict:
            lp = {
                "sa": attn(f"{pfx}.attn"),
                "sa_norm": sd.pop_ln(f"{pfx}.attn_ln"),
                "mlp": {"fc1": sd.pop_linear(f"{pfx}.mlp.0"), "fc2": sd.pop_linear(f"{pfx}.mlp.2")},
                "mlp_norm": sd.pop_ln(f"{pfx}.mlp_ln"),
            }
            if cross:
                lp["ca"] = attn(f"{pfx}.cross_attn")
                lp["ca_norm"] = sd.pop_ln(f"{pfx}.cross_attn_ln")
            return lp

        enc = {
            "conv1": sd.pop_conv1d("encoder.conv1"),
            "conv2": sd.pop_conv1d("encoder.conv2"),
            "pos_embs": sd.pop("encoder.positional_embedding"),
            "layers": stack_layers(
                [jax.tree.map(jnp.asarray, block(f"encoder.blocks.{i}", False)) for i in range(cfg.n_layers)]
            ),
            "norm": sd.pop_ln("encoder.ln_post"),
        }
        dec = {
            "token_embs": sd.pop("decoder.token_embedding.weight"),
            "pos_embs": sd.pop("decoder.positional_embedding"),
            "layers": stack_layers(
                [jax.tree.map(jnp.asarray, block(f"decoder.blocks.{i}", True)) for i in range(cfg.n_layers)]
            ),
            "norm": sd.pop_ln("decoder.ln"),
        }
        if "decoder.positional_embedding_mask" in sd:  # not modeled
            sd.pop("decoder.positional_embedding_mask")
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), {"encoder": enc, "decoder": dec})


class WhisperPreprocessor(MelSpectrogram):
    """Log-mel frontend matching ``whisper.log_mel_spectrogram`` (ref whisper.py:138-148),
    on the XLA spectrogram path."""

    def __init__(self, variant: str = "tiny") -> None:
        n_mels = 128 if variant == "large-v3" else 80
        super().__init__(400, 160, n_mels, 16_000)
        self.n_mels = n_mels
        # one jit per instance instead of op-by-op dispatch
        self._jitted = jax.jit(self._forward)

    def __call__(self, x) -> jnp.ndarray:
        return self._jitted(jnp.asarray(x))

    def _forward(self, x) -> jnp.ndarray:
        x = super().__call__(x)[..., :-1]
        x = jnp.log10(jnp.clip(x, 0, None))
        global_max = jnp.max(x.reshape(*x.shape[:-2], -1), axis=-1)[..., None, None]
        x = jnp.maximum(x, global_max - 8)
        return (x + 4) / 4


def _strip_generated(tokens: list[int], n_prompt: int, eot_id: int) -> list[int]:
    """Drop the initial prompt and the trailing EOT from a decode result."""
    gen = tokens[n_prompt:]
    if gen and gen[-1] == eot_id:
        gen = gen[:-1]
    return gen


def split_windows(audio, n_samples: int) -> np.ndarray:
    """Waveform (n,) -> (n_windows, n_samples) fixed windows, last padded."""
    audio = np.asarray(audio, np.float32)
    assert audio.ndim == 1, f"long-form transcription takes a single (n,) waveform, got {audio.shape}"
    n_w = max(1, -(-len(audio) // n_samples))
    padded = np.zeros((n_w * n_samples,), np.float32)
    padded[: len(audio)] = audio
    return padded.reshape(n_w, n_samples)


class WhisperGenerator:
    """Greedy KV-cached transcription (new vs reference; decode API modeled on
    T5Generator, ref t5.py:211-227)."""

    SAMPLE_RATE = 16_000
    N_SAMPLES = 30 * 16_000  # 30-second segments

    def __init__(self, model: Whisper, tokenizer=None) -> None:
        self.model = model
        self.tokenizer = tokenizer
        variant = "large-v3" if model.cfg.n_mels == 128 else "tiny"
        self.preprocessor = WhisperPreprocessor(variant)
        # mel + encoder + greedy decode in ONE jit call per segment
        pre_fwd, cfg = self.preprocessor._forward, model.cfg

        @partial(jax.jit, static_argnums=(2,))
        def _transcribe_full(params, audio, max_tokens, initial_tokens, eot_id):
            mel = pre_fwd(audio)
            memory = _whisper_encode_body(params, cfg, mel)[0]
            return _whisper_generate_body(params, cfg, memory, initial_tokens, max_tokens, eot_id)

        @partial(jax.jit, static_argnums=(2,))
        def _transcribe_full_batch(params, audios, max_tokens, initial_tokens, eot_id):
            mel = pre_fwd(audios)
            memory = _whisper_encode_body(params, cfg, mel)
            return _whisper_generate_batch_body(params, cfg, memory, initial_tokens, max_tokens, eot_id)

        @partial(jax.jit, static_argnums=(2, 5))
        def _transcribe_beam(params, audio, max_tokens, initial_tokens, eot_id, beam_width, alpha):
            mel = pre_fwd(audio)
            memory = _whisper_encode_body(params, cfg, mel)[0]
            return _whisper_beam_body(params, cfg, memory, initial_tokens,
                                      max_tokens, eot_id, beam_width, alpha)

        self._transcribe_full = _transcribe_full
        self._transcribe_full_batch = _transcribe_full_batch
        self._transcribe_beam_jit = _transcribe_beam

    def _stage_batch(self, audios) -> jnp.ndarray:
        """Segments -> (B, N_SAMPLES) device batch; pre-staged arrays pass
        through (zero-copy serving path)."""
        if isinstance(audios, jnp.ndarray) and audios.ndim == 2 and audios.shape[1] == self.N_SAMPLES:
            return audios.astype(jnp.float32)
        return jnp.asarray(np.stack([
            np.pad(np.asarray(a, np.float32)[: self.N_SAMPLES], (0, max(0, self.N_SAMPLES - len(a))))
            for a in audios
        ]))

    def _stage_segment(self, audio) -> jnp.ndarray:
        """Waveform -> (1, N_SAMPLES) device array; pre-staged arrays pass through."""
        if isinstance(audio, jnp.ndarray) and audio.shape == (self.N_SAMPLES,):
            return audio.astype(jnp.float32)[None]  # skip host pad + re-upload
        audio = np.asarray(audio, np.float32)[: self.N_SAMPLES]
        return jnp.asarray(np.pad(audio, (0, self.N_SAMPLES - len(audio)))[None])

    def transcribe_tokens(self, audio, initial_tokens: list[int], eot_id: int, max_tokens: int = DEC_MAX_LEN):
        """Waveform (n,) -> transcribed token ids (greedy, single 30 s segment)."""
        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN}); "
            "dynamic_slice would silently clamp into the last position embedding")
        wav = self._stage_segment(audio)
        buf, length = self._transcribe_full(
            self.model.params, wav, max_tokens, jnp.asarray(initial_tokens, jnp.int32), eot_id
        )
        return np.asarray(buf)[: int(length)].tolist()

    def transcribe(self, audio, initial_tokens: list[int] | None = None, eot_id: int | None = None,
                   max_tokens: int = DEC_MAX_LEN, language: str = "en", task: str = "transcribe") -> str:
        """Waveform -> text. With a WhisperTokenizer attached, the initial
        token sequence (<|startoftranscript|><|lang|><|task|><|notimestamps|>)
        and EOT id come from it; ``transcribe`` always returns decoded TEXT —
        without a tokenizer use :meth:`transcribe_tokens` for raw ids."""
        if self.tokenizer is None:
            raise ValueError(
                "transcribe() returns text and needs a tokenizer: construct with "
                "WhisperGenerator(model, WhisperTokenizer.from_openai()), or call "
                "transcribe_tokens(...) for raw token ids")
        if initial_tokens is None or eot_id is None:
            initial_tokens = self.tokenizer.sot_sequence(language, task)
            eot_id = self.tokenizer.eot
        tokens = self.transcribe_tokens(audio, initial_tokens, eot_id, max_tokens)
        return self.tokenizer.decode(tokens)

    def transcribe_beam_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                               max_tokens: int = DEC_MAX_LEN, beam_width: int = 4,
                               length_penalty: float = 0.0, return_all: bool = False):
        """Beam-search transcription of one 30 s segment (new vs reference).
        Returns the best token sequence (prompt + generated + EOT, like
        :meth:`transcribe_tokens`), or ``(sequences, scores)`` for all
        ``beam_width`` beams when ``return_all`` (best first; scores are
        length-penalized log-probs — see models/text/beam.py)."""
        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        assert beam_width >= 1
        assert length_penalty >= 0.0, "negative length_penalty breaks the early-stop bound"
        assert len(initial_tokens) < max_tokens, "prompt leaves no room to generate"
        seqs, scores, lens = self._transcribe_beam_jit(
            self.model.params, self._stage_segment(audio), max_tokens,
            jnp.asarray(initial_tokens, jnp.int32), eot_id, beam_width,
            float(length_penalty))
        seqs, scores, lens = np.asarray(seqs), np.asarray(scores), np.asarray(lens)
        outs = [seqs[i, : lens[i]].tolist() for i in range(beam_width)]
        if return_all:
            return outs, scores.tolist()
        return outs[0]

    def transcribe_beam(self, audio, language: str = "en", task: str = "transcribe",
                        beam_width: int = 4, length_penalty: float = 0.0,
                        max_tokens: int = DEC_MAX_LEN) -> str:
        """Waveform -> text via beam search (needs a tokenizer)."""
        if self.tokenizer is None:
            raise ValueError("transcribe_beam() returns text and needs a tokenizer; "
                             "use transcribe_beam_tokens(...) for raw ids")
        initial_tokens = self.tokenizer.sot_sequence(language, task)
        out = self.transcribe_beam_tokens(audio, initial_tokens, self.tokenizer.eot,
                                          max_tokens, beam_width, length_penalty)
        return self.tokenizer.decode(out)

    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = DEC_MAX_LEN) -> list[list[int]]:
        """Batched greedy transcription of multiple 30 s segments (new vs reference)."""
        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        padded = WhisperGenerator._stage_batch(self, audios)
        buf, lengths = self._transcribe_full_batch(
            self.model.params, padded, max_tokens, jnp.asarray(initial_tokens, jnp.int32), eot_id
        )
        buf, lengths = np.asarray(buf), np.asarray(lengths)
        return [buf[i, : lengths[i]].tolist() for i in range(len(audios))]

    # ---------------------------------------------------------------- long-form

    def _split_windows(self, audio) -> np.ndarray:
        """Waveform (n,) -> (n_windows, N_SAMPLES) fixed 30 s windows, last padded."""
        return split_windows(audio, self.N_SAMPLES)

    def transcribe_long_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                               sot_prev_id: int | None = None, ctx_tokens: int = 64,
                               max_tokens: int = DEC_MAX_LEN,
                               batch_size: int = 8) -> list[list[int]]:
        """Long-form (>30 s) greedy transcription; returns per-window GENERATED
        token ids (initial prompt and EOT stripped). New vs the reference
        (which has no transcription driver at all).

        Two modes:
        - ``sot_prev_id=None``: windows are independent -> ALL windows decode
          in batched slices of ``batch_size`` (the throughput path; one
          compile for the shared prompt).
        - ``sot_prev_id`` given: sequential decoding where each window is
          conditioned on previous text OpenAI-style via
          ``[<|startofprev|>] + context + initial_tokens``. To bound jit
          recompiles (one per prompt shape), the context is a FIXED slice: the last ``ctx_tokens``
          generated tokens, applied only once that many have accumulated —
          exactly two trace shapes total.
        """
        windows = self._split_windows(audio)
        if sot_prev_id is None:
            outs: list[list[int]] = []
            for i in range(0, len(windows), batch_size):
                sl = windows[i: i + batch_size]
                n_real = len(sl)
                if n_real < batch_size and len(windows) > batch_size:
                    # pad the tail slice to the full batch (repeat the last
                    # window) so only ONE batched trace shape ever compiles
                    sl = np.concatenate([sl, np.repeat(sl[-1:], batch_size - n_real, 0)])
                outs += self.transcribe_tokens_batch(sl, initial_tokens, eot_id,
                                                     max_tokens)[:n_real]
            return [_strip_generated(o, len(initial_tokens), eot_id) for o in outs]

        results: list[list[int]] = []
        text_accum: list[int] = []
        for w in windows:
            if len(text_accum) >= ctx_tokens:
                prompt = [sot_prev_id] + text_accum[-ctx_tokens:] + list(initial_tokens)
            else:
                prompt = list(initial_tokens)
            out = self.transcribe_tokens(jnp.asarray(w), prompt, eot_id, max_tokens)
            gen = _strip_generated(out, len(prompt), eot_id)
            results.append(gen)
            text_accum += gen
        return results

    def transcribe_long(self, audio, language: str = "en", task: str = "transcribe",
                        condition_on_previous_text: bool = True, ctx_tokens: int = 64,
                        max_tokens: int = DEC_MAX_LEN, batch_size: int = 8) -> str:
        """Long-form waveform -> text via fixed 30 s windows (needs a tokenizer)."""
        if self.tokenizer is None:
            raise ValueError("transcribe_long() returns text and needs a tokenizer; "
                             "use transcribe_long_tokens(...) for raw ids")
        initial_tokens = self.tokenizer.sot_sequence(language, task)
        sot_prev = (self.tokenizer.special_tokens["<|startofprev|>"]
                    if condition_on_previous_text else None)
        outs = self.transcribe_long_tokens(audio, initial_tokens, self.tokenizer.eot,
                                           sot_prev, ctx_tokens, max_tokens, batch_size)
        return "".join(self.tokenizer.decode(o) for o in outs)


class SpeculativeWhisperGenerator:
    """WhisperGenerator accelerated by a smaller draft Whisper (e.g. tiny
    drafting for base/small). Greedy and EXACT: output is token-identical to
    :meth:`WhisperGenerator.transcribe_tokens` for ANY draft — accepted drafts
    equal the target argmax by construction, the first mismatch is replaced
    by it (models/text/speculative.py cores; capability beyond the
    reference). All OpenAI Whisper variants share one BPE vocabulary, so any
    size pairing works. Mel + both encoders + the speculative decode run in
    ONE jit call per segment.

    Edge caveat (decoder-LM convention): within ``k`` positions of the
    448-slot decoder table, the speculative loop stops instead of drafting
    past the edge — a transcription with no EOT before position ``448 - k``
    can return up to ``k-1`` fewer tokens than the plain generator. Pass
    ``max_tokens <= 448 - k`` for unconditional identity; real segments stop
    on EOT long before the table edge."""

    SAMPLE_RATE = WhisperGenerator.SAMPLE_RATE
    N_SAMPLES = WhisperGenerator.N_SAMPLES

    @classmethod
    def with_truncated_draft(cls, model: "Whisper", tokenizer=None,
                             n_layers: int = 2, k: int = 4) -> "SpeculativeWhisperGenerator":
        """Zero-extra-weights speculative serving: the draft is the target's
        own first ``n_layers`` of both stacks (shared conv stem, embeddings,
        final norms). Output stays token-identical to
        :class:`WhisperGenerator` for any draft (models/text/speculative.py);
        depth only moves the speed/acceptance trade-off."""
        from dataclasses import replace
        from types import SimpleNamespace

        assert 1 <= n_layers <= model.cfg.n_layers
        dp = dict(model.params)
        for stack in ("encoder", "decoder"):
            sd = dict(model.params[stack])
            sd["layers"] = jax.tree.map(lambda a: a[:n_layers], sd["layers"])
            dp[stack] = sd
        draft = SimpleNamespace(params=dp,
                                cfg=replace(model.cfg, n_layers=n_layers))
        return cls(model, draft, tokenizer, k)

    def __init__(self, model: Whisper, draft_model: Whisper, tokenizer=None,
                 k: int = 4) -> None:
        assert model.cfg.vocab_size == draft_model.cfg.vocab_size, \
            "draft and target must share a vocabulary"
        assert k >= 1
        self.model = model
        self.draft_model = draft_model
        self.tokenizer = tokenizer
        self.k = k
        t_pre = WhisperPreprocessor("large-v3" if model.cfg.n_mels == 128 else "tiny")
        d_pre = WhisperPreprocessor("large-v3" if draft_model.cfg.n_mels == 128 else "tiny")
        t_fwd, d_fwd = t_pre._forward, d_pre._forward
        t_cfg, d_cfg = model.cfg, draft_model.cfg
        kk = k

        @partial(jax.jit, static_argnums=(3,))
        def _spec_transcribe(params, d_params, audio, max_tokens, initial_tokens, eot_id):
            memory = _whisper_encode_body(params, t_cfg, t_fwd(audio))[0]
            d_memory = _whisper_encode_body(d_params, d_cfg, d_fwd(audio))[0]
            return _whisper_speculative_body(params, t_cfg, d_params, d_cfg, memory,
                                             d_memory, initial_tokens, max_tokens,
                                             eot_id, kk)

        self._spec_transcribe = _spec_transcribe

        from dataclasses import replace as _replace

        # batched: encoders on the (B, ...) batch, then a vmapped decode
        # loop with per-row acceptance/EOT (einsum attention inside — per-row
        # cache positions rule out the decode kernel under vmap)
        t_cfg_x, d_cfg_x = _replace(t_cfg, attn_impl="xla"), _replace(d_cfg, attn_impl="xla")

        @partial(jax.jit, static_argnums=(3,))
        def _spec_transcribe_batch(params, d_params, audios, max_tokens, initial_tokens, eot_id):
            memory = _whisper_encode_body(params, t_cfg, t_fwd(audios))
            d_memory = _whisper_encode_body(d_params, d_cfg, d_fwd(audios))
            core = lambda m, dm: _whisper_speculative_body(
                params, t_cfg_x, d_params, d_cfg_x, m, dm, initial_tokens,
                max_tokens, eot_id, kk)
            return jax.vmap(core)(memory, d_memory)

        self._spec_transcribe_batch = _spec_transcribe_batch

    def transcribe_tokens(self, audio, initial_tokens: list[int], eot_id: int,
                          max_tokens: int = DEC_MAX_LEN) -> list[int]:
        """Waveform (n,) -> transcribed token ids (greedy, single 30 s
        segment; token-identical to the plain generator)."""
        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        wav = WhisperGenerator._stage_segment(self, audio)
        buf, length = self._spec_transcribe(
            self.model.params, self.draft_model.params, wav, max_tokens,
            jnp.asarray(initial_tokens, jnp.int32), eot_id)
        out = np.asarray(buf)[: int(length)]
        n = len(initial_tokens)
        hits = np.nonzero(out[n:] == eot_id)[0]  # truncate at the first EOT
        if hits.size:
            out = out[: n + hits[0] + 1]
        return out.tolist()

    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = DEC_MAX_LEN) -> list[list[int]]:
        """Batched speculative transcription of multiple 30 s segments: both
        encoders run on the batch, then a vmapped decode loop drafts+verifies
        every row together with per-row acceptance/EOT. Token-identical per
        row to :meth:`transcribe_tokens`."""
        assert max_tokens <= DEC_MAX_LEN, (
            f"max_tokens={max_tokens} exceeds the decoder position table ({DEC_MAX_LEN})")
        padded = WhisperGenerator._stage_batch(self, audios)
        bufs, lengths = self._spec_transcribe_batch(
            self.model.params, self.draft_model.params, padded, max_tokens,
            jnp.asarray(initial_tokens, jnp.int32), eot_id)
        bufs, lengths = np.asarray(bufs), np.asarray(lengths)
        n = len(initial_tokens)
        res = []
        for i in range(len(audios)):
            out = bufs[i, : lengths[i]]
            hits = np.nonzero(out[n:] == eot_id)[0]  # truncate at the first EOT
            if hits.size:
                out = out[: n + hits[0] + 1]
            res.append(out.tolist())
        return res

    def transcribe(self, audio, initial_tokens: list[int] | None = None,
                   eot_id: int | None = None, max_tokens: int = DEC_MAX_LEN,
                   language: str = "en", task: str = "transcribe") -> str:
        """Waveform -> text (needs a tokenizer, like WhisperGenerator)."""
        if self.tokenizer is None:
            raise ValueError("transcribe() returns text and needs a tokenizer; "
                             "use transcribe_tokens(...) for raw token ids")
        if initial_tokens is None or eot_id is None:
            initial_tokens = self.tokenizer.sot_sequence(language, task)
            eot_id = self.tokenizer.eot
        tokens = self.transcribe_tokens(audio, initial_tokens, eot_id, max_tokens)
        return self.tokenizer.decode(tokens)
