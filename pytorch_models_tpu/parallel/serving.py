"""Tensor + data-parallel SERVING: sharded KV-cached batched generation.

The reference has no distributed layer at all (SURVEY.md §2.7 N3); this is
the serving story to go with parallel/train.py's training story.
A decoder LM (GPT/GPT-2 family) generates over a ("dp", "tp") mesh:

- dp: batch rows split across ranks — embarrassingly parallel.
- tp: Megatron head sharding. Each rank owns ``n_heads/tp`` heads: its q/k/v
  projections, its merged-head KV-cache shard ``(B/dp, L, H*D/tp)``, and its
  slice of the MLP hidden dim. The attention out-projection and MLP fc2 are
  row-parallel with ONE ``lax.psum`` each per layer (transformer.reduce_linear)
  — 2 all-reduces per layer per decode step, riding ICI.

The whole generation (prefill + ``lax.while_loop`` decode) runs inside ONE
``shard_map``, so the Pallas decode kernel keeps working: each rank calls it
on its local head shard (a pallas_call cannot be partitioned by GSPMD, which
is why this is shard_map and not sharding-annotated jit). The per-rank code
IS the single-device generator body (models/text/generator.py) — tensor
parallelism enters only through ``LayerConfig.tp_axis`` and local head counts.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.text.generator import PROMPT_BUCKET, _generate_batch_body
from ..models.text.t5 import ENC_BUCKET, _t5_generate_batch_body


def decoder_lm_serving_pspecs(params) -> dict:
    """PartitionSpecs for a decoder-LM param pytree under serving TP.

    Unlike :func:`..parallel.sharding.decoder_lm_pspecs` (GSPMD hints, biases
    replicated), these are shard_map specs: column-parallel biases (q/k/v,
    fc1) must be sharded WITH their kernels so each rank's local add is
    shape-consistent; row-parallel biases (o, fc2) stay replicated and are
    added after the psum (transformer.reduce_linear).
    """
    col = ("['q']", "['k']", "['v']", "['fc1']")
    row = ("['o']", "['fc2']")

    def spec(path, leaf):
        s = jax.tree_util.keystr(path)
        if any(k in s for k in col):
            pad = (None,) * (leaf.ndim - 1)
            return P(*pad, "tp")  # kernels split output dim; biases split too
        if any(k in s for k in row) and s.endswith("['w']"):
            pad = (None,) * (leaf.ndim - 2)
            return P(*pad, "tp", None)  # split input dim -> partial sums
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


class TPDecoderGenerator:
    """Sharded drop-in for ``DecoderGenerator.generate_batch`` over a mesh.

    ``mesh`` must have a "tp" axis dividing the model's head count; a "dp"
    axis (optional) splits batch rows. Params are device_put once at
    construction; generation output is bit-identical to the single-device
    generator (greedy) — see tests/parallel/test_serving.py.
    """

    def __init__(self, model, tokenizer, mesh: Mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        self.mesh = mesh
        axes = dict(mesh.shape)
        assert set(axes) == {"dp", "tp"}, f'serving mesh needs ("dp", "tp") axes, got {tuple(axes)}'
        tp = axes["tp"]
        self.dp = axes["dp"]
        n_heads = model.cfg.layer.n_heads
        assert n_heads % tp == 0, f"{n_heads} heads not divisible by tp={tp}"
        self.cfg_local = replace(model.cfg, local_heads=n_heads // tp, tp_axis="tp" if tp > 1 else None)

        pspecs = decoder_lm_serving_pspecs(model.params)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)
        self._param_specs = pspecs

        cfg_local, dp = self.cfg_local, self.dp

        def sharded(params, prompt_buf, pad_lens, limit, eos_id, key, topk):
            def local(p, buf, pads, limit, eos, key):
                # decorrelate sampling across dp ranks (greedy is unaffected)
                key = jax.random.fold_in(key, lax.axis_index("dp")) if dp > 1 else key
                return _generate_batch_body(p, cfg_local, buf, pads, limit, topk, eos, key)

            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P("dp", None), P("dp"), P(), P(), P()),
                out_specs=(P("dp", None), P("dp")),
                check_vma=False,
            )
            return fn(params, prompt_buf, pad_lens, limit, eos_id, key)

        self._generate = jax.jit(sharded, static_argnums=(6,))

    def generate_batch(self, prompts: list[str], max_tokens: int = 100, topk: int = 1, seed: int = 0) -> list[str]:
        token_lists = [self.tokenizer.encode(p) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens=max_tokens, topk=topk, seed=seed)
        return [self.tokenizer.decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int = 100, topk: int = 1,
                              seed: int = 0) -> list[list[int]]:
        cfg = self.model.cfg
        if max_tokens <= 0:
            return [list(ts) for ts in token_lists]
        assert len(token_lists) % self.dp == 0, (
            f"batch {len(token_lists)} must be divisible by dp={self.dp}")
        max_n = max(len(ts) for ts in token_lists)
        pad = min(-(-max_n // PROMPT_BUCKET) * PROMPT_BUCKET, cfg.max_seq_len)
        assert max_n <= pad, f"prompt too long for context {cfg.max_seq_len}"
        if pad >= cfg.max_seq_len:
            return [list(ts) for ts in token_lists]
        b = len(token_lists)
        buf = np.zeros((b, pad), np.int32)
        pad_lens = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            pad_lens[i] = pad - len(ts)
            buf[i, pad_lens[i]:] = ts

        eos = getattr(self.tokenizer, "eos_token_id", None)
        if eos is None:
            eos = -1
        limit = min(pad + max_tokens, cfg.max_seq_len)
        out, lengths = self._generate(self.params, jnp.asarray(buf), jnp.asarray(pad_lens),
                                      limit, eos, jax.random.PRNGKey(seed), topk)
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, pad_lens[i]: lengths[i]].tolist() for i in range(b)]


def t5_serving_pspecs(params) -> dict:
    """shard_map PartitionSpecs for a T5 param pytree under serving TP.

    Head sharding extends to the per-stack rel-pos bias table (H, n_buckets)
    so each rank builds only its heads' bias rows; the GEGLU gate/value
    kernels (mlp.w / mlp.v) are column-parallel and mlp.wo row-parallel
    (psum'd by transformer.reduce_linear via LayerConfig.tp_axis).
    """
    col = ("['q']", "['k']", "['v']", "['mlp']['w']")
    row = ("['o']", "['wo']")

    def spec(path, leaf):
        s = jax.tree_util.keystr(path)
        if s.endswith("['attn_bias']"):
            return P("tp", None)
        if any(k in s for k in col) and s.endswith("['w']") and not s.endswith("['wo']['w']"):
            pad = (None,) * (leaf.ndim - 1)
            return P(*pad, "tp")
        if any(k in s for k in row) and s.endswith("['w']"):
            pad = (None,) * (leaf.ndim - 2)
            return P(*pad, "tp", None)
        return P()

    return jax.tree_util.tree_map_with_path(spec, params)


class TPT5Generator:
    """Tensor+data-parallel T5 batched generation (mirrors ``T5Generator``).

    The whole encode + cross-KV precompute + while_loop decode runs inside
    one shard_map over a ("dp", "tp") mesh — encoder activations replicated
    per dp-shard, heads (and the rel-pos bias table) sharded over tp.
    Token-identical to the single-device ``T5Generator``.
    """

    def __init__(self, model, tokenizer, mesh: Mesh) -> None:
        self.model = model
        self.tokenizer = tokenizer
        axes = dict(mesh.shape)
        assert set(axes) == {"dp", "tp"}, f'serving mesh needs ("dp", "tp") axes, got {tuple(axes)}'
        tp, self.dp = axes["tp"], axes["dp"]
        assert model.cfg.n_heads % tp == 0, f"{model.cfg.n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(model.cfg, local_heads=model.cfg.n_heads // tp,
                            tp_axis="tp" if tp > 1 else None)

        pspecs = t5_serving_pspecs(model.params)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)

        def sharded(params, enc_tokens, n_enc, max_tokens, pad_id, eos_id):
            def local(p, toks, n):
                return _t5_generate_batch_body(p, cfg_local, toks, n, max_tokens, pad_id, eos_id)

            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P("dp", None), P("dp")),
                out_specs=(P("dp", None), P("dp")),
                check_vma=False,
            )
            return fn(params, enc_tokens, n_enc)

        self._generate = jax.jit(sharded, static_argnums=(3,))

    def generate_batch(self, prompts: list[str], max_tokens: int = 100) -> list[str]:
        token_lists = [self.tokenizer.Encode(p, add_eos=True) for p in prompts]
        outs = self.generate_tokens_batch(token_lists, max_tokens,
                                          self.tokenizer.pad_id(), self.tokenizer.eos_id())
        return [self.tokenizer.Decode(o) for o in outs]

    def generate_tokens_batch(self, token_lists: list[list[int]], max_tokens: int, pad_id: int,
                              eos_id: int) -> list[list[int]]:
        b = len(token_lists)
        assert b % self.dp == 0, f"batch {b} must be divisible by dp={self.dp}"
        max_n = max(len(ts) for ts in token_lists)
        pad = -(-max_n // ENC_BUCKET) * ENC_BUCKET
        buf = np.zeros((b, pad), np.int32)
        n_enc = np.zeros((b,), np.int32)
        for i, ts in enumerate(token_lists):
            buf[i, : len(ts)] = ts
            n_enc[i] = len(ts)
        out, lengths = self._generate(self.params, jnp.asarray(buf), jnp.asarray(n_enc),
                                      max_tokens, pad_id, eos_id)
        out, lengths = np.asarray(out), np.asarray(lengths)
        return [out[i, : lengths[i]].tolist() for i in range(b)]


class TPWhisperGenerator:
    """Tensor+data-parallel Whisper batched transcription.

    One shard_map runs mel -> encoder -> cross-KV precompute -> greedy decode
    per rank: audio rows split over dp, heads over tp (the shared-transformer
    q/k/v/fc1-column / o/fc2-row rules of ``decoder_lm_serving_pspecs`` apply
    unchanged; conv stems and embeddings replicate). Token-identical to the
    single-device ``WhisperGenerator`` batched path.
    """

    def __init__(self, model, mesh: Mesh, tokenizer=None) -> None:
        from ..models.audio2text.whisper import (
            DEC_MAX_LEN,
            WhisperPreprocessor,
            _whisper_encode_body,
            _whisper_generate_batch_body,
        )

        self.model = model
        self.tokenizer = tokenizer
        self._dec_max_len = DEC_MAX_LEN
        axes = dict(mesh.shape)
        assert set(axes) == {"dp", "tp"}, f'serving mesh needs ("dp", "tp") axes, got {tuple(axes)}'
        tp, self.dp = axes["tp"], axes["dp"]
        n_heads = model.cfg.dec_layer.n_heads
        assert n_heads % tp == 0, f"{n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(model.cfg, local_heads=n_heads // tp, tp_axis="tp" if tp > 1 else None)

        variant = "large-v3" if model.cfg.n_mels == 128 else "tiny"
        pre_fwd = WhisperPreprocessor(variant)._forward
        self.N_SAMPLES = 30 * 16_000

        pspecs = decoder_lm_serving_pspecs(model.params)
        self.params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)

        def sharded(params, audios, initial_tokens, max_tokens, eot_id):
            def local(p, a, init):
                mel = pre_fwd(a)
                memory = _whisper_encode_body(p, cfg_local, mel)
                return _whisper_generate_batch_body(p, cfg_local, memory, init, max_tokens, eot_id)

            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P("dp", None), P()),
                out_specs=(P("dp", None), P("dp")),
                check_vma=False,
            )
            return fn(params, audios, initial_tokens)

        self._transcribe = jax.jit(sharded, static_argnums=(3,))

    def transcribe_tokens_batch(self, audios, initial_tokens: list[int], eot_id: int,
                                max_tokens: int = 448) -> list[list[int]]:
        assert max_tokens <= self._dec_max_len
        if isinstance(audios, jnp.ndarray) and audios.ndim == 2 and audios.shape[1] == self.N_SAMPLES:
            padded = audios.astype(jnp.float32)
        else:
            padded = jnp.asarray(np.stack([
                np.pad(np.asarray(a, np.float32)[: self.N_SAMPLES],
                       (0, max(0, self.N_SAMPLES - len(a)))) for a in audios
            ]))
        assert padded.shape[0] % self.dp == 0, (
            f"batch {padded.shape[0]} must be divisible by dp={self.dp}")
        buf, lengths = self._transcribe(self.params, padded,
                                        jnp.asarray(initial_tokens, jnp.int32), max_tokens, eot_id)
        buf, lengths = np.asarray(buf), np.asarray(lengths)
        return [buf[i, : lengths[i]].tolist() for i in range(padded.shape[0])]
