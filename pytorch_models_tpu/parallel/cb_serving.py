"""Tensor-parallel CONTINUOUS BATCHING: the serving-engine pattern sharded.

Composes the two production serving pieces: a fixed pool of KV-cache slots
with mid-flight request admission (models/text/continuous.py) and Megatron
head sharding over a ``("tp",)`` mesh (parallel/serving.py). The pool's KV
caches shard on the head width — ``(L, B, Lmax, H*D/tp)`` per rank — and the
two scheduling programs (admit, decode-steps) run as shard_maps, with the
base class's host scheduler (admission order, slot harvest, epoch resets)
reused verbatim through its sharding hooks. Decode runs the per-op path on
each rank's heads, all-reducing after the out/fc2 projections.

Per-request outputs stay token-identical to the single-device
``DecoderGenerator.generate_tokens`` (tests/parallel/test_cb_serving.py).
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import transformer as tfm
from ..models.audio2text.continuous import WhisperContinuousBatchingGenerator
from ..models.text.continuous import (
    ContinuousBatchingGenerator,
    _cb_admit_body,
    _cb_admit_prefix_body,
    _cb_chunk_body,
    _cb_i8_admit_body,
    _cb_i8_chunk_body,
    _cb_i8_commit_body,
    _cb_i8_paste_body,
    _cb_paste_body,
    _cb_prefix_body,
    _cb_steps_body,
)
from ..models.text.t5_continuous import T5ContinuousBatchingGenerator
from ..models.text.generator import PROMPT_BUCKET
from .serving import decoder_lm_serving_pspecs

# int8 pool caches under TP: the int8 K/V shard on the head width like the
# bf16 pool, while the per-key f32 scale planes REPLICATE — each key's scale
# is computed over the full merged-head row (quantize_rows pmaxes the absmax
# over the tp axis), so every rank holds the same planes and stays
# bit-identical to a single device quantizing the unsharded row.
_I8_PLANES = {"ks": P(), "vs": P()}


def _i8_spec(spec: dict, caches: dict) -> dict:
    """Cache pspec dict extended with replicated scale planes when the pytree
    carries them (the dict structure is static inside a jit trace)."""
    return dict(spec) | _I8_PLANES if "ks" in caches else spec


class TPContinuousBatchingGenerator(ContinuousBatchingGenerator):
    """Continuous batching with the model tp-sharded over a ``("tp",)`` mesh."""

    def __init__(self, model, tokenizer, mesh: Mesh, batch_size: int = 8,
                 prompt_bucket: int = PROMPT_BUCKET, check_every: int = 16) -> None:
        super().__init__(model, tokenizer, batch_size=batch_size,
                         prompt_bucket=prompt_bucket, check_every=check_every)
        axes = dict(mesh.shape)
        assert set(axes) == {"tp"}, f'cb serving mesh needs a ("tp",) axis, got {tuple(axes)}'
        tp = axes["tp"]
        n_heads = model.cfg.layer.n_heads
        assert n_heads % tp == 0, f"{n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(model.cfg, local_heads=n_heads // tp,
                            tp_axis="tp" if tp > 1 else None)
        self._mesh = mesh

        pspecs = decoder_lm_serving_pspecs(model.params)
        self._sharded_params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)
        cache_spec = {"k": P(None, None, None, "tp"), "v": P(None, None, None, "tp")}
        self._cache_spec = cache_spec

        def admit(params, buf, caches, pad_lens, limits, done,
                  row, pos, n, prompt_chunk, max_new):
            fn = jax.shard_map(
                lambda p, *a: _cb_admit_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, P(), P(), P(), P(), P(), P(), P(), P()),
                out_specs=(P(), cache_spec, P(), P(), P()),
                check_vma=False,
            )
            return fn(params, buf, caches, pad_lens, limits, done,
                      row, pos, n, prompt_chunk, max_new)

        def steps(params, buf, pad_lens, limits, ends, caches, pos, done,
                  n_steps, eos_id):
            def local(p, buf, pads, lims, ends, caches, pos, done, n_steps, eos):
                return _cb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                      pos, done, n_steps, eos)

            cspec = _i8_spec(cache_spec, caches)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, P(), P(), P(), P()),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False,
            )
            return fn(params, buf, pad_lens, limits, ends, caches, pos,
                      done, n_steps, eos_id)

        def steps_sample(params, buf, pad_lens, limits, ends, caches, pos, done,
                         n_steps, eos_id, topk, top_p, temperature, keys, t0s,
                         tps):
            # per-rank sampling is replicated math: hidden is psum-complete
            # and token_embs/keys are replicated, so every rank draws the
            # same token (same argument as the TP greedy argmax)
            def local(p, buf, pads, lims, ends, caches, pos, done, n_steps, eos,
                      temp, keys, t0s, tps):
                return _cb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                      pos, done, n_steps, eos, topk=topk, top_p=top_p, temperature=temp,
                                      keys=keys, t0s=t0s, tps=tps)

            cspec = _i8_spec(cache_spec, caches)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, P(), P(), P(),
                          P(), P(), P(), P(), P()),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False,
            )
            return fn(params, buf, pad_lens, limits, ends, caches, pos,
                      done, n_steps, eos_id, temperature, keys, t0s, tps)

        def prefill_prefix(params, prefix_chunk):
            fn = jax.shard_map(
                lambda p, c: _cb_prefix_body(p, cfg_local, c),
                mesh=mesh, in_specs=(pspecs, P()), out_specs=cache_spec,
                check_vma=False,
            )
            return fn(params, prefix_chunk)

        def prefill_chunk(params, buf, caches, row, c0, pad_len, chunk):
            fn = jax.shard_map(
                lambda p, *a: _cb_chunk_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, P(), P(), P(), P()),
                out_specs=(P(), cache_spec),
                check_vma=False,
            )
            return fn(params, buf, caches, row, c0, pad_len, chunk)

        def paste(buf, caches, row, pad_len, kk, prefix_chunk, prefix_caches):
            # pure slice/paste: the head-sharded cache width never crosses
            # ranks, so each rank pastes its own shard
            fn = jax.shard_map(
                _cb_paste_body, mesh=mesh,
                in_specs=(P(), cache_spec, P(), P(), P(), P(), cache_spec),
                out_specs=(P(), cache_spec),
                check_vma=False,
            )
            return fn(buf, caches, row, pad_len, kk, prefix_chunk, prefix_caches)

        def admit_prefix(params, buf, caches, pad_lens, limits, done,
                         row, pos, n, k, prefix_chunk, prefix_caches,
                         suffix_chunk, max_new):
            fn = jax.shard_map(
                lambda p, *a: _cb_admit_prefix_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, P(), P(), P(), P(), P(), P(),
                          P(), P(), cache_spec, P(), P()),
                out_specs=(P(), cache_spec, P(), P(), P()),
                check_vma=False,
            )
            return fn(params, buf, caches, pad_lens, limits, done,
                      row, pos, n, k, prefix_chunk, prefix_caches,
                      suffix_chunk, max_new)

        # ---- int8 pool admission: the bf16 1-row scratch prefills per rank
        # exactly like the bf16 pool's admission, and the commit quantizes
        # per rank with the tp-pmaxed full-width scale (token-identical to
        # the single-device int8 pool)
        def i8_paste(buf, scratch, row, pad_len, kk, prefix_chunk, prefix_caches):
            fn = jax.shard_map(
                _cb_i8_paste_body, mesh=mesh,
                in_specs=(P(), cache_spec, P(), P(), P(), P(), cache_spec),
                out_specs=(P(), cache_spec),
                check_vma=False,
            )
            return fn(buf, scratch, row, pad_len, kk, prefix_chunk, prefix_caches)

        def i8_chunk(params, buf, scratch, row, c0, pad_len, chunk):
            fn = jax.shard_map(
                lambda p, *a: _cb_i8_chunk_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, P(), P(), P(), P()),
                out_specs=(P(), cache_spec),
                check_vma=False,
            )
            return fn(params, buf, scratch, row, c0, pad_len, chunk)

        def i8_admit(params, buf, scratch, pad_lens, limits, done,
                     row, pos, n, n_tok, prompt_chunk, max_new):
            fn = jax.shard_map(
                lambda p, *a: _cb_i8_admit_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, P(), P(), P(), P(), P(),
                          P(), P(), P(), P()),
                out_specs=(P(), cache_spec, P(), P(), P()),
                check_vma=False,
            )
            return fn(params, buf, scratch, pad_lens, limits, done,
                      row, pos, n, n_tok, prompt_chunk, max_new)

        def i8_commit(caches, scratch, row):
            i8_spec = dict(cache_spec) | _I8_PLANES
            fn = jax.shard_map(
                lambda c, s, r: _cb_i8_commit_body(c, s, r, "tp" if tp > 1 else None),
                mesh=mesh,
                in_specs=(i8_spec, cache_spec, P()),
                out_specs=i8_spec,
                check_vma=False,
            )
            return fn(caches, scratch, row)

        self._admit_jit = jax.jit(admit)
        self._prefix_jit = jax.jit(prefill_prefix)
        self._chunk_jit = jax.jit(prefill_chunk)
        self._paste_jit = jax.jit(paste)
        self._admit_prefix_jit = jax.jit(admit_prefix)
        self._steps_jit = jax.jit(steps)
        self._steps_sample_jit = jax.jit(steps_sample, static_argnums=(10, 11))
        self._i8_paste_jit = jax.jit(i8_paste)
        self._i8_chunk_jit = jax.jit(i8_chunk)
        self._i8_admit_jit = jax.jit(i8_admit)
        self._i8_commit_jit = jax.jit(i8_commit)

    # ---- sharding hooks ----------------------------------------------------
    def _params_cfg(self):
        # host scheduling logic reads only global fields (max_seq_len etc.)
        return self._sharded_params, self.model.cfg

    def _init_pool(self, params, cfg, b):
        caches = tfm.make_kv_cache(cfg.n_layers, (b,), cfg.layer.n_heads,
                                   cfg.max_seq_len, cfg.layer.head_dim,
                                   dtype=params["token_embs"].dtype, stacked=True)
        return {k: jax.device_put(v, NamedSharding(self._mesh, self._cache_spec[k]))
                for k, v in caches.items()}

    def _admit(self, params, cfg, *args):
        return self._admit_jit(params, *args)

    def _prefill_prefix(self, params, cfg, prefix_chunk):
        return self._prefix_jit(params, prefix_chunk)

    def _prefill_chunk(self, params, cfg, *args):
        return self._chunk_jit(params, *args)

    def _paste(self, *args):
        return self._paste_jit(*args)

    def _admit_prefix(self, params, cfg, *args):
        return self._admit_prefix_jit(params, *args)

    def _steps(self, params, cfg, buf, pad_lens, limits, ends, caches, pos,
               done, n_steps, eos_id, topk=1, top_p=None, temperature=None,
               keys=None, t0s=None, tps=None):
        if topk == 1 and top_p is None:
            return self._steps_jit(params, buf, pad_lens, limits, ends, caches,
                                   pos, done, n_steps, eos_id)
        return self._steps_sample_jit(params, buf, pad_lens, limits, ends, caches,
                                      pos, done, n_steps, eos_id, topk, top_p,
                                      temperature, keys, t0s, tps)

    # ---- int8 pool: width-sharded int8 caches + replicated full-width
    # scales, dequantized on read per rank (transformer.py _read_kv)
    def _i8_paste(self, *args):
        return self._i8_paste_jit(*args)

    def _i8_chunk(self, params, cfg, *args):
        return self._i8_chunk_jit(params, *args)

    def _i8_admit(self, params, cfg, *args):
        return self._i8_admit_jit(params, *args)

    def _i8_commit(self, *args):
        return self._i8_commit_jit(*args)


class TPWhisperContinuousBatchingGenerator(WhisperContinuousBatchingGenerator):
    """Whisper continuous batching with the model tp-sharded over ``("tp",)``.

    Admission's encoder + cross-KV projection and the pooled decode steps
    each run as one shard_map: self AND cross KV pools shard on the head
    width ``(L, B, Lmax|Lx, H*D/tp)`` per rank, the mel stem / embeddings
    replicate, and the host scheduler is inherited verbatim through the base
    class's sharding hooks. Token-identical per segment to the single-device
    ``WhisperGenerator.transcribe_tokens``.
    """

    def __init__(self, model, mesh: Mesh, tokenizer=None, batch_size: int = 4,
                 check_every: int = 16, pool_ctx: int | None = None) -> None:
        from ..models.audio2text.continuous import _wcb_admit_body, _wcb_steps_body
        from ..models.audio2text.whisper import DEC_MAX_LEN, _whisper_encode_body

        super().__init__(model, tokenizer, batch_size=batch_size,
                         check_every=check_every,
                         pool_ctx=pool_ctx if pool_ctx is not None else 2 * DEC_MAX_LEN)
        axes = dict(mesh.shape)
        assert set(axes) == {"tp"}, f'cb serving mesh needs a ("tp",) axis, got {tuple(axes)}'
        tp = axes["tp"]
        n_heads = model.cfg.dec_layer.n_heads
        assert n_heads % tp == 0, f"{n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(model.cfg, local_heads=n_heads // tp,
                            tp_axis="tp" if tp > 1 else None)
        self._mesh = mesh

        from .serving import decoder_lm_serving_pspecs as _lm_pspecs
        pspecs = _lm_pspecs(model.params)
        self._sharded_params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)
        cache_spec = {"k": P(None, None, None, "tp"), "v": P(None, None, None, "tp")}
        cross_spec = dict(cache_spec, len=P())
        self._cache_spec, self._cross_spec = cache_spec, cross_spec

        pre_fwd = self.preprocessor._forward

        def encode(params, wav):
            fn = jax.shard_map(
                lambda p, w: _whisper_encode_body(p, cfg_local, pre_fwd(w)),
                mesh=mesh, in_specs=(pspecs, P()), out_specs=P(), check_vma=False)
            return fn(params, wav)

        def admit(params, buf, caches, cross, pad_lens, limits, done,
                  row, pos, memory, init_chunk, max_new):
            fn = jax.shard_map(
                lambda p, *a: _wcb_admit_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cache_spec, cross_spec, P(), P(), P(),
                          P(), P(), P(), P(), P()),
                out_specs=(P(), cache_spec, cross_spec, P(), P(), P()),
                check_vma=False)
            return fn(params, buf, caches, cross, pad_lens, limits, done,
                      row, pos, memory, init_chunk, max_new)

        def steps(params, buf, pad_lens, limits, ends, caches, cross, pos,
                  done, n_steps, eot_id):
            def local(p, buf, pads, lims, ends, caches, cross, pos, done, n, eot):
                return _wcb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                       cross, pos, done, n, eot)

            cspec, xspec = _i8_spec(cache_spec, caches), _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, xspec,
                          P(), P(), P(), P()),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False)
            return fn(params, buf, pad_lens, limits, ends, caches, cross, pos,
                      done, n_steps, eot_id)

        def admit_i8(params, buf, caches, cross, pad_lens, limits, done,
                     row, pos, memory, init_chunk, max_new, i8_self, i8_cross):
            from ..models.audio2text.continuous import _wcb_admit_i8_body

            cspec, xspec = _i8_spec(cache_spec, caches), _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                lambda p, *a: _wcb_admit_i8_body(p, cfg_local, *a, i8_self, i8_cross),
                mesh=mesh,
                in_specs=(pspecs, P(), cspec, xspec, P(), P(), P(),
                          P(), P(), P(), P(), P()),
                out_specs=(P(), cspec, xspec, P(), P(), P()),
                check_vma=False)
            return fn(params, buf, caches, cross, pad_lens, limits, done,
                      row, pos, memory, init_chunk, max_new)

        def steps_sample(params, buf, pad_lens, limits, ends, caches, cross, pos,
                         done, n_steps, eot_id, topk, top_p, temperature, keys, t0s,
                         tps):
            # per-rank sampling is replicated math: hidden is psum-complete
            # and token_embs/keys are replicated -> every rank draws the same
            def local(p, buf, pads, lims, ends, caches, cross, pos, done, n, eot,
                      temp, keys, t0s, tps):
                return _wcb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                       cross, pos, done, n, eot, topk=topk, top_p=top_p, temperature=temp,
                                       keys=keys, t0s=t0s, tps=tps)

            cspec, xspec = _i8_spec(cache_spec, caches), _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, xspec,
                          P(), P(), P(), P(), P(), P(), P(), P()),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False)
            return fn(params, buf, pad_lens, limits, ends, caches, cross, pos,
                      done, n_steps, eot_id, temperature, keys, t0s, tps)

        self._encode = jax.jit(encode)
        self._admit_jit = jax.jit(admit)
        self._admit_i8_jit = jax.jit(admit_i8, static_argnums=(12, 13))
        self._steps_jit = jax.jit(steps)
        self._steps_sample_jit = jax.jit(steps_sample, static_argnums=(11, 12))

    # ---- sharding hooks ----------------------------------------------------
    def _params_cfg(self):
        return self._sharded_params, self.model.cfg

    def _init_pool(self, params, cfg, b, l_max, t_pad):
        lc = cfg.dec_layer
        dtype = self.model.params["decoder"]["token_embs"].dtype
        caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, l_max, lc.head_dim,
                                   dtype=dtype, stacked=True)
        caches = {k: jax.device_put(v, NamedSharding(self._mesh, self._cache_spec[k]))
                  for k, v in caches.items()}
        width = lc.n_heads * lc.head_dim
        cross = {
            "k": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "v": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "len": jnp.zeros((cfg.n_layers, b), jnp.int32),
        }
        cross = {k: jax.device_put(v, NamedSharding(self._mesh, self._cross_spec[k]))
                 for k, v in cross.items()}
        return caches, cross

    def _admit(self, params, cfg, *args):
        return self._admit_jit(params, *args)

    def _admit_i8(self, params, cfg, *args):
        return self._admit_i8_jit(params, *args)

    def _steps(self, params, cfg, buf, pad_lens, limits, ends, caches, cross, pos,
               done, n_steps, eot_id, topk=1, top_p=None, temperature=None, keys=None,
               t0s=None, tps=None):
        if topk == 1 and top_p is None:
            return self._steps_jit(params, buf, pad_lens, limits, ends, caches, cross,
                                   pos, done, n_steps, eot_id)
        return self._steps_sample_jit(params, buf, pad_lens, limits, ends, caches,
                                      cross, pos, done, n_steps, eot_id, topk, top_p,
                                      temperature, keys, t0s, tps)


class TPT5ContinuousBatchingGenerator(T5ContinuousBatchingGenerator):
    """T5 continuous batching with the model tp-sharded over ``("tp",)``.

    The pool's one global rel-pos decode-bias table shards on the head axis
    (each rank holds its heads' rows), self/cross KV pools shard on the head
    width, and admission's encoder + cross-KV projection runs as one
    shard_map. Token-identical per request to the single-device
    ``T5Generator.generate_tokens``.
    """

    def __init__(self, model, mesh: Mesh, tokenizer=None, batch_size: int = 4,
                 check_every: int = 16, pool_ctx: int | None = None) -> None:
        from ..models.text.t5_continuous import (
            _t5cb_admit_body,
            _t5cb_encode_body,
            _t5cb_steps_body,
        )

        super().__init__(model, tokenizer, batch_size=batch_size,
                         check_every=check_every, pool_ctx=pool_ctx)
        axes = dict(mesh.shape)
        assert set(axes) == {"tp"}, f'cb serving mesh needs a ("tp",) axis, got {tuple(axes)}'
        tp = axes["tp"]
        assert model.cfg.n_heads % tp == 0, f"{model.cfg.n_heads} heads not divisible by tp={tp}"
        cfg_local = replace(model.cfg, local_heads=model.cfg.n_heads // tp,
                            tp_axis="tp" if tp > 1 else None)
        self._mesh = mesh

        from .serving import t5_serving_pspecs
        pspecs = t5_serving_pspecs(model.params)
        self._sharded_params = jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), model.params, pspecs)
        cache_spec = {"k": P(None, None, None, "tp"), "v": P(None, None, None, "tp")}
        cross_spec = dict(cache_spec, len=P())
        bias_spec = P("tp", None, None)  # per-rank head rows of the global table
        self._cache_spec, self._cross_spec, self._bias_spec = cache_spec, cross_spec, bias_spec

        def encode(params, enc_tokens, n_enc):
            fn = jax.shard_map(
                lambda p, t, n: _t5cb_encode_body(p, cfg_local, t, n),
                mesh=mesh, in_specs=(pspecs, P(), P()), out_specs=P(), check_vma=False)
            return fn(params, enc_tokens, n_enc)

        def admit(params, buf, cross, pad_lens, limits, done,
                  row, pos, memory, n_enc, max_new, pad_id):
            fn = jax.shard_map(
                lambda p, *a: _t5cb_admit_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), cross_spec, P(), P(), P(),
                          P(), P(), P(), P(), P(), P()),
                out_specs=(P(), cross_spec, P(), P(), P()),
                check_vma=False)
            return fn(params, buf, cross, pad_lens, limits, done,
                      row, pos, memory, n_enc, max_new, pad_id)

        def steps(params, buf, pad_lens, limits, ends, caches, cross, pos,
                  done, n_steps, eos_id, bias_tab):
            def local(p, buf, pads, lims, ends, caches, cross, pos, done, n, eos, bias):
                return _t5cb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                        cross, pos, done, n, eos, bias)

            cspec, xspec = _i8_spec(cache_spec, caches), _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, xspec,
                          P(), P(), P(), P(), bias_spec),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False)
            return fn(params, buf, pad_lens, limits, ends, caches, cross, pos,
                      done, n_steps, eos_id, bias_tab)

        def admit_i8(params, buf, cross, pad_lens, limits, done,
                     row, pos, memory, n_enc, max_new, pad_id):
            from ..models.text.t5_continuous import _t5cb_admit_i8_body

            xspec = _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                lambda p, *a: _t5cb_admit_i8_body(p, cfg_local, *a),
                mesh=mesh,
                in_specs=(pspecs, P(), xspec, P(), P(), P(),
                          P(), P(), P(), P(), P(), P()),
                out_specs=(P(), xspec, P(), P(), P()),
                check_vma=False)
            return fn(params, buf, cross, pad_lens, limits, done,
                      row, pos, memory, n_enc, max_new, pad_id)

        def steps_sample(params, buf, pad_lens, limits, ends, caches, cross, pos,
                         done, n_steps, eos_id, bias_tab, topk, top_p, temperature,
                         keys, t0s, tps):
            # per-rank sampling is replicated math: hidden is psum-complete
            # and classifier/keys are replicated -> every rank draws the same
            def local(p, buf, pads, lims, ends, caches, cross, pos, done, n, eos,
                      bias, temp, keys, t0s, tps):
                return _t5cb_steps_body(p, cfg_local, buf, pads, lims, ends, caches,
                                        cross, pos, done, n, eos, bias, topk=topk, top_p=top_p, temperature=temp,
                                        keys=keys, t0s=t0s, tps=tps)

            cspec, xspec = _i8_spec(cache_spec, caches), _i8_spec(cross_spec, cross)
            fn = jax.shard_map(
                local, mesh=mesh,
                in_specs=(pspecs, P(), P(), P(), P(), cspec, xspec,
                          P(), P(), P(), P(), bias_spec, P(), P(), P(), P()),
                out_specs=(P(), P(), cspec, P(), P()),
                check_vma=False)
            return fn(params, buf, pad_lens, limits, ends, caches, cross, pos,
                      done, n_steps, eos_id, bias_tab, temperature, keys, t0s, tps)

        self._encode_jit = jax.jit(encode)
        self._admit_jit = jax.jit(admit)
        self._admit_i8_jit = jax.jit(admit_i8)
        self._steps_jit = jax.jit(steps)
        self._steps_sample_jit = jax.jit(steps_sample, static_argnums=(12, 13))

    # ---- sharding hooks ----------------------------------------------------
    def _params_cfg(self):
        return self._sharded_params, self.model.cfg

    def _encode(self, params, cfg, enc_tokens, n_enc):
        return self._encode_jit(params, enc_tokens, n_enc)

    def _init_pool(self, params, cfg, b, l_max, t_pad):
        from ..models.text.t5 import relative_position_bias

        lc = cfg.layer
        dtype = self.model.params["token_embs"].dtype
        dec = self.model.params["decoder"]  # unsharded: build the GLOBAL table
        l_pad = tfm.padded_cache_len(l_max)
        bias_tab = relative_position_bias(
            dec["attn_bias"], jnp.arange(l_max), jnp.arange(l_pad), False, cfg)
        bias_tab = jax.device_put(bias_tab, NamedSharding(self._mesh, self._bias_spec))
        caches = tfm.make_kv_cache(cfg.n_layers, (b,), lc.n_heads, l_max, lc.head_dim,
                                   dtype=dtype, stacked=True)
        caches = {k: jax.device_put(v, NamedSharding(self._mesh, self._cache_spec[k]))
                  for k, v in caches.items()}
        width = lc.n_heads * lc.head_dim
        cross = {
            "k": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "v": jnp.zeros((cfg.n_layers, b, t_pad, width), dtype),
            "len": jnp.zeros((cfg.n_layers, b), jnp.int32),
        }
        cross = {k: jax.device_put(v, NamedSharding(self._mesh, self._cross_spec[k]))
                 for k, v in cross.items()}
        return caches, cross, bias_tab

    def _admit(self, params, cfg, *args):
        return self._admit_jit(params, *args)

    def _admit_i8(self, params, cfg, *args):
        return self._admit_i8_jit(params, *args)

    def _steps(self, params, cfg, buf, pad_lens, limits, ends, caches, cross, pos,
               done, n_steps, eos_id, bias_tab, topk=1, top_p=None, temperature=None,
               keys=None, t0s=None, tps=None):
        if topk == 1 and top_p is None:
            return self._steps_jit(params, buf, pad_lens, limits, ends, caches, cross,
                                   pos, done, n_steps, eos_id, bias_tab)
        return self._steps_sample_jit(params, buf, pad_lens, limits, ends, caches,
                                      cross, pos, done, n_steps, eos_id, bias_tab,
                                      topk, top_p, temperature, keys, t0s, tps)
