"""EnCodec neural audio codec (reference pytorch_models/audio/encodec.py).

Encoder: conv stem → 4× [residual block + strided downsample conv (2,4,5,8)]
→ 2-layer residual LSTM → projection (ref encodec.py:96-117). Decoder mirrors
with transposed convs (ref encodec.py:123-148). RVQ: residual stack of 32/16
frozen codebooks (ref encodec.py:152-185). Variants: 24khz (mono, causal,
weight_norm, 32q) / 48khz (stereo, time_group_norm, 16q, loudness normalize)
(ref encodec.py:216-221).

Layout notes: all convs run NLC; the LSTM — the reference's one
torch.compile graph break (tests/audio/test_encodec.py:29-31) — is a
``lax.scan`` cell here, so the whole codec jits; reflect padding with
extra right-pad to a stride multiple reproduces ref encodec.py:11-21.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ...ops.layers import conv1d
from ...ops.layers import dot_precision as _dot_precision
from ...utils import StateDict, hub_download
from pytorch_models_tpu.utils.module import InferenceModel

ELU = jax.nn.elu


@dataclass(frozen=True)
class EnCodecConfig:
    audio_channels: int
    norm_type: str
    causal: bool
    n_quantizers: int
    normalize: bool
    base_dim: int = 32
    dim: int = 128
    strides: tuple[int, ...] = (2, 4, 5, 8)
    codebook_size: int = 1024


# ---------------------------------------------------------------------------
# Padded conv / transposed conv (ref encodec.py:11-70)
# ---------------------------------------------------------------------------


def pad1d(x: jnp.ndarray, kernel_size: int, stride: int, causal: bool) -> jnp.ndarray:
    """Reflect pad + extra right pad to a stride multiple (ref encodec.py:11-21). NLC."""
    total = kernel_size - stride
    right = 0 if causal else total // 2
    left = total - right
    length = x.shape[-2]
    extra = math.ceil(length / stride) * stride - length
    return jnp.pad(x, ((0, 0), (left, right + extra), (0, 0)), mode="reflect")


def unpad1d(x: jnp.ndarray, kernel_size: int, stride: int, causal: bool) -> jnp.ndarray:
    """Trim transposed-conv overhang (ref encodec.py:24-32). NLC."""
    total = kernel_size - stride
    right = total if causal else total // 2
    left = total - right
    return x[:, left : x.shape[-2] - right, :]


def group_norm(p: dict, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """GroupNorm(1, C) on NLC data: normalize over (L, C) jointly per sample."""
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=(-2, -1), keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=(-2, -1), keepdims=True)
    y = (x32 - mean) * lax.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).astype(x.dtype)


def ec_conv(p: dict, cfg: EnCodecConfig, x: jnp.ndarray, kernel_size: int, stride: int = 1) -> jnp.ndarray:
    x = pad1d(x, kernel_size, stride, cfg.causal)
    y = conv1d(p, x, stride=stride)
    if "norm" in p:
        y = group_norm(p["norm"], y)
    return y


def ec_conv_transpose(p: dict, cfg: EnCodecConfig, x: jnp.ndarray, kernel_size: int, stride: int) -> jnp.ndarray:
    """torch ConvTranspose1d (VALID) + Unpad1d. Kernel stored pre-flipped (k, in, out)."""
    y = lax.conv_general_dilated(
        x,
        p["w"].astype(x.dtype),
        window_strides=(1,),
        padding=((kernel_size - 1, kernel_size - 1),),
        lhs_dilation=(stride,),
        dimension_numbers=("NWC", "WIO", "NWC"),
    )
    y = y + p["b"].astype(y.dtype)
    if "norm" in p:
        y = group_norm(p["norm"], y)
    return unpad1d(y, kernel_size, stride, cfg.causal)


# ---------------------------------------------------------------------------
# LSTM as lax.scan (ref encodec.py:73-78; kills the reference's compile break)
# ---------------------------------------------------------------------------


def lstm_apply(layers: list[dict], x: jnp.ndarray) -> jnp.ndarray:
    """Residual 2-layer LSTM over NLC input (torch gate order i,f,g,o)."""
    h0 = x
    for lp in layers:
        w_ih, w_hh, b = lp["w_ih"], lp["w_hh"], lp["b"]
        dim = w_hh.shape[0]
        bsz = x.shape[0]

        def cell(carry, xt):
            h, c = carry
            from ...ops.layers import dot_precision

            prec = dot_precision(xt)
            gates = jnp.matmul(xt, w_ih, precision=prec) + jnp.matmul(h, w_hh, precision=prec) + b
            i, f, g, o = jnp.split(gates, 4, axis=-1)
            c = jax.nn.sigmoid(f) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
            h = jax.nn.sigmoid(o) * jnp.tanh(c)
            return (h, c), h

        init = (jnp.zeros((bsz, dim), x.dtype), jnp.zeros((bsz, dim), x.dtype))
        _, ys = lax.scan(cell, init, jnp.swapaxes(x, 0, 1))
        x = jnp.swapaxes(ys, 0, 1)
    return h0 + x


# ---------------------------------------------------------------------------
# Blocks / encoder / decoder (ref encodec.py:81-148)
# ---------------------------------------------------------------------------


def ec_block(p: dict, cfg: EnCodecConfig, x: jnp.ndarray) -> jnp.ndarray:
    h = ec_conv(p["conv1"], cfg, ELU(x), 3, 1)
    h = ec_conv(p["conv2"], cfg, ELU(h), 1, 1)
    return ec_conv(p["shortcut"], cfg, x, 1, 1) + h


def encoder_apply(p: dict, cfg: EnCodecConfig, x: jnp.ndarray) -> jnp.ndarray:
    x = ec_conv(p["conv_in"], cfg, x, 7, 1)
    for stage, stride in zip(p["stages"], cfg.strides):
        x = ec_block(stage["block"], cfg, x)
        x = ec_conv(stage["down"], cfg, ELU(x), stride * 2, stride)
    x = lstm_apply(p["lstm"], x)
    x = ec_conv(p["conv_out"], cfg, ELU(x), 7, 1)
    return x


def decoder_apply(p: dict, cfg: EnCodecConfig, x: jnp.ndarray) -> jnp.ndarray:
    x = ec_conv(p["conv_in"], cfg, x, 7, 1)
    x = lstm_apply(p["lstm"], x)
    for stage, stride in zip(p["stages"], cfg.strides[::-1]):
        x = ec_conv_transpose(stage["up"], cfg, ELU(x), stride * 2, stride)
        x = ec_block(stage["block"], cfg, x)
    x = ec_conv(p["conv_out"], cfg, ELU(x), 7, 1)
    return x


# ---------------------------------------------------------------------------
# Residual vector quantization (ref encodec.py:152-185)
# ---------------------------------------------------------------------------


def rvq_quantize(embed: jnp.ndarray, x: jnp.ndarray, n_quantizers: int) -> jnp.ndarray:
    """``embed``: (nq, K, D); ``x``: (..., D) -> codes (n_quantizers, ...)."""

    def body(residual, codebook):
        d = (
            jnp.sum(jnp.square(residual), axis=-1, keepdims=True)
            - 2 * jnp.matmul(residual, codebook.T, precision=_dot_precision(residual))
            + jnp.sum(jnp.square(codebook), axis=-1)
        )
        idx = jnp.argmin(d, axis=-1)
        return residual - codebook[idx], idx

    _, codes = lax.scan(body, x, embed[:n_quantizers])
    return codes


def rvq_dequantize(embed: jnp.ndarray, codes: jnp.ndarray) -> jnp.ndarray:
    """codes: (nq_used, ...) -> (..., D); sum of per-level codebook lookups."""

    def body(acc, inp):
        codebook, idx = inp
        return acc + codebook[idx], None

    nq = codes.shape[0]
    init = jnp.zeros((*codes.shape[1:], embed.shape[-1]), embed.dtype)
    out, _ = lax.scan(body, init, (embed[:nq], codes))
    return out


@partial(jax.jit, static_argnums=(1, 3))
def encodec_encode(params, cfg: EnCodecConfig, x, n_quantizers: int):
    """(B, C, L) waveform -> ((B, nq, T) codes, (B,1,1) scale | None) (ref encodec.py:196-205)."""
    if cfg.normalize:
        scale = jnp.sqrt(jnp.mean(jnp.square(jnp.mean(x, axis=1, keepdims=True)), axis=2, keepdims=True)) + 1e-8
        x = x / scale
    else:
        scale = None
    h = encoder_apply(params["encoder"], cfg, jnp.swapaxes(x, 1, 2))
    codes = rvq_quantize(params["quantizer"]["embed"], h, n_quantizers)
    return jnp.swapaxes(codes, 0, 1), scale


@partial(jax.jit, static_argnums=1)
def encodec_decode(params, cfg: EnCodecConfig, codes, scale=None):
    """(B, nq, T) codes [+scale] -> (B, C, L) waveform (ref encodec.py:207-213)."""
    h = rvq_dequantize(params["quantizer"]["embed"], jnp.swapaxes(codes, 0, 1))
    y = decoder_apply(params["decoder"], cfg, h)
    y = jnp.swapaxes(y, 1, 2)
    if scale is not None:
        y = y * scale
    return y


class EnCodec(InferenceModel):
    def __init__(self, audio_channels: int, norm_type: str, causal: bool, n_quantizers: int, normalize: bool,
                 rng: int = 0) -> None:
        self.cfg = EnCodecConfig(audio_channels, norm_type, causal, n_quantizers, normalize)
        self.params = encodec_init(jax.random.PRNGKey(rng), self.cfg)

    def encode(self, x, n_quantizers: int | None = None):
        return encodec_encode(self.params, self.cfg, jnp.asarray(x), n_quantizers or self.cfg.n_quantizers)

    def decode(self, codes, scale=None):
        return encodec_decode(self.params, self.cfg, jnp.asarray(codes), scale)

    @staticmethod
    def from_facebook(variant: str, pretrained: bool = False) -> "EnCodec":
        audio_channels, norm_type, causal, n_quantizers, normalize = {
            "24khz": (1, "weight_norm", True, 32, False),
            "48khz": (2, "time_group_norm", False, 16, True),
        }[variant]
        m = EnCodec(audio_channels, norm_type, causal, n_quantizers, normalize)
        if pretrained:
            from ...utils.torch_ckpt import load_torch_checkpoint

            ckpt = {"24khz": "encodec_24khz-d7cc33bc.th", "48khz": "encodec_48khz-7e698e3e.th"}[variant]
            m.load_facebook_state_dict(load_torch_checkpoint(hub_download("https://dl.fbaipublicfiles.com/encodec/v0/" + ckpt)))
        return m

    def load_facebook_state_dict(self, state_dict: dict) -> None:
        """Convert the facebookresearch/encodec checkpoint (keys per ref encodec.py:238-248).

        weight_norm convs ship weight_g/weight_v with torch's default dim=0:
        reconstruct ``w = g * v / ||v||_(1,2)``. ConvTranspose kernels (in,out,k)
        are pre-flipped into (k, in, out) for the lhs-dilated conv formulation.
        """
        sd = StateDict({k.removeprefix("model."): v for k, v in state_dict.items()})
        cfg = self.cfg
        wn = cfg.norm_type == "weight_norm"

        def conv(pfx: str, transpose: bool = False) -> dict:
            inner = "convtr.convtr" if transpose else "conv.conv"
            if wn:
                g = sd.pop(f"{pfx}.{inner}.weight_g", None)
                if g is None:
                    g = sd.pop(f"{pfx}.{inner}.parametrizations.weight.original0")
                    v = sd.pop(f"{pfx}.{inner}.parametrizations.weight.original1")
                else:
                    v = sd.pop(f"{pfx}.{inner}.weight_v")
                norm = np.sqrt(np.sum(v**2, axis=(1, 2), keepdims=True))
                w = g * v / norm
            else:
                w = sd.pop(f"{pfx}.{inner}.weight")
            p = {"b": sd.pop(f"{pfx}.{inner}.bias")}
            if transpose:  # (in, out, k) -> flipped (k, in, out)
                p["w"] = np.transpose(w[:, :, ::-1], (2, 0, 1))
            else:  # (out, in, k) -> (k, in, out)
                p["w"] = np.transpose(w, (2, 1, 0))
            if not wn:
                inner_norm = "convtr.norm" if transpose else "conv.norm"
                p["norm"] = {"scale": sd.pop(f"{pfx}.{inner_norm}.weight"), "bias": sd.pop(f"{pfx}.{inner_norm}.bias")}
            return p

        def block(pfx: str) -> dict:
            return {"conv1": conv(f"{pfx}.block.1"), "conv2": conv(f"{pfx}.block.3"), "shortcut": conv(f"{pfx}.shortcut")}

        def lstm(pfx: str) -> list[dict]:
            out = []
            for i in range(2):
                w_ih = sd.pop(f"{pfx}.lstm.weight_ih_l{i}")
                w_hh = sd.pop(f"{pfx}.lstm.weight_hh_l{i}")
                b = sd.pop(f"{pfx}.lstm.bias_ih_l{i}") + sd.pop(f"{pfx}.lstm.bias_hh_l{i}")
                out.append({"w_ih": w_ih.T, "w_hh": w_hh.T, "b": b})
            return out

        n_stages = len(cfg.strides)
        enc = {
            "conv_in": conv("encoder.model.0"),
            "stages": [{"block": block(f"encoder.model.{1 + 3 * i}"), "down": conv(f"encoder.model.{3 + 3 * i}")}
                       for i in range(n_stages)],
            "lstm": lstm(f"encoder.model.{1 + 3 * n_stages}"),
            "conv_out": conv(f"encoder.model.{3 + 3 * n_stages}"),
        }
        dec = {
            "conv_in": conv("decoder.model.0"),
            "lstm": lstm("decoder.model.1"),
            "stages": [{"up": conv(f"decoder.model.{3 + 3 * i}", transpose=True),
                        "block": block(f"decoder.model.{4 + 3 * i}")}
                       for i in range(n_stages)],
            "conv_out": conv(f"decoder.model.{3 + 3 * n_stages}"),
        }
        embed = np.stack([sd.pop(f"quantizer.vq.layers.{i}._codebook.embed") for i in range(cfg.n_quantizers)])
        for k in list(sd.keys()):  # training-only codebook stats
            if k.endswith(("inited", "cluster_size", "embed_avg")) or k == "bandwidth":
                sd.pop(k)
        sd.finalize()
        p = {"encoder": enc, "decoder": dec, "quantizer": {"embed": embed}}
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)


def encodec_init(key, cfg: EnCodecConfig) -> dict:
    """Random init with the same topology (codebooks zero like the ref buffer)."""
    from ...ops.layers import conv1d_init

    def conv_p(k, kern, cin, cout, transpose=False):
        p = conv1d_init(k, kern, cin, cout)  # (k, in, out) works for both directions
        if cfg.norm_type == "time_group_norm":
            p["norm"] = {"scale": jnp.ones((cout,), jnp.float32), "bias": jnp.zeros((cout,), jnp.float32)}
        return p

    keys = iter(jax.random.split(key, 64))

    def block_p(dim):
        return {
            "conv1": conv_p(next(keys), 3, dim, dim // 2),
            "conv2": conv_p(next(keys), 1, dim // 2, dim),
            "shortcut": conv_p(next(keys), 1, dim, dim),
        }

    def lstm_p(dim):
        out = []
        for _ in range(2):
            k1, k2, k3 = jax.random.split(next(keys), 3)
            bound = 1 / math.sqrt(dim)
            out.append(
                {
                    "w_ih": jax.random.uniform(k1, (dim, 4 * dim), jnp.float32, -bound, bound),
                    "w_hh": jax.random.uniform(k2, (dim, 4 * dim), jnp.float32, -bound, bound),
                    "b": jax.random.uniform(k3, (4 * dim,), jnp.float32, -bound, bound),
                }
            )
        return out

    d = cfg.base_dim
    enc = {"conv_in": conv_p(next(keys), 7, cfg.audio_channels, d), "stages": []}
    for s in cfg.strides:
        enc["stages"].append({"block": block_p(d), "down": conv_p(next(keys), s * 2, d, d * 2)})
        d *= 2
    enc["lstm"] = lstm_p(d)
    enc["conv_out"] = conv_p(next(keys), 7, d, cfg.dim)

    dec = {"conv_in": conv_p(next(keys), 7, cfg.dim, d), "lstm": lstm_p(d), "stages": []}
    for s in cfg.strides[::-1]:
        dec["stages"].append({"up": conv_p(next(keys), s * 2, d, d // 2, transpose=True), "block": block_p(d // 2)})
        d //= 2
    dec["conv_out"] = conv_p(next(keys), 7, d, cfg.audio_channels)

    embed = jax.random.normal(next(keys), (cfg.n_quantizers, cfg.codebook_size, cfg.dim), jnp.float32)
    return {"encoder": enc, "decoder": dec, "quantizer": {"embed": embed}}
