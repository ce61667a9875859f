"""Wav2Vec2 (also loads HuBERT / MMS / XLS-R checkpoints).

Reference: pytorch_models/audio/wav2vec2.py. 7-layer strided Conv1d waveform
feature encoder (total downsample 320×; per-layer channel LayerNorm, or
legacy mode = affine InstanceNorm on layer 0 only, ref wav2vec2.py:19-39) →
LN (+proj if dims differ) → grouped-conv relative PE (kernel 128, groups 16,
asymmetric same-pad for the even kernel, ref wav2vec2.py:69-73) added
residually → Encoder (pre- or post-norm per config, ref wav2vec2.py:84).

All 1D convs run NLC (channels-last, XLA's native conv layout).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ... import transformer as tfm
from ...ops import ACT_FNS, layer_norm
from ...ops.layers import conv1d, conv1d_init
from ...utils import StateDict, stack_layers
from pytorch_models_tpu.utils.module import InferenceModel


@dataclass(frozen=True)
class Wav2Vec2Config:
    n_layers: int
    d_model: int
    stem_dims: tuple[int, ...]
    stem_kernels: tuple[int, ...]
    stem_strides: tuple[int, ...]
    pe_kernel: int
    pe_groups: int
    stem_bias: bool = True
    stem_legacy: bool = False
    pre_norm: bool = True
    pe_layers: int = 1  # >1 only for Data2VecAudio

    @property
    def layer(self) -> tfm.LayerConfig:
        return tfm.LayerConfig.make(self.d_model, pre_norm=self.pre_norm)


def instance_norm_1d(p: dict | None, x: jnp.ndarray, eps: float = 1e-5) -> jnp.ndarray:
    """torch InstanceNorm1d on NLC data: normalize over time per (batch, channel)."""
    x32 = x.astype(jnp.float32)
    mean = jnp.mean(x32, axis=-2, keepdims=True)
    var = jnp.mean(jnp.square(x32 - mean), axis=-2, keepdims=True)
    y = (x32 - mean) * jax.lax.rsqrt(var + eps)
    if p is not None:
        y = y * p["scale"].astype(jnp.float32) + p["bias"].astype(jnp.float32)
    return y.astype(x.dtype)


def stem_init(key, cfg: Wav2Vec2Config) -> list[dict]:
    layers = []
    in_dim = 1
    keys = jax.random.split(key, len(cfg.stem_dims))
    for i, (out_dim, k) in enumerate(zip(cfg.stem_dims, cfg.stem_kernels)):
        lp = {"conv": conv1d_init(keys[i], k, in_dim, out_dim, bias=cfg.stem_bias)}
        if cfg.stem_legacy:
            if i == 0:
                lp["norm"] = tfm.ln_init(out_dim)  # affine InstanceNorm params
        else:
            lp["norm"] = tfm.ln_init(out_dim)
        layers.append(lp)
        in_dim = out_dim
    return layers


def stem_apply(layers: list[dict], cfg: Wav2Vec2Config, x: jnp.ndarray) -> jnp.ndarray:
    """Waveform (B, L) -> features (B, T, C) (ref wav2vec2.py:19-39, 80)."""
    x = x[..., None]  # (B, L, 1)
    gelu = ACT_FNS["gelu"]
    for i, (lp, stride) in enumerate(zip(layers, cfg.stem_strides)):
        x = conv1d(lp["conv"], x, stride=stride)
        if cfg.stem_legacy:
            if i == 0:
                x = instance_norm_1d(lp["norm"], x)
        else:
            x = layer_norm(lp["norm"], x)
        x = gelu(x)
    return x


def pe_conv_init(key, cfg: Wav2Vec2Config) -> list[dict]:
    keys = jax.random.split(key, cfg.pe_layers)
    d = cfg.d_model
    return [{"conv": conv1d_init(k, cfg.pe_kernel, d, d, groups=cfg.pe_groups)} for k in keys]


def pe_conv_apply(layers: list[dict], cfg: Wav2Vec2Config, x: jnp.ndarray, stride: int = 1) -> jnp.ndarray:
    """Grouped relative-PE conv; even kernels use asymmetric same-pad (ref wav2vec2.py:70)."""
    k = cfg.pe_kernel
    pad = (k // 2, k // 2 - 1)  # ConstantPad1d((k//2, k//2-1)) per ref wav2vec2.py:70
    if cfg.pe_layers > 1:  # Data2VecAudio-style stacked blocks (data2vec_audio.py:23-30)
        for lp in layers:
            x = conv1d(lp["conv"], x, padding=k // 2, groups=cfg.pe_groups)
            x = layer_norm(None, x)  # non-affine channel LN
            x = ACT_FNS["gelu"](x)
        return x
    x = conv1d(layers[0]["conv"], x, stride=stride, padding=pad, groups=cfg.pe_groups)
    return ACT_FNS["gelu"](x)


def wav2vec2_init(key, cfg: Wav2Vec2Config) -> dict:
    ks = jax.random.split(key, 4)
    in_dim = cfg.stem_dims[-1]
    p = {
        "stem": stem_init(ks[0], cfg),
        "proj_norm": tfm.ln_init(in_dim),
        "pe_conv": pe_conv_init(ks[1], cfg),
        "encoder": tfm.encoder_init(ks[2], cfg.n_layers, cfg.layer),
        "norm": tfm.ln_init(cfg.d_model),
    }
    if in_dim != cfg.d_model:
        p["proj"] = tfm.linear_init(ks[3], in_dim, cfg.d_model)
    return p


@partial(jax.jit, static_argnums=1)
def wav2vec2_apply(params: dict, cfg: Wav2Vec2Config, x: jnp.ndarray) -> jnp.ndarray:
    """Forward (ref wav2vec2.py:78-85). ``x``: (B, L) waveform."""
    x = stem_apply(params["stem"], cfg, x)
    x = layer_norm(params["proj_norm"], x)
    if "proj" in params:
        x = tfm.linear(params["proj"], x)
    x = x + pe_conv_apply(params["pe_conv"], cfg, x)
    if cfg.pre_norm:
        x = layer_norm(params["norm"], tfm.encoder_apply(params["encoder"], cfg.layer, x))
    else:
        x = tfm.encoder_apply(params["encoder"], cfg.layer, layer_norm(params["norm"], x))
    return x


def _pop_weight_norm_conv(sd: StateDict, prefix: str) -> dict:
    """Reverse ``torch.nn.utils.weight_norm`` on the PE conv (ref wav2vec2.py:133-137)."""
    g = sd.pop(f"{prefix}.weight_g", None)
    if g is None:
        g = sd.pop(f"{prefix}.parametrizations.weight.original0")  # newer torch naming
        v = sd.pop(f"{prefix}.parametrizations.weight.original1")
    else:
        v = sd.pop(f"{prefix}.weight_v")
    norm = np.sqrt(np.sum(v**2, axis=(0, 1), keepdims=True))
    w = g * v / norm  # (out, in/groups, k)
    return {"w": np.transpose(w, (2, 1, 0)), "b": sd.pop(f"{prefix}.bias")}


class Wav2Vec2(InferenceModel):
    STEM_DIMS = (512,) * 7
    STEM_KERNELS = (10,) + (3,) * 4 + (2,) * 2
    STEM_STRIDES = (5,) + (2,) * 6
    PE_KERNEL = 128
    PE_GROUPS = 16

    def __init__(
        self,
        n_layers: int,
        d_model: int,
        stem_bias: bool = True,
        stem_legacy: bool = False,
        dropout: float = 0.0,
        pre_norm: bool = True,
        rng: int = 0,
    ) -> None:
        self.cfg = Wav2Vec2Config(
            n_layers, d_model, self.STEM_DIMS, self.STEM_KERNELS, self.STEM_STRIDES,
            self.PE_KERNEL, self.PE_GROUPS, stem_bias, stem_legacy, pre_norm,
        )
        self.params = wav2vec2_init(jax.random.PRNGKey(rng), self.cfg)

    def __call__(self, x) -> jnp.ndarray:
        return wav2vec2_apply(self.params, self.cfg, jnp.asarray(x))

    @classmethod
    def from_hf(cls, model_tag: str, *, pretrained: bool = False, config: dict | None = None, **kwargs):
        """Architecture derived from the HF config.json (ref wav2vec2.py:87-103)."""
        if config is None:
            import requests

            config = json.loads(requests.get(f"https://huggingface.co/{model_tag}/raw/main/config.json", timeout=30).content)
        assert config["hidden_size"] == config["num_attention_heads"] * 64
        _kwargs = dict(
            n_layers=config["num_hidden_layers"],
            d_model=config["hidden_size"],
            stem_bias=config["conv_bias"],
        )
        if cls is Wav2Vec2 and "feat_extract_norm" in config:
            _kwargs["stem_legacy"] = config["feat_extract_norm"] == "group"
        if cls is Wav2Vec2 and "do_stable_layer_norm" in config:
            _kwargs["pre_norm"] = config["do_stable_layer_norm"]
        m = cls(**_kwargs, **kwargs)
        if pretrained:
            from ...utils.download import load_hf_checkpoint

            state_dict = load_hf_checkpoint(model_tag)
            state_dict = {k.replace("wav2vec2.", ""): v for k, v in state_dict.items()}
            m.load_hf_state_dict(state_dict)
        return m

    # key layout shared by the whole family (ref wav2vec2.py:113-152)
    def _pop_stem(self, sd: StateDict) -> list[dict]:
        layers = []
        for i in range(len(self.cfg.stem_dims)):
            pfx = f"feature_extractor.conv_layers.{i}"
            lp = {"conv": sd.pop_conv1d(f"{pfx}.conv", bias=self.cfg.stem_bias)}
            if (not self.cfg.stem_legacy) or i == 0:
                lp["norm"] = sd.pop_ln(f"{pfx}.layer_norm")
            layers.append(lp)
        return layers

    def _pop_encoder(self, sd: StateDict) -> dict:
        layers = []
        for i in range(self.cfg.n_layers):
            pfx = f"encoder.layers.{i}"
            layers.append(
                {
                    "sa": {
                        "q": sd.pop_linear(f"{pfx}.attention.q_proj"),
                        "k": sd.pop_linear(f"{pfx}.attention.k_proj"),
                        "v": sd.pop_linear(f"{pfx}.attention.v_proj"),
                        "o": sd.pop_linear(f"{pfx}.attention.out_proj"),
                    },
                    "sa_norm": sd.pop_ln(f"{pfx}.layer_norm"),
                    "mlp": {
                        "fc1": sd.pop_linear(f"{pfx}.feed_forward.intermediate_dense"),
                        "fc2": sd.pop_linear(f"{pfx}.feed_forward.output_dense"),
                    },
                    "mlp_norm": sd.pop_ln(f"{pfx}.final_layer_norm"),
                }
            )
        return {"layers": stack_layers([jax.tree.map(jnp.asarray, l) for l in layers])}

    def _drop_extra(self, sd: StateDict) -> None:
        for k in list(sd.keys()):
            if k.startswith(("quantizer.", "project_", "masked_spec_embed", "label_embs", "final_proj", "lm_head")):
                sd.pop(k)

    def load_hf_state_dict(self, state_dict: dict) -> None:
        sd = StateDict(state_dict)
        p: dict = {"stem": self._pop_stem(sd)}
        p["proj_norm"] = sd.pop_ln("feature_projection.layer_norm")
        if "feature_projection.projection.weight" in sd:
            p["proj"] = sd.pop_linear("feature_projection.projection")
        p["pe_conv"] = [{"conv": _pop_weight_norm_conv(sd, "encoder.pos_conv_embed.conv")}]
        p["norm"] = sd.pop_ln("encoder.layer_norm")
        p["encoder"] = self._pop_encoder(sd)
        self._drop_extra(sd)
        sd.finalize()
        self.params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), p)
