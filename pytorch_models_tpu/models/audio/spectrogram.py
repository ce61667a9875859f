"""Spectrogram / MelSpectrogram (reference pytorch_models/audio/spectrogram.py).

``torch.stft``-compatible power spectrogram: centered reflect padding, periodic
Hann window, rFFT (ref spectrogram.py:7-16). ``get_mel_filters`` re-implements
librosa's Slaney-scale mel filterbank (linear < 1 kHz, log ≥ 1 kHz breakpoint
math, ref spectrogram.py:19-35). Framing is strided slices + one batched
rFFT, which XLA fuses.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, matching ``torch.hann_window`` defaults."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def frame_signal(x: jnp.ndarray, n_fft: int, hop_length: int) -> jnp.ndarray:
    """Centered overlapping frames: (..., L) -> (..., n_frames, n_fft).

    Built from ``gcd(n_fft, hop)``-sized chunks with strided slices instead of
    a gather: frame i, chunk j is signal chunk ``i*step + j``, so each j is
    one strided slice of the chunked signal (no (n_frames, n_fft) index
    gather).
    """
    pad = n_fft // 2
    x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    n_frames = (x.shape[-1] - n_fft) // hop_length + 1
    g = math.gcd(n_fft, hop_length)
    step = hop_length // g
    per_frame = n_fft // g
    need = (n_frames - 1) * hop_length + n_fft
    total = -(-need // g) * g
    if total > x.shape[-1]:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, total - x.shape[-1])])
    else:
        x = x[..., :total]
    chunks = x.reshape(*x.shape[:-1], total // g, g)
    cols = [
        jax.lax.slice_in_dim(chunks, j, j + (n_frames - 1) * step + 1, step, axis=-2)
        for j in range(per_frame)
    ]
    return jnp.concatenate(cols, axis=-1)


@partial(jax.jit, static_argnums=(1, 2))
def power_spectrogram(x: jnp.ndarray, n_fft: int, hop_length: int) -> jnp.ndarray:
    """|STFT|² with a Hann window: (..., L) -> (..., n_fft//2+1, n_frames)."""
    frames = frame_signal(x, n_fft, hop_length) * jnp.asarray(hann_window(n_fft))
    spec = jnp.fft.rfft(frames.astype(jnp.float32), axis=-1)
    power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
    return jnp.swapaxes(power, -1, -2)


def get_mel_filters(n_mels: int, n_fft: int, sample_rate: float) -> np.ndarray:
    """Slaney-scale mel filterbank (ref spectrogram.py:19-35)."""
    f_max = sample_rate / 2
    mel_max = f_max * 3 / 200 if f_max < 1000 else 15 + 27 * math.log(f_max / 1000, 6.4)

    mel_freqs = np.linspace(0, mel_max, n_mels + 2, dtype=np.float64)
    mel_freqs = np.where(mel_freqs < 15, mel_freqs * 200 / 3, 1000 * 6.4 ** ((mel_freqs - 15) / 27))
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1, dtype=np.float64)

    mel_diff = np.diff(mel_freqs)  # (n_mels + 1)
    ramp = mel_freqs[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_fft//2 + 1)

    lower = -ramp[:-2] / mel_diff[:-1, None]
    upper = ramp[2:] / mel_diff[1:, None]
    filters = np.clip(np.minimum(lower, upper), 0, None)

    filters *= 2 / (mel_freqs[2:, None] - mel_freqs[:-2, None])
    return filters.astype(np.float32)


class Spectrogram:
    def __init__(self, n_fft: int, hop_length: int) -> None:
        self.n_fft = n_fft
        self.hop_length = hop_length

    def __call__(self, x) -> jnp.ndarray:
        return power_spectrogram(jnp.asarray(x), self.n_fft, self.hop_length)


class MelSpectrogram(Spectrogram):
    def __init__(self, n_fft: int, hop_length: int, n_mels: int, sample_rate: int) -> None:
        super().__init__(n_fft, hop_length)
        self.filters = jnp.asarray(get_mel_filters(n_mels, n_fft, sample_rate))

    def __call__(self, x) -> jnp.ndarray:
        spec = super().__call__(x)
        from pytorch_models_tpu.ops.layers import dot_precision

        return jnp.matmul(self.filters.astype(spec.dtype), spec, precision=dot_precision(spec))
