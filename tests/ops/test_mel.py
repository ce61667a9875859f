"""Whisper's log-mel frontend (the XLA spectrogram path) vs a NumPy reference
of ``whisper.log_mel_spectrogram``: reflect-padded periodic-Hann STFT power,
Slaney mel filterbank, log10, last frame dropped, (max - 8) floor, (x + 4) / 4."""

import numpy as np

from pytorch_models_tpu.models.audio.spectrogram import get_mel_filters
from pytorch_models_tpu.models.audio2text.whisper import WhisperPreprocessor
from tests.oracle import randn, rng


def _reference_log_mel(x, n_fft=400, hop=160, n_mels=80):
    x = np.asarray(x, np.float64)
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n_fft // 2, n_fft // 2)], mode="reflect")
    n_frames = (xp.shape[-1] - n_fft) // hop + 1
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    window = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)
    power = np.abs(np.fft.rfft(xp[..., idx] * window, axis=-1)) ** 2  # (..., T, F)
    mel = get_mel_filters(n_mels, n_fft, 16_000).astype(np.float64) @ np.swapaxes(power, -1, -2)
    logm = np.log10(np.clip(mel, 1e-10, None))[..., :-1]
    top = logm.reshape(*logm.shape[:-2], -1).max(axis=-1)[..., None, None]
    return (np.maximum(logm, top - 8.0) + 4.0) / 4.0


def _check(shape):
    x = randn(rng(141), *shape, scale=0.5)
    got = np.asarray(WhisperPreprocessor("base")(x))
    want = _reference_log_mel(x)
    assert got.shape == want.shape and got.shape[-2] == 80
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_logmel_parity():
    _check((16000,))


def test_logmel_batched():
    _check((2, 8000))
