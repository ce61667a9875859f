"""Whisper parity (mirrors reference tests/audio2text/test_whisper.py)."""

import numpy as np
import pytest

from pytorch_models_tpu.models.audio2text import Whisper, WhisperGenerator, WhisperPreprocessor
from tests.oracle import max_abs_diff, randn, require_reference, rng, t

TINY = dict(vocab_size=100, n_layers=2, d_model=64, n_mels=80)


def _make_openai_sd(r, vocab_size, n_layers, d_model, n_mels):
    vocab, d = vocab_size, d_model
    s = 0.02
    sd = {
        "encoder.conv1.weight": randn(r, d, n_mels, 3, scale=s),
        "encoder.conv1.bias": randn(r, d, scale=s),
        "encoder.conv2.weight": randn(r, d, d, 3, scale=s),
        "encoder.conv2.bias": randn(r, d, scale=s),
        "encoder.positional_embedding": randn(r, 1500, d, scale=s),
        "decoder.token_embedding.weight": randn(r, vocab, d, scale=1.0),
        "decoder.positional_embedding": randn(r, 448, d, scale=s),
        "encoder.ln_post.weight": 1 + randn(r, d, scale=s),
        "encoder.ln_post.bias": randn(r, d, scale=s),
        "decoder.ln.weight": 1 + randn(r, d, scale=s),
        "decoder.ln.bias": randn(r, d, scale=s),
    }

    def attn(pfx):
        sd[f"{pfx}.query.weight"] = randn(r, d, d, scale=s)
        sd[f"{pfx}.query.bias"] = randn(r, d, scale=s)
        sd[f"{pfx}.key.weight"] = randn(r, d, d, scale=s)  # no bias
        sd[f"{pfx}.value.weight"] = randn(r, d, d, scale=s)
        sd[f"{pfx}.value.bias"] = randn(r, d, scale=s)
        sd[f"{pfx}.out.weight"] = randn(r, d, d, scale=s)
        sd[f"{pfx}.out.bias"] = randn(r, d, scale=s)

    def ln(pfx):
        sd[f"{pfx}.weight"] = 1 + randn(r, d, scale=s)
        sd[f"{pfx}.bias"] = randn(r, d, scale=s)

    for side in ("encoder", "decoder"):
        for i in range(n_layers):
            pfx = f"{side}.blocks.{i}"
            attn(f"{pfx}.attn")
            ln(f"{pfx}.attn_ln")
            if side == "decoder":
                attn(f"{pfx}.cross_attn")
                ln(f"{pfx}.cross_attn_ln")
            sd[f"{pfx}.mlp.0.weight"] = randn(r, 4 * d, d, scale=s)
            sd[f"{pfx}.mlp.0.bias"] = randn(r, 4 * d, scale=s)
            sd[f"{pfx}.mlp.2.weight"] = randn(r, d, 4 * d, scale=s)
            sd[f"{pfx}.mlp.2.bias"] = randn(r, d, scale=s)
            ln(f"{pfx}.mlp_ln")
    return sd


@pytest.fixture()
def paired():
    pm = require_reference()
    r = rng(101)
    sd = _make_openai_sd(r, **TINY)
    ref = pm.audio2text.Whisper(**TINY)
    ref.load_openai_state_dict({k: t(v) for k, v in sd.items()})
    ref.eval()
    ours = Whisper(**TINY)
    ours.load_openai_state_dict(sd)
    return pm, ref, ours, r


def test_forward():
    m = Whisper(**TINY)
    r = rng()
    mel = randn(r, 2, 80, 100)
    targets = r.integers(0, 100, (2, 10))
    assert m(mel, targets).shape == (2, 10, 100)


def test_openai_parity(paired):
    import torch

    pm, ref, ours, r = paired
    mel = randn(r, 2, 80, 100)
    targets = r.integers(0, 100, (2, 10))
    with torch.no_grad():
        expected = ref(t(mel), t(targets.astype(np.int64))).numpy()
    assert max_abs_diff(expected, np.asarray(ours(mel, targets))) < 5e-5


def test_preprocessor_parity():
    pm = require_reference()
    import torch

    x = randn(rng(103), 16000)
    ref = pm.audio2text.WhisperPreprocessor()
    with torch.no_grad():
        expected = ref(t(x)).numpy()
    actual = np.asarray(WhisperPreprocessor()(x))
    assert expected.shape == actual.shape
    assert max_abs_diff(expected, actual) < 1e-5


def test_preprocessor_batched():
    x = randn(rng(104), 16000)
    pre = WhisperPreprocessor()
    single = np.asarray(pre(x))
    batched = np.asarray(pre(np.stack([x, x * 0.5])))
    assert batched.shape == (2, *single.shape)
    assert max_abs_diff(single, batched[0]) < 1e-6


def test_transcribe_matches_teacher_forced_greedy(paired):
    """KV-cached transcription == naive greedy over the full forward."""
    import torch

    pm, ref, ours, r = paired
    audio = randn(r, 16000, scale=0.1)
    eot = 7
    init = [1, 2]

    gen = WhisperGenerator(ours)
    actual = gen.transcribe_tokens(audio, init, eot_id=eot, max_tokens=12)

    # oracle: reference full re-forward greedy loop on the same padded audio
    padded = np.pad(audio, (0, 30 * 16000 - len(audio)))
    with torch.no_grad():
        mel = pm.audio2text.WhisperPreprocessor()(t(padded))[None]
        memory = ref.encoder(mel)
        tokens = list(init)
        while len(tokens) < 12:
            logits = ref.decoder(torch.tensor(tokens)[None], memory)
            tokens.append(int(logits[0, -1].argmax(-1).item()))
            if tokens[-1] == eot:
                break
    assert actual == tokens


def test_batched_transcription_matches_single(paired):
    pm, ref, ours, r = paired
    gen = WhisperGenerator(ours)
    audios = [randn(r, 16000, scale=0.1), randn(r, 24000, scale=0.1)]
    singles = [gen.transcribe_tokens(a, [1, 2], eot_id=7, max_tokens=12) for a in audios]
    batched = gen.transcribe_tokens_batch(audios, [1, 2], eot_id=7, max_tokens=12)
    assert batched == singles
