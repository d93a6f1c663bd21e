"""Evaluation utilities: mel L1 and waveform metrics between two outputs.

Counterpart of `megatts2_hierspeechpp_tpu/eval/compare.py`: the mel L1 of
two waveforms (the acceptance metric against a reference's wavs) with the
framing scaled to the rate, and SNR-style waveform differences; a CLI that
prints both for two wav files as JSON.

  python -m megatts2_hierspeechpp_torch.eval.compare a.wav b.wav [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from math import gcd
from typing import Dict

import numpy as np
import torch

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.ops.resample import downsample1d, upsample1d
from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed


def mel_l1(wav_a: np.ndarray, wav_b: np.ndarray, sr: int = 16000,
           device: str | torch.device = "cuda") -> float:
    """Mean absolute log-mel difference of the common length. The framing
    (n_fft, hop, window, fmax) scales with sr, so 24 / 48 kHz keep the 80 ms
    window and 20 ms hop of 16 kHz and a filterbank up to sr / 2."""
    scale = sr / 16000   # 24 kHz -> 1.5: still integral framing (1920 / 480)
    n_fft, hop = 1280 * scale, 320 * scale
    if n_fft != int(n_fft) or hop != int(hop):
        raise ValueError(f"unsupported rate {sr}")
    dev = resolve_device(device)
    n = min(len(wav_a), len(wav_b))
    kw = dict(sr=sr, n_fft=int(n_fft), hop=int(hop), win_length=int(n_fft),
              fmax=8000.0 * scale)
    mel_a, mel_b = (mel_spectrogram_fixed(
        torch.as_tensor(np.asarray(w[:n], np.float32), device=dev)[None], **kw)
        for w in (wav_a, wav_b))
    return float((mel_a - mel_b).abs().mean())


def waveform_metrics(wav_a: np.ndarray, wav_b: np.ndarray) -> Dict[str, float]:
    """Max / RMS difference, SNR of b against the difference (dB) and the
    correlation, in float64 over the common length."""
    n = min(len(wav_a), len(wav_b))
    a, b = wav_a[:n].astype(np.float64), wav_b[:n].astype(np.float64)
    diff = a - b
    denom = np.sum(b ** 2) + 1e-12
    return {
        "max_abs_diff": float(np.abs(diff).max()) if n else float("nan"),
        "rms_diff": float(np.sqrt(np.mean(diff ** 2))),
        "snr_db": float(10 * np.log10(denom / (np.sum(diff ** 2) + 1e-12))),
        "corr": float(np.dot(a, b)
                      / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)),
    }


def to_rate(wav: np.ndarray, sr: int, target: int,
            device: str | torch.device = "cuda") -> np.ndarray:
    """wav at `sr` resampled to `target` (> sr) with the kaiser-sinc
    anti-aliased up / down samplers (up by target / g, down by sr / g)."""
    g = gcd(target, sr)
    up_f, down_f = target // g, sr // g
    x = torch.as_tensor(np.asarray(wav, np.float32),
                        device=resolve_device(device))[None, :, None]
    if up_f > 1:
        x = upsample1d(x, ratio=up_f)
    if down_f > 1:
        x = downsample1d(x, ratio=down_f)
    return x[0, :, 0].cpu().numpy()


def compare_files(path_a: str, path_b: str,
                  device: str | torch.device = "cuda") -> Dict[str, float]:
    """The JSON the CLI prints: mel_l1 and waveform_metrics of two wav
    files; the lower rate's file is first resampled to the higher rate."""
    from scipy.io import wavfile

    def load(path):
        sr, data = wavfile.read(path)
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        return sr, data

    (sr_a, a), (sr_b, b) = load(path_a), load(path_b)
    if sr_a < sr_b:
        a, sr_a = to_rate(a, sr_a, sr_b, device), sr_b
    elif sr_b < sr_a:
        b = to_rate(b, sr_b, sr_a, device)
    out = {"mel_l1": mel_l1(a, b, sr=sr_a, device=device)}
    out.update(waveform_metrics(a, b))
    return out


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description="Compare two wavs (mel L1 + SNR)")
    p.add_argument("wav_a")
    p.add_argument("wav_b")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = compare_files(args.wav_a, args.wav_b, args.device)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
