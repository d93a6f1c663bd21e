"""Serving pipeline, decode half: prompt mel -> vocoder -> SpeechSR.

Counterpart of the `mel`, `vocode` and `sr` stages of
`megatts2_hierspeechpp_tpu/infer/pipeline.py:TTSPipeline.tts` and its peak
normalisation. The acoustic stage (text -> w2v features and log-f0) is not
ported yet, so `synthesize` takes those features as inputs. No length
bucketing: the port runs eagerly at the request's own length.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed


@dataclass
class PromptFeatures:
    """Per-prompt features, computed once and reused across requests."""

    mel_pair: torch.Tensor  # (2, T, 80) mel of [orig; denoised]


@dataclass
class TTSPipeline:
    vocoder: HierVocoder
    speechsr: Optional[SpeechSR] = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def _check_output_sr(self, output_sr: int) -> float:
        """Validate output_sr against the attached SpeechSR and return the
        sample-count ratio to 16 kHz."""
        if output_sr == 16000:
            return 1.0
        if self.speechsr is None:
            raise ValueError(f"output_sr={output_sr} needs a SpeechSR model")
        num, den = self.speechsr.rate_num, self.speechsr.rate_den
        model_sr = 16000 * num // den
        if output_sr != model_sr:
            raise ValueError(
                f"output_sr={output_sr} does not match the loaded SpeechSR "
                f"model (x{num}/{den} -> {model_sr} Hz); load the matching "
                "checkpoint or request output_sr=16000")
        return num / den

    @torch.inference_mode()
    def prepare_prompt(self, prompt_audio: np.ndarray) -> PromptFeatures:
        """prompt_audio: (T,) float at 16 kHz. No denoiser is ported, so the
        [orig; denoised] style pair is the mel of [orig; orig]."""
        pair = np.stack([prompt_audio, prompt_audio]).astype(np.float32)
        mel_pair = mel_spectrogram_fixed(torch.from_numpy(pair).to(self.device))
        return PromptFeatures(mel_pair=mel_pair)

    @torch.inference_mode()
    def render(self, prompt: PromptFeatures, w2v, frame_mask, lf0,
               noise_scale: float = 0.333, seed: int = 1234,
               denoise_ratio: float = 0.0, output_sr: int = 16000):
        """The waveform before peak normalisation, (N,) on the device.

        w2v: (1, T, 1024); frame_mask: (1, T, 1); lf0: (1, 4T) log-f0. The
        posterior noise comes from torch.Generator().manual_seed(seed + 1)."""
        ratio = self._check_output_sr(output_sr)
        t_frames = w2v.shape[1]
        dev = self.device
        trg_mask = torch.ones(*prompt.mel_pair.shape[:2], 1, device=dev)
        wav = self.vocoder.voice_conversion(
            w2v.to(dev), frame_mask.to(dev), prompt.mel_pair, trg_mask,
            lf0.to(dev)[..., None], noise_scale,
            torch.Generator().manual_seed(seed + 1), denoise_ratio)
        if ratio != 1.0:
            wav = self.speechsr(wav)
        return wav[0, :int(320 * t_frames * ratio), 0]

    def synthesize(self, prompt: PromptFeatures, w2v, frame_mask, lf0,
                   noise_scale: float = 0.333, seed: int = 1234,
                   denoise_ratio: float = 0.0,
                   output_sr: int = 16000) -> np.ndarray:
        """Vocode + super-resolve + peak-normalise to 0.999 -> float32 numpy
        waveform at output_sr."""
        wav = self.render(prompt, w2v, frame_mask, lf0, noise_scale, seed,
                          denoise_ratio, output_sr).cpu().numpy()
        peak = np.abs(wav).max()
        return (wav / max(peak, 1e-8) * 0.999).astype(np.float32)
