"""Zero-shot TTS serving pipeline.

Counterpart of `megatts2_hierspeechpp_tpu/infer/pipeline.py:TTSPipeline`:

  text -> frontend -> [duration pre-pass] -> [acoustic: TTV latent -> PLM
  greedy decode -> w2v / log-f0 -> pitch clip] -> [vocoder] -> [SpeechSR]
  -> peak normalisation

No length bucketing: the port runs eagerly at the request's own length, so
`tts` is the counterpart of the JAX `tts(..., exact=True)` (acoustic budget
2 * predicted frames). `synthesize` / `render` run the decode half alone on
caller-supplied w2v features and log-f0. The denoiser is not ported:
`denoise_ratio > 0` in `tts` raises, and the vocoder's [orig; denoised]
style pair is the mel of [orig; orig].
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from megatts2_hierspeechpp_torch.data import text as text_frontend
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.models import plm as plm_lib
from megatts2_hierspeechpp_torch.models.plm import ProsodyLM
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed

LF0_FLOOR = math.log(55.0)  # predicted log-f0 below this is unvoiced: 0


@dataclass
class PromptFeatures:
    """Per-prompt features, computed once and reused across requests."""

    mel_ttv: torch.Tensor   # (1, T_pad, 80) mel of the 1600-padded prompt
    mel_pair: torch.Tensor  # (2, T, 80) mel of [orig; denoised], true length
    t_samples: int


@dataclass
class Acoustic:
    """Output of the acoustic stage for one request of `frames` 50 Hz
    frames."""

    w2v: torch.Tensor         # (1, T, 1024)
    lf0: torch.Tensor         # (1, 4T) log(f0 + 1), clipped at log(55)
    frame_mask: torch.Tensor  # (1, T, 1)
    x_frame: torch.Tensor     # (1, T, 256) TTV latent
    codes: torch.Tensor       # (1, T) int32 prosody codes

    @property
    def frames(self) -> int:
        return self.w2v.shape[1]


@dataclass
class TTSPipeline:
    vocoder: HierVocoder
    speechsr: Optional[SpeechSR] = None
    device: str | torch.device = "cuda"
    ttv: Optional[TTVModel] = None
    plm: Optional[ProsodyLM] = None

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
        """prompt_audio: (T,) float at 16 kHz. mel_ttv is the mel of the
        prompt zero-padded to (T // 1600 + 1) * 1600 samples (always at least
        one sample, as the reference pads); mel_pair is at the true length.
        No denoiser is ported, so the [orig; denoised] style pair is the mel
        of [orig; orig]."""
        audio = np.asarray(prompt_audio, np.float32)
        t_a = len(audio)
        padded = np.pad(audio, (0, (t_a // 1600 + 1) * 1600 - t_a))
        mel_ttv = mel_spectrogram_fixed(
            torch.from_numpy(padded[None]).to(self.device))
        pair = np.stack([audio, audio])
        mel_pair = mel_spectrogram_fixed(torch.from_numpy(pair).to(self.device))
        return PromptFeatures(mel_ttv=mel_ttv, mel_pair=mel_pair, t_samples=t_a)

    # ---------- acoustic half ----------

    def _text(self, text: str):
        ids, tones, langs = text_frontend.process_text(text)
        as_t = lambda v: torch.tensor([v], dtype=torch.long, device=self.device)  # noqa: E731
        return (as_t(ids), as_t(tones), as_t(langs),
                torch.tensor([len(ids)], device=self.device))

    def _prompt_len(self, prompt: PromptFeatures):
        return torch.tensor([prompt.mel_ttv.shape[1]], device=self.device)

    @torch.inference_mode()
    def duration(self, text: str, prompt: PromptFeatures,
                 length_scale: float = 1.0) -> int:
        """Duration pre-pass: the request's predicted 50 Hz frame count."""
        x_ids, tone, lang, x_len = self._text(text)
        frames = self.ttv.predict_frame_lengths(
            x_ids, tone, lang, x_len, prompt.mel_ttv, self._prompt_len(prompt),
            length_scale)
        return int(frames[0])

    @torch.inference_mode()
    def acoustic(self, text: str, prompt: PromptFeatures, frames: int,
                 length_scale: float = 1.0, mode: str = "plm", top_k: int = 0,
                 seed: int = 1234,
                 codes: Optional[np.ndarray] = None) -> Acoustic:
        """TTV latent -> prosody codes -> w2v / log-f0 -> pitch clip, at a
        100 Hz budget of 2 * frames.

        mode "plm": greedy (top_k 0) or top-k PLM decode, the top-k draws
        from a generator on the pipeline's device seeded with `seed`;
        "prompt": the prompt's own RVQ codes tiled to the length; "given":
        `codes`, zero-padded or cut to the length."""
        x_ids, tone, lang, x_len = self._text(text)
        mel_len = self._prompt_len(prompt)
        x_frame, g, _, frame_mask = self.ttv.inf_extract_tc_latent(
            x_ids, tone, lang, x_len, prompt.mel_ttv, mel_len, 2 * frames,
            length_scale=length_scale)
        t_need = x_frame.shape[1]
        if mode == "plm":
            pcodes = plm_lib.decode(
                self.plm, x_frame, top_k=top_k,
                generator=torch.Generator(self.device).manual_seed(seed))
        elif mode == "given":
            given = torch.as_tensor(np.asarray(codes), dtype=torch.int32)
            given = given.reshape(1, -1)[:, :t_need].to(self.device)
            pcodes = torch.zeros(1, t_need, dtype=torch.int32, device=self.device)
            pcodes[:, :given.shape[1]] = given
        elif mode == "prompt":
            pc = self.ttv.prompt_codes(prompt.mel_ttv, mel_len)
            reps = -(-t_need // pc.shape[1])
            pcodes = pc.repeat(1, reps)[:, :t_need]
        else:
            raise ValueError(f"unknown acoustic mode {mode!r}")
        w2v, lf0 = self.ttv.inf_plm_gen(x_frame, g, pcodes[None], frame_mask)
        # pitch clip (inference_plm.py:169): the vocoder takes log(f0 + 1)
        # as it comes, with unvoiced frames at 0
        lf0 = torch.where(lf0 < LF0_FLOOR, torch.zeros_like(lf0), lf0)
        return Acoustic(w2v, lf0, frame_mask, x_frame, pcodes)

    def tts(self, text: str, prompt_audio: Optional[np.ndarray] = None,
            denoise_ratio: float = 0.0, noise_scale_vc: float = 0.333,
            length_scale: float = 1.0, output_sr: int = 16000,
            seed: int = 1234, top_k: int = 0, use_plm: bool = True,
            prompt: Optional[PromptFeatures] = None,
            codes: Optional[np.ndarray] = None,
            return_intermediates: bool = False):
        """Text + prompt -> float32 numpy waveform at output_sr, peak 0.999.

        With return_intermediates, also returns the Acoustic outputs and the
        waveform before normalisation (on the device)."""
        if denoise_ratio > 0:
            raise NotImplementedError("the denoiser is not ported")
        if self.ttv is None or (use_plm and codes is None and self.plm is None):
            raise ValueError("tts needs the ttv (and plm) models")
        self._check_output_sr(output_sr)  # fail before any compute
        if prompt is None:
            if prompt_audio is None:
                raise ValueError("need prompt_audio or prompt features")
            prompt = self.prepare_prompt(prompt_audio)
        mode = "given" if codes is not None else ("plm" if use_plm else "prompt")
        frames = self.duration(text, prompt, length_scale)
        ac = self.acoustic(text, prompt, frames, length_scale, mode, top_k,
                           seed, codes)
        raw = self.render(prompt, ac.w2v, ac.frame_mask, ac.lf0,
                          noise_scale_vc, seed, denoise_ratio, output_sr)
        out = _peak_normalise(raw.cpu().numpy())
        if return_intermediates:
            return out, ac, raw
        return out

    # ---------- decode half on given features ----------

    @torch.inference_mode()
    def render(self, prompt: PromptFeatures, w2v, frame_mask, lf0,
               noise_scale: float = 0.333, seed: int = 1234,
               denoise_ratio: float = 0.0, output_sr: int = 16000):
        """The waveform before peak normalisation, (N,) on the device.

        w2v: (1, T, 1024); frame_mask: (1, T, 1); lf0: (1, 4T) log(f0 + 1).
        The posterior noise comes from torch.Generator().manual_seed(seed +
        1)."""
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
        return _peak_normalise(self.render(
            prompt, w2v, frame_mask, lf0, noise_scale, seed, denoise_ratio,
            output_sr).cpu().numpy())


def _peak_normalise(wav: np.ndarray) -> np.ndarray:
    peak = np.abs(wav).max()
    return (wav / max(peak, 1e-8) * 0.999).astype(np.float32)

