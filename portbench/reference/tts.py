"""One served row, worked out again by the reference.

`Reference.row` takes what the benchmark handed the program (the text,
the voice's prompt audio, the length scale, the request seed) with the
padded shapes of the call that served the row (its text bucket, frame
bucket, batch size and the row's place in it), and the program's integer
durations and prosody codes, which it judges rather than trusts: it
returns the durations before their ceiling, the teacher-forced logits of
the codes, and the waveform at the requested sample rate (16 kHz from the
vocoder, or SpeechSR's rate) that those durations and codes give, cut to
the row's frames and peak-normalised as served.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference import frontend
from portbench.reference.layers import feature_mask
from portbench.reference.models import PLM, TTV, SpeechSR, Vocoder, mel_frames

NOISE_SCALE = 0.333   # the served default (noise_scale_vc)


def text_bucket(n: int) -> int:
    for s in (16, 32, 64, 96, 128, 192, 256, 384, 512):
        if n <= s:
            return s
    return (n + 63) // 64 * 64


def frame_bucket(n: int) -> int:
    for s in (200, 400, 600, 800, 1200, 1600, 2000):
        if n <= s:
            return s
    return (n + 399) // 400 * 400


@dataclass
class RowOut:
    v: torch.Tensor        # (n,) durations at the length scale, before ceil
    logits: torch.Tensor   # (frames, bins) teacher-forced on the given codes
    wav: np.ndarray        # peak-normalised waveform, 320 x ratio x frames samples
    frames: int


class Reference:
    """The four plain models of a configuration, loaded with one set of
    state_dicts, float32, on `device`."""

    def __init__(self, cfg: dict, states: dict, device):
        self.device = torch.device(device)
        self.models = {}
        for name, cls in (("ttv", TTV), ("plm", PLM), ("vocoder", Vocoder),
                          ("speechsr", SpeechSR)):
            m = cls(cfg[name])
            m.load_state_dict(states[name], strict=True)
            self.models[name] = m.to(self.device).eval().requires_grad_(False)
        self.sr_rate = (cfg["speechsr"]["rate_num"], cfg["speechsr"]["rate_den"])
        self.inter = cfg["vocoder"]["inter_channels"]
        self._prompts = {}

    def ratio_for(self, output_sr: int) -> float:
        """Output samples per 16 kHz sample: 1 at 16 kHz, else SpeechSR's
        ratio, whose rate output_sr has to be."""
        if output_sr == 16000:
            return 1.0
        num, den = self.sr_rate
        if output_sr != 16000 * num // den:
            raise ValueError(f"output_sr {output_sr} is neither 16000 nor SpeechSR's")
        return num / den

    def prompt(self, audio: np.ndarray):
        """(mel of the prompt padded on the 1 s grid, mel at its true
        length), cached by the audio's identity."""
        key = id(audio)
        if key not in self._prompts:
            a = torch.from_numpy(np.asarray(audio, np.float32)).to(self.device)
            t = a.shape[0]
            padded = torch.nn.functional.pad(a, (0, (t // 16000 + 1) * 16000 - t))
            self._prompts[key] = (mel_frames(padded), mel_frames(a), audio)
        return self._prompts[key][:2]

    @staticmethod
    def _ctx(lower, name):
        return lower[name]() if lower else contextlib.nullcontext()

    def encode(self, text: str, audio, n_pad: int, lower=None):
        ids, tone, lang = frontend.process_text(text)
        n = len(ids)
        if n > n_pad:
            raise ValueError(f"{n} phones in a bucket of {n_pad}")
        arr = np.zeros((3, 1, n_pad), np.int64)
        arr[:, 0, :n] = (ids, tone, lang)
        ids, tone, lang = torch.from_numpy(arr).to(self.device)
        mel_ttv, _ = self.prompt(audio)
        with self._ctx(lower, "ttv"):
            x, g, _, v = self.models["ttv"].encode(ids, tone, lang, n, mel_ttv)
        return n, x, g, v

    @torch.inference_mode()
    def durations(self, text: str, audio, n_pad: int, length_scale: float,
                  lower=None):
        """(n, the (n,) durations at length_scale before their ceiling)."""
        n, _, _, v = self.encode(text, audio, n_pad, lower)
        return n, (v * length_scale)[0, :n]

    @torch.inference_mode()
    def row(self, text: str, audio, length_scale: float, seed: int, n_pad: int,
            t_bucket: int, batch: int, index: int, dur: np.ndarray,
            codes: np.ndarray, output_sr: int = 48000, lower=None) -> RowOut:
        """dur: (n_pad,) integer 100 Hz durations; codes: (t_bucket,);
        output_sr: 16000 (the vocoder's own) or SpeechSR's rate;
        lower: None, or per model a context that lowers its precision
        (precision.control)."""
        ratio = self.ratio_for(output_sr)
        ttv, plm = self.models["ttv"], self.models["plm"]
        n, x, g, v = self.encode(text, audio, n_pad, lower)
        d = torch.from_numpy(np.asarray(dur, np.float32)).to(self.device)[None]
        frames = min(int(math.ceil(float(d[0].sum()) / 2)), t_bucket)
        mask = feature_mask(torch.tensor([frames], device=self.device), t_bucket)
        c = torch.from_numpy(np.asarray(codes, np.int64)).to(self.device)[None]
        with self._ctx(lower, "ttv"):
            x_frame = ttv.latent(x, d, n, 2 * t_bucket)
        with self._ctx(lower, "plm"):
            logits = plm.logits(x_frame, c)[0, :frames]
        with self._ctx(lower, "ttv"):
            w2v, lf0 = ttv.w2v_lf0(x_frame, g, c, mask)
        _, mel_true = self.prompt(audio)
        gen = torch.Generator().manual_seed(int(seed) + 1)
        noise = torch.randn((batch, t_bucket, self.inter), generator=gen)
        noise = noise[index:index + 1].to(self.device)
        with self._ctx(lower, "vocoder"):
            style = self.models["vocoder"].style(mel_true)
            wav = self.models["vocoder"](w2v, mask, lf0[..., None], style, noise,
                                         NOISE_SCALE)
        if ratio != 1.0:
            with self._ctx(lower, "speechsr"):
                wav = self.models["speechsr"](wav)
        raw = wav[0, :int(320 * frames * ratio), 0].double().cpu().numpy()
        out = raw / max(np.abs(raw).max(), 1e-8) * 0.999
        return RowOut((v * length_scale)[0, :n], logits, out.astype(np.float32),
                      frames)
