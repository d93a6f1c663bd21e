"""MP-SENet denoiser trainer.

Counterpart of `megatts2_hierspeechpp_tpu/train/denoiser.py` (the MP-SENet
loss surface of reference denoiser/generator.py:150-170): on compressed
STFTs, the magnitude MSE, the anti-wrapping instantaneous-phase,
group-delay and instantaneous-frequency losses, the complex MSE, and the
time-domain L1 of the resynthesised waveform:
0.9 mag + 0.3 pha + 0.1 com + 0.2 time.

The model is a training build of MPNet (models/denoiser.py): B > 1, its
BatchNorm in train() mode moving its running statistics once per step.
The step draws no random numbers. `TrainStep.with_spectra` runs a step on
spectra given from outside: the first STFT frame's phases are +-pi by the
FFT's rounding (ROADMAP.md section 3), so parity checks feed both sides
one STFT.

Training computes in float32.

Data parallel (parallel/mesh.py): MPNet's training forward is not
row-separable (its attention runs over batch x freq and batch x frames,
its BatchNorm over the batch), so inside `mesh.global_batch()` each
attention gathers every rank's keys and values and BatchNorm takes the
global batch's statistics (models/denoiser.py); the losses are means over
equal-shaped rank tensors, so the gradients and the losses are averaged
over the ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from megatts2_hierspeechpp_torch.models.denoiser import MPNet
from megatts2_hierspeechpp_torch.ops import stft as tstft
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train.optim import AdamW


@dataclass
class DenoiserTrainState:
    """The model (its BatchNorm buffers in its state_dict), the optimizer
    and the step count. The step updates it in place."""

    model: MPNet
    opt: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "model": self.model.state_dict(),
                "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["opt"])


def create_state(model: MPNet, **adamw_kwargs) -> DenoiserTrainState:
    """A step-0 state over a training build of MPNet and its
    AdamW(**adamw_kwargs)."""
    return DenoiserTrainState(model, AdamW(model.parameters(), **adamw_kwargs))


def anti_wrapping(x):
    """|x - 2 pi round(x / 2 pi)|: the distance of a phase difference from
    the nearest multiple of 2 pi."""
    return (x - torch.round(x / (2 * math.pi)) * 2 * math.pi).abs()


def phase_losses(pha_r, pha_g):
    """(ip, gd, iaf) anti-wrapping losses on (B, frames, bins) phases: the
    phase difference itself, its difference along the bins (group delay)
    and along the frames (instantaneous frequency)."""
    ip = anti_wrapping(pha_r - pha_g).mean()
    gd = anti_wrapping(torch.diff(pha_r, dim=2) - torch.diff(pha_g, dim=2)).mean()
    iaf = anti_wrapping(torch.diff(pha_r, dim=1) - torch.diff(pha_g, dim=1)).mean()
    return ip, gd, iaf


class TrainStep:
    """The denoiser train step (the JAX make_train_step);
    `step(state, batch, generator)` -> (state, metrics). batch (tensors on
    the model's device): noisy, clean (B, T) waveforms. `generator` is
    unused. Metrics are detached 0-d tensors, named as the JAX step's."""

    def __init__(self, n_fft: int = 400, hop: int = 100, win: int = 400,
                 compress: float = 0.3):
        self.n_fft, self.hop, self.win, self.compress = n_fft, hop, win, compress

    def spectra(self, wav):
        """(B, T) -> compressed magnitude and phase, each (B, frames, bins)."""
        return tstft.mag_pha_stft(wav, self.n_fft, self.hop, self.win,
                                  self.compress)

    def __call__(self, state: DenoiserTrainState, batch: Dict,
                 generator: torch.Generator | None = None):
        return self.with_spectra(state, *self.spectra(batch["noisy"]),
                                 *self.spectra(batch["clean"]), batch["clean"])

    def with_spectra(self, state: DenoiserTrainState, mag_n, pha_n, mag_c,
                     pha_c, clean):
        """One update from the noisy and clean spectra (B, frames, bins)
        and the clean waveform (B, T)."""
        with mesh.global_batch():
            return self._step(state, mag_n, pha_n, mag_c, pha_c, clean)

    def _step(self, state: DenoiserTrainState, mag_n, pha_n, mag_c, pha_c,
              clean):
        mag_g, pha_g = state.model(mag_n, pha_n)
        l_mag = (mag_g - mag_c).square().mean()
        ip, gd, iaf = phase_losses(pha_c, pha_g)
        l_pha = ip + gd + iaf
        l_com = ((mag_g * torch.cos(pha_g) - mag_c * torch.cos(pha_c)).square().mean()
                 + (mag_g * torch.sin(pha_g) - mag_c * torch.sin(pha_c)).square().mean()) / 2
        mag_lin = mag_g ** (1.0 / self.compress)
        spec = torch.complex(mag_lin * torch.cos(pha_g), mag_lin * torch.sin(pha_g))
        wav_g = tstft.istft(spec, self.n_fft, self.hop, self.win, clean.shape[-1])
        l_time = (wav_g - clean).abs().mean()
        total = 0.9 * l_mag + 0.3 * l_pha + 0.1 * l_com + 0.2 * l_time
        state.opt.zero_grad()
        total.backward()
        mesh.reduce_grads(state.opt.params)
        state.opt.step()
        state.step += 1
        metrics = mesh.reduce_metrics({
            "loss/total": total, "loss/mag": l_mag, "loss/pha": l_pha,
            "loss/com": l_com, "loss/time": l_time})
        return state, {k: v.detach() for k, v in metrics.items()}
