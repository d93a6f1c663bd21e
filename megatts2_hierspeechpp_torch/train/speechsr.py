"""SpeechSR GAN trainer on (16 kHz in, 24 / 48 kHz out) waveform pairs.

Counterpart of `megatts2_hierspeechpp_tpu/train/speechsr.py` (reference
speechsr48k / speechsr24k configs: segment 9600 at 48 kHz, c_mel 45, AdamW
lr 1e-4, decay 0.995, and their in-file multi-period discriminator bank):
LSGAN + feature matching + c_mel x the mel L1 at the target rate.

One step: the D step on the detached fake, then the G step through the
updated D (as JAX, which applies D's update before G's loss). One generator
forward serves both; JAX recomputes it with the same parameters. The step
draws no random numbers (JAX's `rng` is unused too). At C <= 64 the
generator's hi-rate stage is the fused_amp_triple kernel, forward and
backward (cuda_lib.plain_vjp).

Training computes in float32, the port's kernels' type.

Data parallel (parallel/mesh.py): every loss is a mean over equal-shaped
rank tensors, so inside `mesh.global_batch()` both gradients and the
losses are averaged over the ranks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator,
)
from megatts2_hierspeechpp_torch.models.speechsr import SpeechSR
from megatts2_hierspeechpp_torch.ops.stft import linear_spectrogram, spec_to_mel
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train import losses as L
from megatts2_hierspeechpp_torch.train.optim import AdamW


@dataclass
class SRTrainState:
    """Generator, discriminator, their optimizers and the step count. The
    step updates it in place."""

    gen: SpeechSR
    disc: MultiPeriodDiscriminator
    opt_g: AdamW
    opt_d: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "gen": self.gen.state_dict(),
                "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.gen.load_state_dict(state["gen"])
        self.disc.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])


def create_state(gen: SpeechSR, disc: MultiPeriodDiscriminator,
                 **adamw_kwargs) -> SRTrainState:
    """A step-0 state over a training build of SpeechSR and a
    discriminator, one AdamW(**adamw_kwargs) each."""
    return SRTrainState(gen, disc, AdamW(gen.parameters(), **adamw_kwargs),
                        AdamW(disc.parameters(), **adamw_kwargs))


class TrainStep:
    """The SpeechSR train step (the JAX make_train_step);
    `step(state, batch, generator)` -> (state, metrics). batch (tensors on
    the model's device): lo (B, T, 1) at 16 kHz, hi (B, T * rate, 1) at
    sr_out. `generator` is unused. Metrics are detached 0-d tensors, named
    as the JAX step's."""

    def __init__(self, c_mel: float = 45.0, sr_out: int = 48000,
                 n_fft: int = 1280, hop: int = 320, n_mels: int = 128):
        self.c_mel, self.sr_out = c_mel, sr_out
        self.n_fft, self.hop, self.n_mels = n_fft, hop, n_mels

    def mel(self, wav):
        """(B, T, 1) -> (B, F, n_mels) slaney log-mel at sr_out."""
        spec = linear_spectrogram(wav[..., 0], self.n_fft, self.hop, self.n_fft)
        return spec_to_mel(spec, self.sr_out, self.n_fft, self.n_mels, 0.0, None)

    def __call__(self, state: SRTrainState, batch: Dict,
                 generator: torch.Generator | None = None):
        with mesh.global_batch():
            return self._step(state, batch)

    def _step(self, state: SRTrainState, batch: Dict):
        gen, disc = state.gen, state.disc
        lo, hi = batch["lo"], batch["hi"]
        fake = gen(lo)

        # D step on the detached fake
        dr, dg, _, _ = disc(hi, fake.detach())
        loss_d = L.discriminator_loss(dr, dg)[0]
        state.opt_d.zero_grad()
        loss_d.backward()
        mesh.reduce_grads(state.opt_d.params)
        state.opt_d.step()

        # G step through the updated D, whose parameters take no gradient
        disc.requires_grad_(False)
        try:
            dr, dg, fr, fg = disc(hi, fake)
        finally:
            disc.requires_grad_(True)
        loss_mel = (self.mel(fake) - self.mel(hi)).abs().mean() * self.c_mel
        loss_fm = L.feature_loss(fr, fg)
        loss_gen = L.generator_loss(dg)[0]
        total = loss_mel + loss_fm + loss_gen
        state.opt_g.zero_grad()
        total.backward()
        mesh.reduce_grads(state.opt_g.params)
        state.opt_g.step()
        state.step += 1
        metrics = mesh.reduce_metrics({
            "loss/g/total": total, "loss/g/mel": loss_mel,
            "loss/g/fm": loss_fm, "loss/g/gen": loss_gen,
            "loss/d/total": loss_d})
        return state, {k: v.detach() for k, v in metrics.items()}
