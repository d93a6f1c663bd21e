"""HierSpeech++ vocoder GAN + VAE trainer.

Counterpart of `megatts2_hierspeechpp_tpu/train/vocoder.py` (the reference
ships no vocoder trainer; the objective is the HierSpeech++ / VITS one):

  - z_q ~ enc_q(linear spec, raw wave); the source network and the
    Generator decode a random `segment_frames` window of it (reference
    commons.rand_slice_segments) into wav_hat;
  - mel L1 between the slaney mels of wav_hat and the real window, x c_mel;
  - KL of flow(z_q) against enc_p's prior and of flow_l(flow(z_q)) against
    enc_p_l's, x c_kl;
  - MPD least-squares adversarial loss and feature matching on the windows;
  - the prosody head's L1 to the first 20 mel bins;
  - the source network's e_ regressed to log(1 + f0) on the window, x c_f0.
The encoders read f0 as log(1 + Hz), as serving feeds them.

One step: the D step on the detached window, then the G step through the
updated D (as JAX, which applies D's update before G's loss). One generator
forward serves both; JAX recomputes it with the same parameters and draws.
The step's random draws (window starts, z_q's normal) come from an explicit
torch.Generator on the CPU (`TrainStep.draw`), so a given seed draws the
same numbers on every device, and `TrainStep.with_draws` runs a step on
draws given from outside (the tests feed it the JAX step's).

The models' compute dtype is theirs (HierVocoder(dtype=),
MultiPeriodDiscriminator(dtype=)): with bf16, as the JAX CLI's default, the
convs and the vocoder kernels run in bf16 while the parameters, their
gradients and the AdamW state stay float32, and every loss reads its
inputs in float32 (train/losses.py; the mel L1's spectra are float32, the
excitation L1 casts e_).

Data parallel (parallel/mesh.py): the draws are the global batch's, of
which a rank keeps its rows; the step runs inside `mesh.global_batch()`,
where the KL's mask sums are global, both gradients are averaged over the
ranks before the updates and the losses into the metrics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiPeriodDiscriminator,
)
from megatts2_hierspeechpp_torch.models.vocoder import HierVocoder
from megatts2_hierspeechpp_torch.ops.stft import linear_spectrogram, spec_to_mel
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train import losses as L
from megatts2_hierspeechpp_torch.train.optim import AdamW

HOP, SR, N_FFT, N_MELS = 320, 16000, 1280, 80   # 50 Hz frames of 16 kHz audio


@dataclass
class VocTrainState:
    """Generator, discriminator, their optimizers and the step count. The
    step updates it in place."""

    gen: HierVocoder
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


def create_state(gen: HierVocoder, disc: MultiPeriodDiscriminator,
                 **adamw_kwargs) -> VocTrainState:
    """A step-0 state over a training build of the vocoder and a
    discriminator, one AdamW(**adamw_kwargs) each."""
    return VocTrainState(gen, disc, AdamW(gen.parameters(), **adamw_kwargs),
                         AdamW(disc.parameters(), **adamw_kwargs))


def rand_slice_indices(u, lengths, segment: int):
    """Window starts floor(u * (max(length - segment, 0) + 1)) for uniform
    u in [0, 1) (reference commons.rand_slice_segments)."""
    max_start = torch.clamp(lengths - segment, min=0)
    return (u * (max_start + 1).float()).long()


def slice_frames(x, starts, segment: int):
    """x: (B, T, C); starts: (B,) -> (B, segment, C), each start clamped to
    [0, T - segment] (jax.lax.dynamic_slice)."""
    starts = torch.clamp(starts, 0, x.shape[1] - segment)
    idx = starts[:, None] + torch.arange(segment, device=x.device)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


class TrainStep:
    """The vocoder's train step (the JAX make_train_step);
    `step(state, batch, generator)` -> (state, metrics). batch (tensors on
    the model's device): spec (B, T, 641), audio (B, 320T), mel (B, T, 80),
    w2v (B, T, 1024), f0 (B, 4T) in Hz, mask (B, T, 1), lengths (B,)
    frames. Metrics are detached 0-d tensors, named as the JAX step's."""

    def __init__(self, segment_frames: int = 32, c_mel: float = 45.0,
                 c_kl: float = 1.0, c_f0: float = 1.0):
        self.segment = segment_frames
        self.c_mel, self.c_kl, self.c_f0 = c_mel, c_kl, c_f0

    def __call__(self, state: VocTrainState, batch: Dict,
                 generator: torch.Generator):
        return self.with_draws(state, batch, *self.draw(state, batch, generator))

    def draw(self, state: VocTrainState, batch: Dict,
             generator: torch.Generator):
        """The step's random numbers, drawn on the CPU from `generator` and
        moved to the batch's device: uniform window positions (B,) and
        z_q's N(0, 1) noise (B, T, C). Returns (starts, noise_q)."""
        b, t = batch["mask"].shape[:2]
        c = state.gen.enc_q.out_channels
        dev = batch["mask"].device
        with mesh.global_batch():   # this rank's rows of the global draws
            w = mesh.shard()[1]
            u = mesh.local_rows(torch.rand(b * w, generator=generator)).to(dev)
            noise_q = mesh.local_rows(
                torch.randn((b * w, t, c), generator=generator)).to(dev)
        return rand_slice_indices(u, batch["lengths"], self.segment), noise_q

    def mel(self, wav):
        """(B, T, 1) -> (B, F, n_mels) slaney log-mel of the linear
        spectrogram."""
        spec = linear_spectrogram(wav[..., 0], N_FFT, HOP, N_FFT)
        return spec_to_mel(spec, SR, N_FFT, N_MELS, 0.0, None)

    def with_draws(self, state: VocTrainState, batch: Dict, starts, noise_q):
        """One D update and one G update on the given window starts (B,)
        and z_q noise (B, T, C)."""
        with mesh.global_batch():
            return self._step(state, batch, starts, noise_q)

    def _step(self, state: VocTrainState, batch: Dict, starts, noise_q):
        gen, disc, seg = state.gen, state.disc, self.segment
        mask = batch["mask"]
        out = gen.train_encode(
            batch["spec"], batch["audio"][..., None], batch["mel"],
            batch["w2v"], torch.log1p(batch["f0"])[..., None], mask, noise_q)
        wav_hat, e_sl = gen.decode_slice(slice_frames(out["z_q"], starts, seg),
                                         out["g"])
        wav_gt = slice_frames(batch["audio"][..., None], starts * HOP, seg * HOP)

        # D step on the detached window
        dr, dg, _, _ = disc(wav_gt, wav_hat.detach())
        loss_d = L.discriminator_loss(dr, dg)[0]
        state.opt_d.zero_grad()
        loss_d.backward()
        mesh.reduce_grads(state.opt_d.params)
        state.opt_d.step()

        # G step through the updated D, whose parameters take no gradient
        disc.requires_grad_(False)
        try:
            dr, dg, fr, fg = disc(wav_gt, wav_hat)
        finally:
            disc.requires_grad_(True)
        f0_gt = slice_frames(batch["f0"][..., None], starts * 4, seg * 4)
        loss_mel = (self.mel(wav_hat) - self.mel(wav_gt)).abs().mean()
        loss_f0 = (e_sl.float() - torch.log1p(f0_gt.float())).abs().mean()
        kl1 = L.kl_loss(out["z_f"], out["logs_q"], out["m_p"], out["logs_p"],
                        mask)
        kl2 = L.kl_loss(out["z_fl"], out["logs_q"], out["m_l"], out["logs_l"],
                        mask)
        loss_prosody = (out["mel_rec"] - batch["mel"][..., :20]).abs().mean()
        loss_fm = L.feature_loss(fr, fg)
        loss_gen = L.generator_loss(dg)[0]
        total = (loss_mel * self.c_mel + (kl1 + kl2) * self.c_kl + loss_fm
                 + loss_gen + loss_prosody + loss_f0 * self.c_f0)
        state.opt_g.zero_grad()
        total.backward()
        mesh.reduce_grads(state.opt_g.params)
        state.opt_g.step()
        state.step += 1
        metrics = mesh.reduce_metrics({
            "loss/g/total": total, "loss/g/mel": loss_mel, "loss/g/kl1": kl1,
            "loss/g/kl2": kl2, "loss/g/fm": loss_fm, "loss/g/gen": loss_gen,
            "loss/g/prosody": loss_prosody, "loss/g/f0": loss_f0,
            "loss/d/total": loss_d})
        return state, {k: v.detach() for k, v in metrics.items()}
