"""s2-stage (MegaTTS2 acoustic model) GAN trainer.

Counterpart of `megatts2_hierspeechpp_tpu/train/s2.py` (reference
train_ms.py:195-312):

  - one TTV training forward (dropout on, the pitch predictor fed the
    ground-truth w2v or the prediction by a coin, the RVQ codebooks taking
    one EMA step);
  - the D step: the MultiResSpecDiscriminator on (w2v, the detached
    prediction), both swapped to (B, 1024, T), LSGAN loss, AdamW; its real
    pass runs the spectral norm's power iteration;
  - the G step through the updated D with the new u / v, total
        2 dur + pitch + (MSE + L1)(w2v) x 1024 / sum(mask) x c_mel
        + feature matching + LSGAN gen + c_commit x commit,
    the MSE and L1 averaged over the padded tensor, as JAX.
One generator forward serves both steps (JAX linearises it once as well).

The step's random draws (`TrainStep.draw`) come from the loop's per-step
CPU generator: the teacher-force coin (uniform <= 0.5), then a seed for
the dropout masks' generator on the batch's device. `TrainStep.with_draws`
runs a step on draws given from outside: the tests feed it the JAX step's
coin and masks, the card-vs-CPU gate a CPU mask generator on both sides.

The models compute in their own `dtype` (cli/train_s2 builds them in
bf16 by default, as the JAX CLI): w2v_pred and the losses come out float32
(the masks promote them, the losses read the D's bf16 logits in float32),
the RVQ statistics update in float32, and the parameters, their gradients
and the AdamW moments stay float32.

Data parallel (parallel/mesh.py): the step runs inside
`mesh.global_batch()`, so a rank holding its rows of the global batch
computes the JAX step on that batch: the dropout masks are the global
batch's rows, the RVQ statistics, the duration loss's and the w2v loss's
mask sums are global, both gradients are averaged over the ranks before
their norms and updates, and the losses are averaged into the metrics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from megatts2_hierspeechpp_torch.models.discriminators import (
    MultiResSpecDiscriminator,
)
from megatts2_hierspeechpp_torch.models.ttv import TTVModel
from megatts2_hierspeechpp_torch.nn.basic import MaskSource, dropout_masks
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.train import losses as L
from megatts2_hierspeechpp_torch.train.optim import AdamW

TTV_INPUTS = ("x_ids", "tone", "language", "x_lengths", "w2v", "w2v_lengths",
              "mel", "mel_lengths", "pitch", "pitch_lengths", "dur",
              "mrte_mel", "mrte_mel_lengths")


def global_norm(params) -> torch.Tensor:
    """The L2 norm of every gradient together (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad) for p in params if p.grad is not None]))


def device_masks(generator: torch.Generator, device) -> MaskSource:
    """A MaskSource on `device` seeded by one draw from `generator`."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
    return MaskSource(torch.Generator(device=device).manual_seed(seed))


@dataclass
class S2TrainState:
    """The acoustic model (a training build; its state_dict holds the RVQ
    statistics), the discriminator (with the spectral norm's u / v), their
    optimizers and the step count. The step updates it in place."""

    ttv: TTVModel
    disc: MultiResSpecDiscriminator
    opt_g: AdamW
    opt_d: AdamW
    step: int = 0

    def state_dict(self) -> dict:
        return {"step": self.step, "ttv": self.ttv.state_dict(),
                "disc": self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.ttv.load_state_dict(state["ttv"])
        self.disc.load_state_dict(state["disc"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])


def create_state(ttv: TTVModel, disc: MultiResSpecDiscriminator,
                 **adamw_kwargs) -> S2TrainState:
    """A step-0 state, one AdamW(**adamw_kwargs) each."""
    return S2TrainState(ttv, disc, AdamW(ttv.parameters(), **adamw_kwargs),
                        AdamW(disc.parameters(), **adamw_kwargs))


class TrainStep:
    """The s2 train step (the JAX make_train_step);
    `step(state, batch, generator)` -> (state, metrics). batch: the
    data/dataset.collate keys as tensors on the model's device. Metrics are
    detached 0-d tensors under the JAX names."""

    def __init__(self, c_mel: float = 1.0, c_commit: float = 100.0):
        self.c_mel, self.c_commit = c_mel, c_commit

    def __call__(self, state: S2TrainState, batch: Dict,
                 generator: torch.Generator):
        return self.with_draws(state, batch, *self.draw(batch, generator))

    def draw(self, batch: Dict, generator: torch.Generator):
        """(teacher-force coin, a 0-d bool tensor on the batch's device;
        the dropout MaskSource)."""
        dev = batch["w2v"].device
        coin = (torch.rand((), generator=generator) <= 0.5).to(dev)
        return coin, device_masks(generator, dev)

    def with_draws(self, state: S2TrainState, batch: Dict, teacher_force,
                   masks: MaskSource):
        with mesh.global_batch():
            return self._step(state, batch, teacher_force, masks)

    def _step(self, state: S2TrainState, batch: Dict, teacher_force,
              masks: MaskSource):
        ttv, disc = state.ttv, state.disc
        ttv.train()
        with dropout_masks(masks):
            out = ttv(*(batch[k] for k in TTV_INPUTS),
                      teacher_force_w2v=teacher_force, train_vq=True)
        w2v_pred = out["w2v_pred"]
        w2v_real = batch["w2v"].transpose(1, 2)   # (B, 1024, T)

        # D step on the detached prediction; the real pass updates u / v
        dr, dg, _, _ = disc(w2v_real, w2v_pred.detach().transpose(1, 2),
                            update_u=True)
        loss_d = L.discriminator_loss(dr, dg)[0]
        state.opt_d.zero_grad()
        loss_d.backward()
        mesh.reduce_grads(state.opt_d.params)
        grad_norm_d = global_norm(state.opt_d.params)
        state.opt_d.step()

        # G step through the updated D, whose parameters take no gradient
        disc.requires_grad_(False)
        try:
            dr, dg, fr, fg = disc(w2v_real, w2v_pred.transpose(1, 2))
        finally:
            disc.requires_grad_(True)
        mask_sum = mesh.batch_sum(out["y_mask"].sum())
        diff = batch["w2v"] - w2v_pred
        loss_dur = out["l_length"].float() * 2.0
        loss_pitch = out["l_pitch"].float()
        l_w2v = diff.float().square().mean() * 1024.0 / mask_sum * self.c_mel
        l_w2v1 = diff.float().abs().mean() * 1024.0 / mask_sum * self.c_mel
        loss_fm = L.feature_loss(fr, fg)
        loss_gen = L.generator_loss(dg)[0]
        commit = out["commit_loss"] * self.c_commit
        total = (loss_dur + loss_pitch + l_w2v + l_w2v1 + loss_fm + loss_gen
                 + commit)
        state.opt_g.zero_grad()
        total.backward()
        mesh.reduce_grads(state.opt_g.params)
        grad_norm_g = global_norm(state.opt_g.params)
        state.opt_g.step()
        state.step += 1
        metrics = mesh.reduce_metrics({
            "loss/g/total": total, "loss/g/dur": loss_dur,
            "loss/g/pitch": loss_pitch, "loss/g/w2v_mse": l_w2v,
            "loss/g/w2v_l1": l_w2v1, "loss/g/fm": loss_fm,
            "loss/g/gen": loss_gen, "loss/g/commit": commit,
            "loss/d/total": loss_d})
        metrics.update(grad_norm_g=grad_norm_g, grad_norm_d=grad_norm_d)
        return state, {k: v.detach() for k, v in metrics.items()}
