"""GAN + VAE losses, computed in float32.

Counterpart of `megatts2_hierspeechpp_tpu/train/losses.py` (reference
losses.py): feature matching, the LSGAN discriminator and generator losses,
and the masked KL between posterior samples and prior statistics.
"""
from __future__ import annotations

from typing import Sequence

import torch

from megatts2_hierspeechpp_torch.parallel import mesh


def feature_loss(fmap_r: Sequence, fmap_g: Sequence):
    """L1 over every discriminator feature map, times 2."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + (rl.float() - gl.float()).abs().mean()
    return loss * 2


def discriminator_loss(disc_real: Sequence, disc_gen: Sequence):
    """LSGAN: sum of mean (1 - D(y))^2 + mean D(y_hat)^2 -> (loss, real
    losses, generated losses)."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r_loss = (1 - dr.float()).square().mean()
        g_loss = dg.float().square().mean()
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence):
    """LSGAN: sum of mean (1 - D(y_hat))^2 -> (loss, per discriminator)."""
    gen_losses = [(1 - dg.float()).square().mean() for dg in disc_outputs]
    return sum(gen_losses), gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask):
    """Masked KL; z_p, logs_q, m_p, logs_p: (B, T, C); z_mask: (B, T, 1)."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (z_p - m_p).square() * torch.exp(-2.0 * logs_p)
    # in a data-parallel step, this rank's share of the global masked mean
    return (kl * z_mask).sum() / mesh.share_denominator(z_mask.sum())
