"""Speech super-resolution heads (16 kHz -> 24 kHz / 48 kHz).

Counterpart of `megatts2_hierspeechpp_tpu/models/speechsr.py` (reference
speechsr48k / speechsr24k Generator): WN conv_pre, linear-interpolation
upsample with an exact index table, three AMP blocks, conv_post -> tanh.
Parameter names are those of the reference Generator without its `dec.`
prefix.
"""
from __future__ import annotations

from math import gcd

import numpy as np
import torch
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.conv import Conv1d, WNConv1d
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.nn.resblocks import (
    AMPBlock, blocks_mean, fused_triple_enabled, stage_packs)
from megatts2_hierspeechpp_torch.ops.amp_triple import fused_amp_triple
from megatts2_hierspeechpp_torch.utils.profiling import annotate


def interp_linear(x, out_len: int):
    """torch F.interpolate(mode='linear', align_corners=False) on (B, T, C),
    with source positions computed EXACTLY from the rational ratio
    out_len / t: output i = q*num + s sits at q*den + pos_s[s]. An fp32
    (i + 0.5) * scale - 0.5 drifts by ~i*eps (a quarter sample at 80 s of
    48 kHz) and makes chunked and whole upsampling disagree.

    Each of the `num` phases is a constant-weight lerp of two stride-`den`
    slices of x replicate-padded by one sample; the phases interleave into
    the output stream. The weights w and 1 - w are formed in x's dtype, as
    the JAX function forms them (float32, or bf16 for a bf16 x)."""
    b, t, c = x.shape
    if out_len == t:
        return x
    g = gcd(out_len, t)
    num, den = out_len // g, t // g
    q_len = out_len // num
    pos_s = (np.arange(num) + 0.5) * den / num - 0.5  # float64, one period
    lo_s = np.floor(pos_s).astype(np.int64)  # in [-1, den - 1]
    w_s = torch.from_numpy(pos_s - lo_s).to(x.dtype)
    w_1 = 1 - w_s
    xp = torch.cat([x[:, :1], x, x[:, -1:]], dim=1)  # (B, t + 2, C)
    phases = []
    for s in range(num):
        a = int(lo_s[s]) + 1
        end = a + (q_len - 1) * den + 1
        lo_v = xp[:, a:end:den]
        hi_v = xp[:, a + 1:end + 1:den]
        phases.append(lo_v * float(w_1[s]) + hi_v * float(w_s[s]))
    return torch.stack(phases, dim=2).reshape(b, out_len, c)


def rate_for(output_sr: int) -> tuple[int, int]:
    """(rate_num, rate_den) of the 16 kHz -> output_sr model: 48 or 24 kHz."""
    if output_sr not in (24000, 48000):
        raise ValueError(f"SpeechSR outputs 24 or 48 kHz, not {output_sr}")
    return (3, 1) if output_sr == 48000 else (3, 2)


class SpeechSR(nn.Module):
    """rate_num / rate_den = 3/1 for 48 kHz, 3/2 for 24 kHz. Built on the
    CPU with seeded weights, then moved to `device` ("cuda" by default;
    raises if CUDA is absent). A serving build (the default) is frozen;
    `train=True` leaves every parameter trainable (the same weights for a
    seed). The forward is the same in both: at C <= 64 the whole hi-rate
    stage runs as fused_amp_triple, whose backward reaches conv_pre, every
    AMPBlock, activation_post and conv_post. `dtype`: the compute dtype of
    the convs (bf16: the stage kernel's bf16 configuration, bench.py's
    SpeechSR-48k); the weights stay float32."""

    def __init__(self, upsample_initial_channel: int = 32, rate_num: int = 3,
                 rate_den: int = 1, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 seed: int = 0, device: str | torch.device = "cuda",
                 train: bool = False, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        ch = upsample_initial_channel
        self.rate_num, self.rate_den = rate_num, rate_den
        self.ks = tuple(resblock_kernel_sizes)
        self.dils = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.conv_pre = WNConv1d(1, ch, 7, padding=3, dtype=dtype)
        self.resblocks = nn.ModuleList(
            AMPBlock(ch, k, d, dtype=dtype) for k, d in zip(self.ks, self.dils))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, dtype=dtype)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    def forward(self, x):
        """x: (B, T, 1) 16 kHz waveform -> (B, T * rate, 1). The span
        speechsr, the stage's weights in weights.prep."""
        with annotate("speechsr"):
            y = self.conv_pre(x)
            y = interp_linear(y, int(y.shape[1] * self.rate_num // self.rate_den))
            if fused_triple_enabled(y.shape[-1]):
                with annotate("weights.prep"):
                    pa, pib = self.activation_post.fused_params()
                    pw = self.conv_post.weight[0].t().contiguous()
                    bws = [b.fused_weights() for b in self.resblocks]
                    packs = stage_packs(self.resblocks, y)
                return fused_amp_triple(y, bws, self.ks, self.dils,
                                        post=(pa, pib, pw), packed=packs)
            y = self.activation_post(blocks_mean(self.resblocks, y))
            return torch.tanh(self.conv_post(y))
