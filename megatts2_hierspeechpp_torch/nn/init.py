"""Seeded weight initialisation for runs without a checkpoint
(chip_smoke.py).

One explicit torch.Generator per call, on the CPU, so the weights depend only
on the seed and the module structure. The scales are chosen so that the
full-width vocoder + SpeechSR give a waveform of realistic amplitude, neither
vanishing nor saturating the tanh (peak about 0.1-0.3; the reference's
N(0, 0.01) weight-norm init gives about 1e-4, unit gain everywhere
saturates):

  weight  N(0, (GAIN / fan_in)^2): weight-norm, transposed and k > 1 convs
          N(0, 1 / fan_in): 1x1 convs and linear layers
  weight-norm weight_g = ||weight_v||, so the effective weight is weight_v
  bias 0; snake alpha / beta 0 (log scale: alpha = beta = 1)

fan_in is Cin*K for a conv and Cin*K/stride for a transposed conv. The
acoustic stage's other parameters:

  embedding tables and relative-position tables  N(0, 1 / dim)
  LSTM weights and bias_ih  U(-1/sqrt(H), 1/sqrt(H)) (torch's default
          range); bias_hh 0 (the port's one-bias convention)
  RVQ codebook  N(0, 1)
  LayerNorm scale 1, bias 0 (their constructors')

Wav2Vec2 and the denoiser (MPNet) add:

  torch Conv1d / Conv2d  as Conv1d above; ConvTranspose2d as a transposed
          conv (fan_in Cin*Kh*Kw/stride)
  WNConv2d (the discriminators')  as a weight-norm conv, fan_in Cin*Kh*Kw
  w2v positional conv (weight norm over the kernel axis): weight_v as a
          k > 1 conv, weight_g = ||weight_v|| per tap
  attention in_proj_weight  N(0, 1 / dim)
  BatchNorm1d running_mean N(0, 0.1^2), running_var exp(N(0, 0.2^2)), so
          that the inference statistics are not the identity
  InstanceNorm2d, PReLU (0.25), the mask's sigmoid slope (1): their
          constructors'
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.activations import SnakeBeta
from megatts2_hierspeechpp_torch.nn.attention import MultiHeadAttention
from megatts2_hierspeechpp_torch.nn.conv import (
    Conv1d,
    WNConv1d,
    WNConv2d,
    WNConvTranspose1d,
)
from megatts2_hierspeechpp_torch.nn.quantize import EuclideanCodebook


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    # the models that use these import this module
    from megatts2_hierspeechpp_torch.models.denoiser import TorchMHA
    from megatts2_hierspeechpp_torch.models.wav2vec2 import PosConv

    gen = torch.Generator().manual_seed(seed)
    gain = 0.5

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen) * std)

    for m in module.modules():
        if isinstance(m, PosConv):
            normal_(m.weight_v, gain * m.weight_v[0].numel() ** -0.5)
            m.weight_g.copy_(m.weight_v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt())
        elif isinstance(m, TorchMHA):
            normal_(m.in_proj_weight, m.in_proj_weight.shape[1] ** -0.5)
            m.in_proj_bias.zero_()
            continue
        elif isinstance(m, nn.BatchNorm1d):
            normal_(m.running_mean, 0.1)
            m.running_var.copy_(torch.exp(torch.randn(m.running_var.shape,
                                                      generator=gen) * 0.2))
            continue
        elif isinstance(m, nn.ConvTranspose2d):
            cin, _, kh, kw = m.weight.shape
            normal_(m.weight, gain * (cin * kh * kw / m.stride[1]) ** -0.5)
        elif isinstance(m, (nn.Conv1d, nn.Conv2d)):
            g = gain if m.weight[0, 0].numel() > 1 else 1.0
            normal_(m.weight, g * m.weight[0].numel() ** -0.5)
        elif isinstance(m, (WNConv1d, WNConv2d)):
            normal_(m.weight_v, gain * m.weight_v[0].numel() ** -0.5)
            dims = tuple(range(1, m.weight_v.dim()))
            m.weight_g.copy_(m.weight_v.pow(2).sum(dim=dims, keepdim=True).sqrt())
        elif isinstance(m, WNConvTranspose1d):
            cin, _, k = m.weight_v.shape
            normal_(m.weight_v, gain * (cin * k / m.stride) ** -0.5)
            m.weight_g.copy_(m.weight_v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt())
        elif isinstance(m, (Conv1d, nn.Linear)):
            g = gain if m.weight.dim() == 3 and m.weight.shape[-1] > 1 else 1.0
            normal_(m.weight, g * m.weight[0].numel() ** -0.5)
        elif isinstance(m, SnakeBeta):
            m.alpha.zero_()
            m.beta.zero_()
            continue
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.embedding_dim ** -0.5)
            continue
        elif isinstance(m, MultiHeadAttention) and m.window_size is not None:
            normal_(m.emb_rel_k, m.emb_rel_k.shape[-1] ** -0.5)
            normal_(m.emb_rel_v, m.emb_rel_v.shape[-1] ** -0.5)
            continue
        elif isinstance(m, nn.LSTM):
            r = m.hidden_size ** -0.5
            for name, p in m.named_parameters():
                if name.startswith("bias_hh"):
                    p.zero_()
                else:
                    p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * r)
            continue
        elif isinstance(m, EuclideanCodebook):
            normal_(m.embed, 1.0)
            m.embed_avg.copy_(m.embed)
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
