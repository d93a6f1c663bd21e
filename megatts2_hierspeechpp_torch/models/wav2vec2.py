"""wav2vec2 (facebook/mms-300m) feature encoder, inference only.

Counterpart of `megatts2_hierspeechpp_tpu/models/wav2vec2.py:Wav2Vec2`: the
reference takes hidden_states[7] of the frozen HF Wav2Vec2ForPreTraining,
the output of its 7th transformer layer, as the 1024-d 50 Hz feature of
voice conversion. Conv feature extractor (layer-norm variant), feature
projection, convolutional relative positions (weight-normed over the
kernel axis), then `output_layer` pre-norm (stable layer-norm) transformer
layers; the later layers are not built.

Parameter names are the HF Wav2Vec2Model's (the keys of
Wav2Vec2ForPreTraining without its `wav2vec2.` prefix, and of the first
`output_layer` encoder layers only), so a checkpoint loads with
load_state_dict once that prefix is stripped and the other keys dropped.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.init import init_weights

KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)


class ConvLayer(nn.Module):
    """HF Wav2Vec2LayerNormConvLayer: conv (with bias) -> LayerNorm over
    channels -> exact GELU, on (B, C, T)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride)
        self.layer_norm = nn.LayerNorm(cout)

    def forward(self, x):
        y = self.layer_norm(self.conv(x).transpose(1, 2)).transpose(1, 2)
        return F.gelu(y)


class ConvFeatureExtractor(nn.Module):
    def __init__(self, conv_dim: Sequence[int] = (512,) * 7):
        super().__init__()
        cins = (1, *conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            ConvLayer(ci, co, k, s)
            for ci, co, k, s in zip(cins, conv_dim, KERNELS, STRIDES))

    def forward(self, x):
        """x: (B, T) waveform -> (B, T', conv_dim[-1])."""
        y = x[:, None]
        for layer in self.conv_layers:
            y = layer(y)
        return y.transpose(1, 2)


class FeatureProjection(nn.Module):
    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(cin)
        self.projection = nn.Linear(cin, hidden)

    def forward(self, x):
        return self.projection(self.layer_norm(x))


class PosConv(nn.Module):
    """Grouped conv with weight norm over the kernel axis (torch
    weight_norm(dim=2): w = g * v / ||v||, the norm over Cout and Cin/groups
    for each tap): weight_g (1, 1, K), weight_v (Cout, Cin/groups, K)."""

    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.padding, self.groups = kernel // 2, groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(
            torch.empty(channels, channels // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(channels))

    def weight(self):
        norm = self.weight_v.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
        return self.weight_g * (self.weight_v / norm)

    def forward(self, x):
        """(B, C, T) -> (B, C, T + 1 - K % 2)."""
        return F.conv1d(x, self.weight(), self.bias, padding=self.padding,
                        groups=self.groups)


class PosConvEmbed(nn.Module):
    def __init__(self, channels: int, kernel: int, groups: int):
        super().__init__()
        self.conv = PosConv(channels, kernel, groups)
        self.even = kernel % 2 == 0

    def forward(self, x):
        """x: (B, T, C) -> GELU(conv(x)), (B, T, C)."""
        y = self.conv(x.transpose(1, 2))
        if self.even:  # HF SamePadLayer drops the last frame
            y = y[..., :-1]
        return F.gelu(y).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, t, c = x.shape

        def heads(y):
            return y.reshape(b, t, self.n_heads, -1).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x)))
        return self.out_proj(o.transpose(1, 2).reshape(b, t, c))


class FeedForward(nn.Module):
    def __init__(self, dim: int, ffn_dim: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(dim, ffn_dim)
        self.output_dense = nn.Linear(ffn_dim, dim)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    """Stable-layer-norm (pre-norm) transformer layer."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(dim)
        self.attention = Attention(dim, n_heads)
        self.final_layer_norm = nn.LayerNorm(dim)
        self.feed_forward = FeedForward(dim, ffn_dim)

    def forward(self, x):
        x = x + self.attention(self.layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class Encoder(nn.Module):
    def __init__(self, dim: int, n_heads: int, ffn_dim: int, n_layers: int,
                 pos_kernel: int, pos_groups: int):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(dim, pos_kernel, pos_groups)
        self.layers = nn.ModuleList(
            EncoderLayer(dim, n_heads, ffn_dim) for _ in range(n_layers))

    def forward(self, x):
        x = x + self.pos_conv_embed(x)
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2(nn.Module):
    """mms-300m widths by default. Built on the CPU with seeded weights
    (nn/init.py), then moved to `device` ("cuda" by default; raises if CUDA
    is absent)."""

    def __init__(self, hidden_size: int = 1024, n_heads: int = 16,
                 ffn_dim: int = 4096, output_layer: int = 7,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16,
                 conv_dim: Sequence[int] = (512,) * 7, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = ConvFeatureExtractor(tuple(conv_dim))
        self.feature_projection = FeatureProjection(conv_dim[-1], hidden_size)
        self.encoder = Encoder(hidden_size, n_heads, ffn_dim, output_layer,
                               pos_conv_kernel, pos_conv_groups)
        init_weights(self, seed)
        self.eval().requires_grad_(False).to(dev)

    def forward(self, x):
        """x: (B, T) 16 kHz waveform -> (B, T', hidden) at 50 Hz: the output
        of layer `output_layer`."""
        feats = self.feature_extractor(x)
        return self.encoder(self.feature_projection(feats))


# ---------- HuBERT (chinese-hubert-base family) ----------


class GroupNormConvLayer(nn.Module):
    """HF HubertGroupNormConvLayer (block 0): conv without bias ->
    per-channel GroupNorm over time -> exact GELU, on (B, C, T)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=False)
        self.layer_norm = nn.GroupNorm(cout, cout, eps=1e-5)

    def forward(self, x):
        return F.gelu(self.layer_norm(self.conv(x)))


class NoLayerNormConvLayer(nn.Module):
    """HF HubertNoLayerNormConvLayer (blocks 1-6): conv without bias ->
    exact GELU."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, kernel, stride=stride, bias=False)

    def forward(self, x):
        return F.gelu(self.conv(x))


class GroupNormConvFeatureExtractor(ConvFeatureExtractor):
    """The group-norm variant of the conv extractor (HF *base* SSL models:
    no conv bias, GroupNorm on block 0 only)."""

    def __init__(self, conv_dim: Sequence[int] = (512,) * 7):
        nn.Module.__init__(self)
        cins = (1, *conv_dim[:-1])
        self.conv_layers = nn.ModuleList(
            (GroupNormConvLayer if i == 0 else NoLayerNormConvLayer)(ci, co, k, s)
            for i, (ci, co, k, s) in enumerate(zip(cins, conv_dim, KERNELS,
                                                   STRIDES)))


class HubertEncoderLayer(nn.Module):
    """Post-norm transformer layer (do_stable_layer_norm=False)."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int):
        super().__init__()
        self.attention = Attention(dim, n_heads)
        self.layer_norm = nn.LayerNorm(dim)
        self.feed_forward = FeedForward(dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class HubertEncoder(nn.Module):
    """Positional conv, then the encoder LayerNorm, then the layers."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, n_layers: int,
                 pos_kernel: int, pos_groups: int):
        super().__init__()
        self.pos_conv_embed = PosConvEmbed(dim, pos_kernel, pos_groups)
        self.layer_norm = nn.LayerNorm(dim)
        self.layers = nn.ModuleList(
            HubertEncoderLayer(dim, n_heads, ffn_dim) for _ in range(n_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


class Hubert(nn.Module):
    """HF HubertModel, *base* variant (chinese-hubert-base widths by
    default), inference only: the counterpart of the JAX `Hubert`
    (models/wav2vec2.py:163-212). Parameter names are HF HubertModel's
    (without its `hubert.` prefix). Built on the CPU with seeded weights
    (nn/init.py), then moved to `device` ("cuda" by default; raises if CUDA
    is absent)."""

    def __init__(self, hidden_size: int = 768, n_heads: int = 12,
                 ffn_dim: int = 3072, n_layers: int = 12,
                 pos_conv_kernel: int = 128, pos_conv_groups: int = 16,
                 conv_dim: Sequence[int] = (512,) * 7, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.feature_extractor = GroupNormConvFeatureExtractor(tuple(conv_dim))
        self.feature_projection = FeatureProjection(conv_dim[-1], hidden_size)
        self.encoder = HubertEncoder(hidden_size, n_heads, ffn_dim, n_layers,
                                     pos_conv_kernel, pos_conv_groups)
        init_weights(self, seed)
        self.eval().requires_grad_(False).to(dev)

    def forward(self, x):
        """x: (B, T) 16 kHz waveform -> last_hidden_state (B, T', hidden)
        at 50 Hz."""
        feats = self.feature_extractor(x)
        return self.encoder(self.feature_projection(feats))

