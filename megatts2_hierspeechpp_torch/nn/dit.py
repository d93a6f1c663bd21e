"""DiT-style adaLN-zero transformer blocks and the coupling flow built from
them: `forward` (training: acoustic latent -> prior space) and `reverse`
(inference).

Counterpart of `megatts2_hierspeechpp_tpu/nn/dit.py` (reference
modules.py DiTConVBlock, ResidualCouplingLayer_Transformer_simple, Flip).
Module names follow the reference checkpoint: `cond_block.{0,2}`,
`flows.{2i}` (couplings; the odd entries are the parameterless Flips),
`enc_block.{j}`, `adaLN_modulation.1`. `dtype`: the compute dtype of the
projections, convs and attention products; the LayerNorms compute in
float32 and return their input's dtype, as the JAX blocks' do.
"""
from __future__ import annotations

import torch
from torch import nn

from megatts2_hierspeechpp_torch.nn.basic import Dense, LayerNorm, gelu_tanh
from megatts2_hierspeechpp_torch.nn.conv import Conv1d


def modulate(x, shift, scale):
    """x: (B, T, C); shift/scale: (B, C)."""
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class TimmAttention(nn.Module):
    """timm vision_transformer.Attention: fused qkv, no masking."""

    def __init__(self, dim: int, num_heads: int, dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).view(b, t, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, T, D)
        attn = torch.softmax(torch.matmul(q * hd ** -0.5, k.transpose(-1, -2)),
                             dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
        return self.proj(out)


class FFNConv(nn.Module):
    """Conv-FFN of the DiT block: fc1 conv k, GELU-tanh, fc2 1x1."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, kernel: int = 5, dtype=None):
        super().__init__()
        self.fc1 = Conv1d(in_features, hidden_features, kernel,
                          padding=(kernel - 1) // 2, dtype=dtype)
        self.fc2 = Conv1d(hidden_features, out_features, 1, dtype=dtype)

    def forward(self, x, x_mask):
        y = gelu_tanh(self.fc1(x))
        return self.fc2(y * x_mask) * x_mask


class DiTConVBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 mlp_ratio: float = 4.0, kernel: int = 9, dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(hidden_size, eps=1e-6)
        self.norm2 = LayerNorm(hidden_size, eps=1e-6)
        self.attn = TimmAttention(hidden_size, num_heads, dtype)
        self.mlp = FFNConv(hidden_size, int(hidden_size * mlp_ratio),
                           hidden_size, kernel, dtype)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), Dense(hidden_size, 6 * hidden_size, dtype=dtype))

    def forward(self, x, c, x_mask):
        """x: (B, T, C); c: (B, C) conditioning; x_mask: (B, T, 1)."""
        x = x * x_mask
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=-1)
        attn_out = self.attn(modulate(self.norm1(x) * x_mask, shift_msa, scale_msa))
        x = x + gate_msa[:, None, :] * attn_out * x_mask
        mlp_out = self.mlp(modulate(self.norm2(x), shift_mlp, scale_mlp), x_mask)
        return x + gate_mlp[:, None, :] * mlp_out


class ResidualCouplingLayerTransformer(nn.Module):
    """Mean-only affine coupling with a DiT transformer as the shift net."""

    def __init__(self, channels: int, hidden_channels: int, n_layers: int,
                 attention_heads: int = 2, kernel: int = 5, dtype=None):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1, dtype=dtype)
        self.enc_block = nn.ModuleList(
            DiTConVBlock(hidden_channels, attention_heads, 4.0, kernel, dtype)
            for _ in range(n_layers))
        self.post = Conv1d(hidden_channels, self.half, 1, dtype=dtype)

    def _shift(self, x0, x_mask, c):
        h = self.pre(x0) * x_mask
        for blk in self.enc_block:
            h = blk(h, c, x_mask)
        return self.post(h) * x_mask

    def forward(self, x, x_mask, c):
        """x1 + m(x0); the JAX layer's log-determinant is zeros and not
        returned."""
        x0, x1 = x[..., :self.half], x[..., self.half:]
        x1 = (x1 + self._shift(x0, x_mask, c)) * x_mask
        return torch.cat([x0, x1], dim=-1)

    def reverse(self, x, x_mask, c):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        x1 = (x1 - self._shift(x0, x_mask, c)) * x_mask
        return torch.cat([x0, x1], dim=-1)


class Flip(nn.Module):
    """Channel flip between coupling steps (no parameters)."""

    def forward(self, x):
        return torch.flip(x, dims=(-1,))


class ResidualCouplingBlockTransformer(nn.Module):
    """n_flows x (DiT coupling + Flip) with a SiLU-MLP conditioning block."""

    def __init__(self, channels: int, hidden_channels: int, n_layers: int = 3,
                 n_flows: int = 4, gin_channels: int = 256,
                 attention_heads: int = 2, dtype=None):
        super().__init__()
        self.cond_block = nn.Sequential(
            Dense(gin_channels, 4 * hidden_channels, dtype=dtype), nn.SiLU(),
            Dense(4 * hidden_channels, hidden_channels, dtype=dtype))
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayerTransformer(
                channels, hidden_channels, n_layers, attention_heads,
                dtype=dtype))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g):
        """The flows in order, each followed by its Flip. x: (B, T, C); g:
        (B, Gin) global conditioning vector."""
        c = self.cond_block(g)
        for flow in self.flows:
            x = flow(x) if isinstance(flow, Flip) else flow(x, x_mask, c)
        return x

    def reverse(self, x, x_mask, g):
        """Inverse of forward. x: (B, T, C); g: (B, Gin)."""
        c = self.cond_block(g)
        for flow in reversed(self.flows):
            x = flow(x) if isinstance(flow, Flip) else flow.reverse(x, x_mask, c)
        return x
