"""HierSpeech++ hierarchical-VAE vocoder, inference path.

Counterpart of `megatts2_hierspeechpp_tpu/models/vocoder.py` (reference
hierspeechpp_speechsynthesizer.SynthesizerTrn): style encoder, source-filter
posterior, two reverse DiT flows, harmonic source network and the BigVGAN
Generator. The training-only members (enc_p, enc_q, mel_decoder, forward
flows) are not ported; the JAX inference methods never create their
parameters either.

Inference data flow:
  g = StyleEncoder(mel)                     (B, 256)
  z ~ enc_p_l(w2v, f0)                      (B, T, 192)   50 Hz
  z -> flow_l^-1 -> flow^-1
  e, e_ = SourceNetwork(z, g)               e: (B, 4T, C), e_: (B, 4T, 1)
  wav = Generator(z, e, g)                  (B, 320T, 1)  16 kHz

Posterior noise is noise_scale * N(0, 1) drawn on the CPU from the caller's
torch.Generator and moved to the model's device, so the same seed gives the
same noise on every device.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.basic import leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import (
    Conv1d,
    WNConv1d,
    WNConvTranspose1d,
)
from megatts2_hierspeechpp_torch.nn.dit import ResidualCouplingBlockTransformer
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.nn.resblocks import AMPBlock, fused_triple_enabled
from megatts2_hierspeechpp_torch.nn.styleencoder import StyleEncoder
from megatts2_hierspeechpp_torch.nn.wavenet import WN
from megatts2_hierspeechpp_torch.ops.amp_triple import fused_amp_triple


def _noise(shape, like, generator: Optional[torch.Generator]):
    if generator is None:
        return None
    return torch.randn(shape, generator=generator).to(like.device, like.dtype)


class PosteriorSFEncoder(nn.Module):
    """Source-filter posterior: w2v branch + strided-f0 branch -> WN."""

    def __init__(self, src_channels: int = 1024, out_channels: int = 192,
                 hidden_channels: int = 192, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 256):
        super().__init__()
        self.out_channels = out_channels
        half = n_layers // 2
        self.pre_source = Conv1d(src_channels, hidden_channels, 1)
        self.pre_filter = Conv1d(1, hidden_channels, 9, stride=4, padding=4)
        self.source_enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                             gin_channels)
        self.filter_enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                             gin_channels)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                      gin_channels)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1)

    def forward(self, x_src, x_ftr, x_mask, g):
        """x_src: (B, T, 1024) w2v; x_ftr: (B, 4T, 1) log-f0; x_mask:
        (B, T, 1); g: (B, Gin). Returns (m, logs), each (B, T, C_out)."""
        g2 = g[:, None, :]
        src = self.pre_source(x_src) * x_mask
        ftr = self.pre_filter(x_ftr) * x_mask
        src = self.source_enc(src, x_mask, g2)
        ftr = self.filter_enc(ftr, x_mask, g2)
        h = self.enc(src + ftr, x_mask, g2)
        stats = self.proj(h) * x_mask
        return stats[..., :self.out_channels], stats[..., self.out_channels:]


class SourceNetwork(nn.Module):
    """Harmonic excitation generator from z (x4 upsampling)."""

    resblock_kernels = (3, 5, 7)
    up_rates = (2, 2)
    up_kernels = (4, 4)

    def __init__(self, upsample_initial_channel: int = 256,
                 initial_channel: int = 192, gin_channels: int = 256):
        super().__init__()
        uic = upsample_initial_channel
        self.conv_pre = WNConv1d(initial_channel, uic, 7, padding=3)
        self.cond = Conv1d(gin_channels, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = uic
        for i, (u, k) in enumerate(zip(self.up_rates, self.up_kernels)):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, stride=u,
                                              padding=(k - u) // 2))
            for rk in self.resblock_kernels:
                self.resblocks.append(AMPBlock(ch, rk, (1, 3, 5)))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, g):
        """x: (B, T, C_in); g: (B, Gin) -> (e (B, 4T, C/4), e_ (B, 4T, 1))."""
        y = self.conv_pre(x) + self.cond(g)[:, None, :]
        n = len(self.resblock_kernels)
        for i, up in enumerate(self.ups):
            y = up(y)
            blocks = self.resblocks[i * n:(i + 1) * n]
            if fused_triple_enabled(y.shape[-1]):
                y = fused_amp_triple(y, [b.fused_weights() for b in blocks],
                                     self.resblock_kernels, ((1, 3, 5),) * n)
            else:
                xs = None
                for blk in blocks:
                    r = blk(y)
                    xs = r if xs is None else xs + r
                y = xs / float(n)
        y = self.activation_post(y)
        return y, self.conv_post(y)


def _interp_linear(x, out_len: int):
    """torch F.interpolate(mode='linear', align_corners=False) on (B, T, C),
    float32 positions as the JAX DBlock computes them."""
    t = x.shape[1]
    if out_len == t:
        return x
    pos = (torch.arange(out_len, device=x.device, dtype=torch.float32) + 0.5) \
        * (t / out_len) - 0.5
    pos = pos.clamp(0.0, t - 1)
    lo = pos.floor().long()
    hi = (lo + 1).clamp(max=t - 1)
    w = (pos - lo).to(x.dtype)[None, :, None]
    return x[:, lo, :] * (1 - w) + x[:, hi, :] * w


class DBlock(nn.Module):
    """Pitch/excitation downsampling block of the Generator."""

    def __init__(self, in_channels: int, hidden_size: int, factor: int):
        super().__init__()
        self.factor = factor
        self.residual_dense = WNConv1d(in_channels, hidden_size, 1)
        self.conv = nn.ModuleList(
            WNConv1d(in_channels if i == 0 else hidden_size, hidden_size, 3,
                     dilation=d, padding=d)
            for i, d in enumerate((1, 2, 4)))

    def forward(self, x):
        size = x.shape[1] // self.factor
        residual = _interp_linear(self.residual_dense(x), size)
        y = _interp_linear(x, size)
        for conv in self.conv:
            y = conv(leaky_relu(y))
        return y + residual


class Generator(nn.Module):
    """BigVGAN-style decoder with source excitation conditioning."""

    def __init__(self, initial_channel: int = 192,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_rates: Sequence[int] = (4, 5, 4, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (8, 11, 8, 4, 4),
                 gin_channels: int = 256, pitch_channels: int = 64):
        super().__init__()
        uic = upsample_initial_channel
        self.ks = tuple(resblock_kernel_sizes)
        self.dils = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.conv_pre = WNConv1d(initial_channel, uic, 7, padding=3)
        self.downs = DBlock(pitch_channels, uic, 4)
        self.cond = Conv1d(gin_channels, uic, 1)
        self.proj = Conv1d(pitch_channels, uic // 2, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = uic
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, stride=u,
                                              padding=(k - u) // 2))
            for rk, rd in zip(self.ks, self.dils):
                self.resblocks.append(AMPBlock(ch, rk, rd))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, pitch, g=None):
        """x: (B, T, C); pitch (excitation e): (B, 4T, C_e); g: (B, Gin)
        -> (B, 320T, 1) waveform."""
        y = self.conv_pre(x) + self.downs(pitch)
        if g is not None:
            y = y + self.cond(g)[:, None, :]
        n = len(self.ks)
        for i, up in enumerate(self.ups):
            y = up(y)
            if i == 0:
                y = y + self.proj(pitch)
            blocks = self.resblocks[i * n:(i + 1) * n]
            last = i == len(self.ups) - 1
            if fused_triple_enabled(y.shape[-1]):
                bws = [b.fused_weights() for b in blocks]
                if last:
                    pa, pib = self.activation_post.fused_params()
                    pw = self.conv_post.weight[0].t().contiguous()
                    return fused_amp_triple(y, bws, self.ks, self.dils,
                                            post=(pa, pib, pw))
                y = fused_amp_triple(y, bws, self.ks, self.dils)
            else:
                xs = None
                for blk in blocks:
                    r = blk(y)
                    xs = r if xs is None else xs + r
                y = xs / n
        y = self.activation_post(y)
        return torch.tanh(self.conv_post(y))


class HierVocoder(nn.Module):
    """HierSpeech++ vocoder (SynthesizerTrn equivalent), inference members.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent)."""

    def __init__(self, inter_channels: int = 192, hidden_channels: int = 192,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_rates: Sequence[int] = (4, 5, 4, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (8, 11, 8, 4, 4),
                 gin_channels: int = 256, posterior_wn_layers: int = 16,
                 n_flows: int = 4, flow_layers: int = 3, seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.enc_p_l = PosteriorSFEncoder(
            1024, inter_channels, hidden_channels, 5, 1, posterior_wn_layers,
            gin_channels)
        self.flow_l = ResidualCouplingBlockTransformer(
            inter_channels, hidden_channels, flow_layers, n_flows,
            gin_channels, attention_heads=2)
        self.flow = ResidualCouplingBlockTransformer(
            inter_channels, hidden_channels, flow_layers, n_flows,
            gin_channels, attention_heads=2)
        self.dec = Generator(
            inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
            upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
            gin_channels, pitch_channels=upsample_initial_channel // 8)
        self.sn = SourceNetwork(upsample_initial_channel // 2, inter_channels,
                                gin_channels)
        self.emb_g = StyleEncoder(80, 256, gin_channels)
        init_weights(self, seed)
        self.eval().requires_grad_(False).to(dev)

    def _vc_core(self, src_w2v, src_mask, g, f0, noise_scale, generator):
        m_p, logs_p = self.enc_p_l(src_w2v, f0, src_mask, g)
        noise = _noise(m_p.shape, m_p, generator)
        if noise is not None:
            z = (m_p + noise * torch.exp(logs_p) * noise_scale) * src_mask
        else:
            z = m_p * src_mask
        z = self.flow_l.reverse(z, src_mask, g)
        z = self.flow.reverse(z, src_mask, g)
        e, _ = self.sn(z, g)
        return z, e, g

    def forward(self, x_mel, w2v, x_mask, f0, generator=None):
        """The JAX `__call__` (reference infer): x_mel (B, T, 80); w2v
        (B, T, 1024); x_mask (B, T, 1); f0 (B, 4T, 1) -> (wav, e_)."""
        g = self.emb_g(x_mel, x_mask)
        m, logs = self.enc_p_l(w2v, f0, x_mask, g)
        noise = _noise(m.shape, m, generator)
        z = m * x_mask if noise is None else (m + noise * torch.exp(logs)) * x_mask
        z = self.flow_l.reverse(z, x_mask, g)
        z = self.flow.reverse(z, x_mask, g)
        e, e_ = self.sn(z, g)
        return self.dec(z, e, g=g), e_

    def vc_latent(self, src_w2v, src_mask, trg_mel, trg_mask, f0,
                  noise_scale: float = 0.333, generator=None,
                  denoise_ratio: float = 0.0):
        """Everything before the Generator: returns (z, e, g). The style of a
        2-row mel batch [orig; denoised] is interpolated by denoise_ratio."""
        g_all = self.emb_g(trg_mel, trg_mask)
        if g_all.shape[0] > 1:
            g = (1 - denoise_ratio) * g_all[:1] + denoise_ratio * g_all[1:2]
        else:
            g = g_all
        return self._vc_core(src_w2v, src_mask, g, f0, noise_scale, generator)

    def style_pairs(self, trg_mel, trg_mask):
        """trg_mel (2B, T, 80) with rows [orig_i; denoised_i] -> (B, 2, C),
        pooled at the prompt's own length."""
        g_all = self.emb_g(trg_mel, trg_mask)
        return g_all.reshape(-1, 2, g_all.shape[-1])

    def vc_latent_from_style(self, src_w2v, src_mask, g_pair, f0,
                             noise_scale: float = 0.333, generator=None,
                             denoise_ratio: float = 0.0):
        """vc_latent with style pairs computed beforehand: g_pair (1 or B,
        2, C) from style_pairs, [orig; denoised] interpolated by
        denoise_ratio per row."""
        g = (1 - denoise_ratio) * g_pair[:, 0] + denoise_ratio * g_pair[:, 1]
        return self._vc_core(src_w2v, src_mask, g, f0, noise_scale, generator)

    def voice_conversion_from_style(self, src_w2v, src_mask, g_pair, f0,
                                    noise_scale: float = 0.333, generator=None,
                                    denoise_ratio: float = 0.0):
        """voice_conversion with one cached style pair per row (B rows of
        src_w2v, 1 or B rows of g_pair) -> (B, 320T, 1)."""
        z, e, g = self.vc_latent_from_style(src_w2v, src_mask, g_pair, f0,
                                            noise_scale, generator,
                                            denoise_ratio)
        return self.dec(z, e, g=g)

    def decode_latent(self, z, e, g):
        """Generator-only decode of vc_latent outputs."""
        return self.dec(z, e, g=g)

    def voice_conversion(self, src_w2v, src_mask, trg_mel, trg_mask, f0,
                         noise_scale: float = 0.333, generator=None,
                         denoise_ratio: float = 0.0):
        """Reference voice_conversion_noise_control -> (B, 320T, 1)."""
        z, e, g = self.vc_latent(src_w2v, src_mask, trg_mel, trg_mask, f0,
                                 noise_scale, generator, denoise_ratio)
        return self.dec(z, e, g=g)
