"""HierSpeech++ hierarchical-VAE vocoder.

Counterpart of `megatts2_hierspeechpp_tpu/models/vocoder.py` (reference
hierspeechpp_speechsynthesizer.SynthesizerTrn): style encoder, source-filter
posterior, two reverse DiT flows, harmonic source network and the BigVGAN
Generator. A training build (`train=True`, the JAX `init_all`) adds the
training-only members, trainable: the acoustic posterior `enc_q` over the
linear spectrogram and the raw wave, the vocoder's own source-filter
posterior `enc_p`, and the prosody head `mel_decoder`; `train_encode`
runs them with the forward flows, `decode_slice` the source network and
the Generator on a latent window. A serving build holds the inference
members only, frozen, and loads a training run's generator through
`serving_state_dict`.

Inference data flow:
  g = StyleEncoder(mel)                     (B, 256)
  z ~ enc_p_l(w2v, f0)                      (B, T, 192)   50 Hz
  z -> flow_l^-1 -> flow^-1
  e, e_ = SourceNetwork(z, g)               e: (B, 4T, C), e_: (B, 4T, 1)
  wav = Generator(z, e, g)                  (B, 320T, 1)  16 kHz

Posterior noise is noise_scale * N(0, 1) drawn on the CPU from the caller's
torch.Generator and moved to the model's device, so the same seed gives the
same noise on every device.

`dtype` (None: float32) is the JAX modules' compute dtype, handed to every
member: each conv, projection and attention product takes its operands in
it, while parameters stay float32 and the masks, the posterior statistics
after their mask and the LayerNorms stay float32 as the JAX dataflow
promotes them. bf16 runs the three vocoder kernels in their bf16
configuration (bench.py's `HierVocoder(dtype=jnp.bfloat16)`, the JAX
vocoder CLI's default).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.attention import Encoder
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


# state_dict prefixes of the members a training build adds
TRAINING_ONLY = ("enc_p.", "enc_q.", "mel_decoder.")


def serving_state_dict(state_dict: dict) -> dict:
    """A training build's state_dict without its training-only members:
    what a serving HierVocoder loads (as the JAX serving params leave them
    out)."""
    return {k: v for k, v in state_dict.items()
            if not k.startswith(TRAINING_ONLY)}


def _noise(shape, like, generator: Optional[torch.Generator]):
    if generator is None:
        return None
    return torch.randn(shape, generator=generator).to(like.device, like.dtype)


class PosteriorSFEncoder(nn.Module):
    """Source-filter posterior: w2v branch + strided-f0 branch -> WN."""

    def __init__(self, src_channels: int = 1024, out_channels: int = 192,
                 hidden_channels: int = 192, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 256, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        half = n_layers // 2
        self.pre_source = Conv1d(src_channels, hidden_channels, 1, dtype=dtype)
        self.pre_filter = Conv1d(1, hidden_channels, 9, stride=4, padding=4,
                                 dtype=dtype)
        self.source_enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                             gin_channels, dtype=dtype)
        self.filter_enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                             gin_channels, dtype=dtype)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, half,
                      gin_channels, dtype=dtype)
        self.proj = Conv1d(hidden_channels, 2 * out_channels, 1, dtype=dtype)

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


class PosteriorAudioEncoder(nn.Module):
    """Acoustic posterior (enc_q): WN over the linear spectrogram beside a
    raw-wave branch that downsamples 320x (strided WN convs at rates 8 / 5
    / 4 / 2, each followed by 3 AMPBlocks averaged, at C = 32 / 64 / 128 /
    192)."""

    down_rates = (8, 5, 4, 2)
    down_kernels = (17, 10, 8, 4)
    chans = (16, 32, 64, 128, 192)
    resblock_kernels = (3, 7, 11)

    def __init__(self, in_channels: int = 641, out_channels: int = 192,
                 hidden_channels: int = 192, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 256, dtype=None):
        super().__init__()
        self.out_channels = out_channels
        ch = self.chans
        self.down_pre = Conv1d(1, ch[0], 7, padding=3, dtype=dtype)
        self.downs = nn.ModuleList(
            WNConv1d(ch[i], ch[i + 1], k, stride=u, padding=(k - 1) // 2,
                     dtype=dtype)
            for i, (u, k) in enumerate(zip(self.down_rates, self.down_kernels)))
        self.resblocks = nn.ModuleList(
            AMPBlock(ch[i + 1], k, (1, 3, 5), dtype=dtype)
            for i in range(len(self.downs)) for k in self.resblock_kernels)
        self.activation_post = AASnakeBeta(ch[-1])
        self.conv_post = Conv1d(ch[-1], hidden_channels, 7, padding=3,
                                dtype=dtype)
        self.pre = Conv1d(in_channels, hidden_channels, 1, dtype=dtype)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels, dtype=dtype)
        self.proj = Conv1d(2 * hidden_channels, 2 * out_channels, 1,
                           dtype=dtype)

    def forward(self, x_spec, x_audio, x_mask, g, noise=None):
        """x_spec: (B, T, 641); x_audio: (B, 320T, 1); x_mask: (B, T, 1); g:
        (B, Gin); noise: N(0, 1) of z's shape, or None for z = m. Returns
        (z, m, logs), each (B, T, C_out)."""
        a = self.down_pre(x_audio)
        n = len(self.resblock_kernels)
        for i, down in enumerate(self.downs):
            a = down(a)
            xs = None
            for blk in self.resblocks[i * n:(i + 1) * n]:
                r = blk(a)
                xs = r if xs is None else xs + r
            a = xs / float(n)
        a = self.conv_post(self.activation_post(a))
        x = self.pre(x_spec) * x_mask
        x = self.enc(x, x_mask, g[:, None, :])
        h = torch.cat([x, a * x_mask], dim=-1)
        stats = self.proj(h) * x_mask
        m, logs = stats[..., :self.out_channels], stats[..., self.out_channels:]
        if noise is None:
            return m * x_mask, m, logs
        return (m + noise * torch.exp(logs)) * x_mask, m, logs


class MelDecoder(nn.Module):
    """Prosody head: z -> the first 20 mel bins, over a 2-layer relative-
    position transformer Encoder (training distillation target)."""

    def __init__(self, hidden_channels: int = 192, filter_channels: int = 768,
                 n_heads: int = 2, n_layers: int = 2, kernel_size: int = 5,
                 mel_size: int = 20, gin_channels: int = 256, dtype=None):
        super().__init__()
        self.conv_pre = Conv1d(hidden_channels, hidden_channels, 3, padding=1,
                               dtype=dtype)
        self.cond = Conv1d(gin_channels, hidden_channels, 1, dtype=dtype)
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size, dtype=dtype)
        self.proj = Conv1d(hidden_channels, mel_size, 1, bias=False,
                           dtype=dtype)

    def forward(self, x, x_mask, g=None):
        """x: (B, T, C); x_mask: (B, T, 1); g: (B, Gin) -> (B, T, 20)."""
        y = self.conv_pre(x * x_mask)
        if g is not None:
            y = y + self.cond(g)[:, None, :]
        y = self.encoder(y * x_mask, x_mask)
        return self.proj(y) * x_mask


class SourceNetwork(nn.Module):
    """Harmonic excitation generator from z (x4 upsampling)."""

    resblock_kernels = (3, 5, 7)
    up_rates = (2, 2)
    up_kernels = (4, 4)

    def __init__(self, upsample_initial_channel: int = 256,
                 initial_channel: int = 192, gin_channels: int = 256,
                 dtype=None):
        super().__init__()
        uic = upsample_initial_channel
        self.conv_pre = WNConv1d(initial_channel, uic, 7, padding=3,
                                 dtype=dtype)
        self.cond = Conv1d(gin_channels, uic, 1, dtype=dtype)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = uic
        for i, (u, k) in enumerate(zip(self.up_rates, self.up_kernels)):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, stride=u,
                                              padding=(k - u) // 2,
                                              dtype=dtype))
            for rk in self.resblock_kernels:
                self.resblocks.append(AMPBlock(ch, rk, (1, 3, 5), dtype=dtype))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, dtype=dtype)

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

    def __init__(self, in_channels: int, hidden_size: int, factor: int,
                 dtype=None):
        super().__init__()
        self.factor = factor
        self.residual_dense = WNConv1d(in_channels, hidden_size, 1, dtype=dtype)
        self.conv = nn.ModuleList(
            WNConv1d(in_channels if i == 0 else hidden_size, hidden_size, 3,
                     dilation=d, padding=d, dtype=dtype)
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
                 gin_channels: int = 256, pitch_channels: int = 64,
                 dtype=None):
        super().__init__()
        uic = upsample_initial_channel
        self.ks = tuple(resblock_kernel_sizes)
        self.dils = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.conv_pre = WNConv1d(initial_channel, uic, 7, padding=3,
                                 dtype=dtype)
        self.downs = DBlock(pitch_channels, uic, 4, dtype)
        self.cond = Conv1d(gin_channels, uic, 1, dtype=dtype)
        self.proj = Conv1d(pitch_channels, uic // 2, 7, padding=3, dtype=dtype)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = uic
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, stride=u,
                                              padding=(k - u) // 2,
                                              dtype=dtype))
            for rk, rd in zip(self.ks, self.dils):
                self.resblocks.append(AMPBlock(ch, rk, rd, dtype=dtype))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, dtype=dtype)

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
    """HierSpeech++ vocoder (SynthesizerTrn equivalent).

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent). A serving build
    (the default) holds the inference members, frozen; `train=True` adds
    enc_p, enc_q and mel_decoder after them (so the inference members get
    the same seeded weights in both builds) and leaves every parameter
    trainable. `dtype`: the compute dtype (module docstring); the weights
    are float32 and the same for a seed whatever it is."""

    def __init__(self, inter_channels: int = 192, hidden_channels: int = 192,
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = (
                     (1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 upsample_rates: Sequence[int] = (4, 5, 4, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (8, 11, 8, 4, 4),
                 gin_channels: int = 256, posterior_wn_layers: int = 16,
                 n_flows: int = 4, flow_layers: int = 3, seed: int = 0,
                 device: str | torch.device = "cuda", train: bool = False,
                 spec_channels: int = 641, filter_channels: int = 768,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        self.enc_p_l = PosteriorSFEncoder(
            1024, inter_channels, hidden_channels, 5, 1, posterior_wn_layers,
            gin_channels, dtype)
        self.flow_l = ResidualCouplingBlockTransformer(
            inter_channels, hidden_channels, flow_layers, n_flows,
            gin_channels, attention_heads=2, dtype=dtype)
        self.flow = ResidualCouplingBlockTransformer(
            inter_channels, hidden_channels, flow_layers, n_flows,
            gin_channels, attention_heads=2, dtype=dtype)
        self.dec = Generator(
            inter_channels, resblock_kernel_sizes, resblock_dilation_sizes,
            upsample_rates, upsample_initial_channel, upsample_kernel_sizes,
            gin_channels, pitch_channels=upsample_initial_channel // 8,
            dtype=dtype)
        self.sn = SourceNetwork(upsample_initial_channel // 2, inter_channels,
                                gin_channels, dtype)
        self.emb_g = StyleEncoder(80, 256, gin_channels, dtype)
        if train:
            self.enc_p = PosteriorSFEncoder(
                1024, inter_channels, hidden_channels, 5, 1,
                posterior_wn_layers, gin_channels, dtype)
            self.enc_q = PosteriorAudioEncoder(
                spec_channels, inter_channels, hidden_channels, 5, 1,
                posterior_wn_layers, gin_channels, dtype)
            self.mel_decoder = MelDecoder(
                inter_channels, filter_channels, gin_channels=gin_channels,
                dtype=dtype)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

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

    # ---- training (a build with train=True) ----

    def f0_extraction(self, x_spec, x_mel, x_mask, x_audio,
                      noise_scale: float = 0.333, generator=None):
        """Excitation from the acoustic posterior (reference :700-715): the
        source network's e_ (B, 4T, 1) from z ~ enc_q."""
        g = self.emb_g(x_mel, x_mask)
        _, m_q, logs_q = self.enc_q(x_spec, x_audio, x_mask, g)
        noise = _noise(m_q.shape, m_q, generator)
        z = m_q if noise is None else m_q + noise * torch.exp(logs_q) * noise_scale
        return self.sn(z, g)[1]

    def train_encode(self, x_spec, x_audio, x_mel, w2v, f0, x_mask, noise_q):
        """The training encoders on whole utterances: style, the acoustic
        posterior (z_q = m_q + noise_q * exp(logs_q), masked), both
        source-filter priors, the forward flows (z_q -> z_f -> z_fl) and the
        prosody head. f0: (B, 4T, 1) log(1 + Hz). Returns the JAX
        train_encode's dict."""
        g = self.emb_g(x_mel, x_mask)
        z_q, m_q, logs_q = self.enc_q(x_spec, x_audio, x_mask, g, noise_q)
        m_p, logs_p = self.enc_p(w2v, f0, x_mask, g)
        m_l, logs_l = self.enc_p_l(w2v, f0, x_mask, g)
        z_f = self.flow(z_q, x_mask, g)
        z_fl = self.flow_l(z_f, x_mask, g)
        return {"g": g, "mel_rec": self.mel_decoder(z_q, x_mask, g=g),
                "z_q": z_q, "m_q": m_q, "logs_q": logs_q,
                "z_f": z_f, "m_p": m_p, "logs_p": logs_p,
                "z_fl": z_fl, "m_l": m_l, "logs_l": logs_l}

    def decode_slice(self, z, g):
        """z: (B, T_seg, C) latent window -> (wav (B, 320 T_seg, 1), e_
        (B, 4 T_seg, 1))."""
        e, e_ = self.sn(z, g)
        return self.dec(z, e, g=g), e_


def vocoder_kwargs(hps) -> dict:
    """The HierVocoder widths and depths of a config's model keys."""
    m = hps.model
    return dict(
        inter_channels=m.inter_channels, hidden_channels=m.hidden_channels,
        upsample_rates=tuple(m.upsample_rates),
        upsample_initial_channel=m.upsample_initial_channel,
        upsample_kernel_sizes=tuple(m.upsample_kernel_sizes),
        posterior_wn_layers=m.get("posterior_wn_layers", 16),
        n_flows=m.get("n_flows", 4), flow_layers=m.get("flow_layers", 3),
        spec_channels=m.spec_channels, filter_channels=m.filter_channels)
