"""The four models of zero-shot TTS, plain float32, one row at a time.

TTV (MegaTTS2 acoustic model: text + prompt mel -> durations, the 50 Hz
latent, w2v features and log-f0), the prosody LM (teacher-forced logits),
the HierSpeech++ vocoder (posterior, two reverse DiT flows, source
network, BigVGAN generator) and SpeechSR. Widths come from the
configuration file's sections; parameter names are the published
checkpoints'. What the served program pads for a batch (the text to its
bucket, the frames to their bucket) is handed in as the padded shapes, so
a row here computes what a row of a batched call computes.
"""
from __future__ import annotations

import math
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.layers import (
    AASnakeBeta, AffineLayerNorm, AMPBlock, BiLSTM, Conv1d, Encoder, FlowDiT,
    LayerNorm, Linear, MultiHeadAttention, ResBlock1, StyleEncoder, WN,
    WNConv1d, WNConvTranspose1d, block_mean, feature_mask, leaky_relu, matmul)

LF0_FLOOR = math.log(55.0)


# ---------------- TTV ----------------


class TextEncoder(nn.Module):
    def __init__(self, n_vocab, n_tone, n_lang, h, filt, heads, layers, k=9):
        super().__init__()
        self.scale = math.sqrt(h)
        self.emb = nn.Embedding(n_vocab, h)
        self.emb_tone = nn.Embedding(n_tone, h)
        self.emb_language = nn.Embedding(n_lang, h)
        self.encoder = Encoder(h, filt, heads, layers, k)
        self.encoder2 = Encoder(h, filt, heads, 1, k)

    def forward(self, ids, tone, lang, mask):
        x = (self.emb(ids) * self.scale + self.emb_tone(tone) * self.scale
             + self.emb_language(lang) * self.scale)
        return self.encoder2(self.encoder(x * mask, mask) * mask, mask)


class MelEncoder(nn.Module):
    def __init__(self, out=256, hidden=80, filt=320, heads=4, layers=2, k=9):
        super().__init__()
        self.encoder = Encoder(hidden, filt, heads, layers, k)
        self.proj = Conv1d(hidden, out, 1)

    def forward(self, mel, mask):
        return self.proj(self.encoder(mel * mask, mask)) * mask


class W2VEncoder(nn.Module):
    def __init__(self, h, filt, heads, layers, k, gin):
        super().__init__()
        self.cond = Conv1d(gin, h, 1)
        self.encoder = Encoder(h, filt, heads, layers, k)
        self.encoder2 = Encoder(h, filt, heads, 1, k)

    def forward(self, x, mask, g):
        x = x + self.cond(g)[:, None, :]
        return self.encoder2(self.encoder(x * mask, mask) * mask, mask)


class W2VDecoder(nn.Module):
    def __init__(self, cin, hidden, k, layers, out, gin):
        super().__init__()
        self.pre = Conv1d(cin, hidden, 1)
        self.enc = WN(hidden, k, 1, layers, gin)
        self.proj = Conv1d(hidden, out, 1)

    def forward(self, x, mask, g):
        y = self.pre(x * mask) * mask
        return self.proj(self.enc(y, mask, g[:, None, :])) * mask


class PitchPredictor(nn.Module):
    kernels = (3, 5, 7)

    def __init__(self, cin=1024, uic=256, gin=256):
        super().__init__()
        self.conv_pre = Conv1d(cin, uic, 7, padding=3)
        self.cond = Conv1d(gin, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i in range(2):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, 4, 2, 1))
            for k in self.kernels:
                self.resblocks.append(ResBlock1(ch, k))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, g):
        y = self.conv_pre(x) + self.cond(g)[:, None, :]
        n = len(self.kernels)
        for i, up in enumerate(self.ups):
            y = up(leaky_relu(y))
            y = block_mean(self.resblocks[i * n:(i + 1) * n], y)
        return self.conv_post(leaky_relu(y, 0.01))


class DurationPredictor(nn.Module):
    def __init__(self, cin=256, filt=256, gin=256):
        super().__init__()
        self.cond = Conv1d(gin, cin, 1)
        self.lstms = BiLSTM(cin, filt, 2)
        self.norm_2 = AffineLayerNorm(2 * filt)
        self.proj = Conv1d(2 * filt, 1, 1)

    def forward(self, x, mask, g):
        x = x + self.cond(g)[:, None, :]
        y = torch.relu(self.norm_2(self.lstms(x * mask)))
        return F.softplus(self.proj(y * mask)) * mask


class _LinearNorm(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.linear_layer = Linear(cin, cout)


class RangePredictor(nn.Module):
    def __init__(self, cin=256, out=256):
        super().__init__()
        self.lstm = BiLSTM(cin + 1, out)
        self.proj = _LinearNorm(2 * out, 1)

    def forward(self, x, dur, n):
        y = self.lstm(torch.cat([x, dur[:, :, None]], dim=-1), n)
        return F.softplus(self.proj.linear_layer(y))[..., 0]


def gaussian_upsample(x, dur, rng, n, out_len):
    """x (1, N, H), dur / rng (1, N), n true phones -> (1, out_len, H)."""
    c = torch.cumsum(dur, dim=1) - 0.5 * dur
    t = torch.arange(out_len, dtype=torch.float32, device=x.device)[None, None]
    var = rng[:, :, None]
    diff = t - c[:, :, None]
    w = -0.5 * (math.log(2 * math.pi) + torch.log(var) + diff * diff / var)
    valid = torch.arange(x.shape[1], device=x.device)[None, :, None] < n
    w = torch.softmax(torch.where(valid, w, -1e15), dim=1)
    return matmul(w.transpose(1, 2), x)


class _PLMConv(nn.Module):
    def __init__(self, c=20):
        super().__init__()
        self.conv1 = Conv1d(c, c, 5, padding=2)
        self.conv2 = Conv1d(c, c, 5, padding=2)


class _Codebook(nn.Module):
    def __init__(self, dim, bins):
        super().__init__()
        for name, shape in (("inited", (1,)), ("cluster_size", (bins,)),
                            ("embed", (bins, dim)), ("embed_avg", (bins, dim))):
            self.register_buffer(name, torch.empty(shape))


class _VQ(nn.Module):
    def __init__(self, dim, bins):
        super().__init__()
        self._codebook = _Codebook(dim, bins)


class _Quantizer(nn.Module):
    def __init__(self, dim=20, bins=1024):
        super().__init__()
        self.vq = nn.Module()
        self.vq.layers = nn.ModuleList([_VQ(dim, bins)])

    def decode(self, codes):
        return self.vq.layers[0]._codebook.embed[codes.long()]


class TTV(nn.Module):
    """Acoustic model at the configuration's `ttv` widths."""

    def __init__(self, cfg: dict):
        super().__init__()
        ic, gin = cfg["inter_channels"], cfg["gin_channels"]
        heads, k = cfg["n_heads"], cfg["kernel_size"]
        self.enc_p = TextEncoder(cfg["n_vocab"], cfg["n_tone"], cfg["n_language"],
                                 ic, cfg["filter_channels"], heads,
                                 cfg["text_layers"], k)
        self.mel_encoder = MelEncoder(ic, cfg["n_mels"], cfg["mel_filter_channels"],
                                      heads, cfg["mel_enc_layers"], k)
        self.mha = MultiHeadAttention(ic, ic, heads)
        self.cond_g = Conv1d(gin, ic, 1)
        self.w2v_encoder = W2VEncoder(ic, cfg["filter_channels"], heads,
                                      cfg["w2v_enc_layers"], k, gin)
        self.w2v_decoder = W2VDecoder(ic, cfg["w2v_dec_hidden"], cfg["w2v_dec_kernel"],
                                      cfg["w2v_dec_layers"], cfg["w2v_dim"], gin)
        self.emb_g = StyleEncoder(cfg["n_mels"], cfg["style_hidden"], gin)
        self.duration_predictor = DurationPredictor(ic, cfg["duration_filter"], gin)
        self.RangePredictor = RangePredictor(ic, cfg["range_channels"])
        self.dur_downsample = Conv1d(ic, cfg["hidden_channels"], 1, stride=2)
        self.pp = PitchPredictor(cfg["w2v_dim"], cfg["pitch_channels"], gin)
        self.plm_conv1 = _PLMConv(cfg["prosody_size"])
        self.plm_conv2 = _PLMConv(cfg["prosody_size"])
        self.quantizer = _Quantizer(cfg["prosody_size"], cfg["vq_bins"])
        self.ssl_proj = Conv1d(cfg["prosody_size"], ic, 1)

    def encode(self, ids, tone, lang, n, mel):
        """One row: ids / tone / lang (1, N_pad) with n true phones; mel
        (1, T_p, 80) the padded prompt's, every frame valid. Returns (x
        (1, N_pad, C), g (1, Gin), x_mask, the pre-ceil durations (1, N_pad)
        at length_scale 1, in 100 Hz frames)."""
        x_mask = feature_mask(torch.tensor([n], device=ids.device), ids.shape[1])
        m_mask = torch.ones(1, mel.shape[1], 1, device=mel.device)
        g = self.emb_g(mel, m_mask)
        x = self.enc_p(ids, tone, lang, x_mask)
        mel_enc = self.mel_encoder(mel, m_mask)
        am = (x_mask[:, None, :, 0:1] * m_mask[:, None, None, :, 0]).bool()
        x = x + self.mha(x, mel_enc, am) + self.cond_g(g)[:, None, :]
        logw = self.duration_predictor(x, x_mask, g)
        return x, g, x_mask, (torch.exp(logw) * x_mask)[..., 0]

    def latent(self, x, dur, n, frames_budget):
        """x_frame (1, T, C) at T = ceil(frames_budget / 2) 50 Hz frames
        from the integer 100 Hz durations dur (1, N_pad)."""
        rng = self.RangePredictor(x, dur, n)
        rng = torch.clamp(torch.minimum(rng, dur * 2), min=1e-5)
        return self.dur_downsample(gaussian_upsample(x, dur, rng, n, frames_budget))

    def w2v_lf0(self, x_frame, g, codes, frame_mask):
        """codes (1, T) -> (w2v (1, T, 1024), log-f0 (1, 4T) after the
        pitch clip)."""
        x_frame = x_frame + self.ssl_proj(self.quantizer.decode(codes))
        x2v = self.w2v_encoder(x_frame, frame_mask, g)
        w2v = self.w2v_decoder(x2v, frame_mask, g)
        lf0 = self.pp(w2v, g)[..., 0]
        return w2v, torch.where(lf0 < LF0_FLOOR, torch.zeros_like(lf0), lf0)


# ---------------- prosody LM ----------------


def sine_positions(t, dim, device):
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * -(math.log(10000.0) / dim))
    pe = torch.zeros(t, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


class _PLMAttn(nn.Module):
    def __init__(self, d, heads):
        super().__init__()
        self.heads = heads
        self.w_q, self.w_k, self.w_v = Linear(d, d), Linear(d, d), Linear(d, d)
        self.out_proj = nn.Sequential(Linear(d, d))


class _PLMLayer(nn.Module):
    def __init__(self, d, ff, heads):
        super().__init__()
        self.norm1, self.norm2 = LayerNorm(d), LayerNorm(d)
        self.attn = _PLMAttn(d, heads)
        self.ff = nn.Sequential(Linear(d, ff), nn.ReLU(), nn.Identity(),
                                Linear(ff, d))

    def forward(self, x, bias):
        b, t, d = x.shape
        a = self.attn
        hd = d // a.heads
        y = self.norm1(x)
        q, k, v = (m(y).view(b, t, a.heads, hd).transpose(1, 2)
                   for m in (a.w_q, a.w_k, a.w_v))
        s = matmul(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias
        att = matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, t, d)
        x = x + a.out_proj[0](att)
        return x + self.ff(self.norm2(x))


class _PosEmb(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1))


class PLM(nn.Module):
    """Causal prosody LM over [text latent, previous code's embedding]."""

    def __init__(self, cfg: dict):
        super().__init__()
        d = cfg["vq_dim"] + cfg["tc_latent_dim"]
        self.bins = cfg["vq_bins"]
        self.pc_embedding = nn.Embedding(self.bins + 2, cfg["vq_dim"])
        self.pos_emb = _PosEmb()
        self.plm = nn.Module()
        self.plm.layers = nn.ModuleList(
            _PLMLayer(d, cfg["ff_mult"] * d, cfg["n_heads"])
            for _ in range(cfg["n_layers"]))
        self.predict_layer = Linear(d, self.bins, bias=False)

    def logits(self, latent, codes):
        """Teacher-forced: latent (1, T, 256), codes (1, T) fed back as
        [go, codes[:-1]] -> (1, T, bins)."""
        t = latent.shape[1]
        go = torch.full((1, 1), self.bins, dtype=torch.long, device=codes.device)
        emb = self.pc_embedding(torch.cat([go, codes[:, :-1].long()], dim=1))
        x = torch.cat([latent, emb], dim=-1)
        x = x + self.pos_emb.alpha * sine_positions(t, x.shape[-1], x.device)
        pos = torch.arange(t, device=x.device)
        bias = torch.where(pos[None, :] <= pos[:, None], 0.0, -1e9)[None, None]
        for layer in self.plm.layers:
            x = layer(x, bias)
        return self.predict_layer(x)


# ---------------- vocoder ----------------


class PosteriorSF(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h, out, gin = cfg["hidden_channels"], cfg["inter_channels"], cfg["gin_channels"]
        half = cfg["posterior_wn_layers"] // 2
        self.out = out
        self.pre_source = Conv1d(cfg["w2v_dim"], h, 1)
        self.pre_filter = Conv1d(1, h, 9, stride=4, padding=4)
        self.source_enc = WN(h, 5, 1, half, gin)
        self.filter_enc = WN(h, 5, 1, half, gin)
        self.enc = WN(h, 5, 1, half, gin)
        self.proj = Conv1d(h, 2 * out, 1)

    def forward(self, w2v, lf0, mask, g):
        g2 = g[:, None, :]
        src = self.source_enc(self.pre_source(w2v) * mask, mask, g2)
        ftr = self.filter_enc(self.pre_filter(lf0) * mask, mask, g2)
        stats = self.proj(self.enc(src + ftr, mask, g2)) * mask
        return stats[..., :self.out], stats[..., self.out:]


class SourceNetwork(nn.Module):
    kernels = (3, 5, 7)

    def __init__(self, uic, cin, gin):
        super().__init__()
        self.conv_pre = WNConv1d(cin, uic, 7, padding=3)
        self.cond = Conv1d(gin, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i in range(2):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, 4, 2, 1))
            for k in self.kernels:
                self.resblocks.append(AMPBlock(ch, k))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, z, g):
        y = self.conv_pre(z) + self.cond(g)[:, None, :]
        n = len(self.kernels)
        for i, up in enumerate(self.ups):
            y = block_mean(self.resblocks[i * n:(i + 1) * n], up(y))
        return self.activation_post(y)


def interp_linear(x, out_len):
    """F.interpolate(mode='linear', align_corners=False) on (B, T, C), the
    source positions taken exactly from the rational ratio."""
    t = x.shape[1]
    if out_len == t:
        return x
    num, den = out_len // gcd(out_len, t), t // gcd(out_len, t)
    pos = (np.arange(out_len, dtype=np.float64) + 0.5) * den / num - 0.5
    pos = np.clip(pos, 0, t - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, t - 1)
    w = torch.from_numpy(pos - lo).to(x.device, x.dtype)[None, :, None]
    lo, hi = (torch.from_numpy(v).to(x.device) for v in (lo, hi))
    return x[:, lo] * (1 - w) + x[:, hi] * w


class DBlock(nn.Module):
    def __init__(self, cin, hidden, factor):
        super().__init__()
        self.factor = factor
        self.residual_dense = WNConv1d(cin, hidden, 1)
        self.conv = nn.ModuleList(
            WNConv1d(cin if i == 0 else hidden, hidden, 3, dilation=d, padding=d)
            for i, d in enumerate((1, 2, 4)))

    def forward(self, x):
        size = x.shape[1] // self.factor
        res = interp_linear(self.residual_dense(x), size)
        y = interp_linear(x, size)
        for conv in self.conv:
            y = conv(leaky_relu(y))
        return y + res


class Generator(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        uic, gin = cfg["upsample_initial_channel"], cfg["gin_channels"]
        self.ks = tuple(cfg["resblock_kernel_sizes"])
        dils = [tuple(d) for d in cfg["resblock_dilation_sizes"]]
        pitch = uic // 8
        self.conv_pre = WNConv1d(cfg["inter_channels"], uic, 7, padding=3)
        self.downs = DBlock(pitch, uic, 4)
        self.cond = Conv1d(gin, uic, 1)
        self.proj = Conv1d(pitch, uic // 2, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                       cfg["upsample_kernel_sizes"])):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, k, u, (k - u) // 2))
            for rk, rd in zip(self.ks, dils):
                self.resblocks.append(AMPBlock(ch, rk, rd))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, z, e, g):
        y = self.conv_pre(z) + self.downs(e) + self.cond(g)[:, None, :]
        n = len(self.ks)
        for i, up in enumerate(self.ups):
            y = up(y)
            if i == 0:
                y = y + self.proj(e)
            y = block_mean(self.resblocks[i * n:(i + 1) * n], y)
        return torch.tanh(self.conv_post(self.activation_post(y)))


class Vocoder(nn.Module):
    """HierSpeech++ serving members at the configuration's `vocoder`
    widths."""

    def __init__(self, cfg: dict):
        super().__init__()
        ic, h, gin = cfg["inter_channels"], cfg["hidden_channels"], cfg["gin_channels"]
        self.enc_p_l = PosteriorSF(cfg)
        self.flow_l = FlowDiT(ic, h, cfg["flow_layers"], cfg["n_flows"], gin)
        self.flow = FlowDiT(ic, h, cfg["flow_layers"], cfg["n_flows"], gin)
        self.dec = Generator(cfg)
        self.sn = SourceNetwork(cfg["upsample_initial_channel"] // 2, ic, gin)
        self.emb_g = StyleEncoder(cfg["n_mels"], cfg["style_hidden"], gin)

    def style(self, mel):
        """The style of a prompt's true-length mel (1, T, 80)."""
        return self.emb_g(mel, torch.ones(*mel.shape[:2], 1, device=mel.device))

    def forward(self, w2v, mask, lf0, g, noise, noise_scale):
        """w2v (1, T, 1024), mask (1, T, 1), lf0 (1, 4T, 1), g (1, Gin),
        noise N(0, 1) of (1, T, C) -> (1, 320 T, 1)."""
        m, logs = self.enc_p_l(w2v, lf0, mask, g)
        z = (m + noise * torch.exp(logs) * noise_scale) * mask
        z = self.flow.reverse(self.flow_l.reverse(z, mask, g), mask, g)
        return self.dec(z, self.sn(z, g), g)


class SpeechSR(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        ch = cfg["upsample_initial_channel"]
        self.num, self.den = cfg["rate_num"], cfg["rate_den"]
        self.conv_pre = WNConv1d(1, ch, 7, padding=3)
        self.resblocks = nn.ModuleList(
            AMPBlock(ch, k, tuple(d)) for k, d in
            zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]))
        self.activation_post = AASnakeBeta(ch)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x):
        y = self.conv_pre(x)
        y = interp_linear(y, y.shape[1] * self.num // self.den)
        y = self.activation_post(block_mean(self.resblocks, y))
        return torch.tanh(self.conv_post(y))


def mel_frames(audio: torch.Tensor, n_mels: int = 80) -> torch.Tensor:
    """(T,) 16 kHz -> (1, F - 1, 80) log-mel: torchaudio's MelSpectrogram
    (n_fft 1280, hop 320, periodic Hann, center, reflect, power 2, HTK
    filterbank 0-8 kHz, no norm), log(mel + 1e-3), the last frame dropped."""
    n_fft, hop, sr = 1280, 320, 16000
    win = torch.hann_window(n_fft, periodic=True, dtype=torch.float64)
    y = F.pad(audio.double()[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0]
    spec = torch.stft(y, n_fft, hop, n_fft, win.to(audio.device), center=False,
                      return_complex=True)
    p2 = spec.real.square() + spec.imag.square()          # (1, freqs, F)
    to_mel = lambda f: 2595.0 * np.log10(1.0 + f / 700.0)   # noqa: E731
    m = np.linspace(to_mel(0.0), to_mel(8000.0), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    slopes = f_pts[None, :] - freqs[:, None]
    fd = np.diff(f_pts)
    fb = np.maximum(0.0, np.minimum(-slopes[:, :-2] / fd[:-1], slopes[:, 2:] / fd[1:]))
    mel = torch.matmul(p2.transpose(1, 2), torch.from_numpy(fb).to(audio.device))
    return torch.log(mel + 1e-3)[:, :-1].float()
