"""MegaTTS2-style acoustic model (text -> wav2vec2 features and log-f0),
inference path.

Counterpart of `megatts2_hierspeechpp_tpu/models/ttv.py` (reference
ttv_v1/t2w2v_transformer.py SynthesizerTrn):

  text + tone + language --TextEncoder--> x (B, N, 256)         phone rate
  prompt mel --MelEncoder--> keys; cross-attention (mha) adds the prompt
  context, cond_g the global style g = emb_g(prompt mel)
  durations --RangePredictor + Gaussian upsampling--> 100 Hz
  --dur_downsample (k=1, stride 2)--> x_frame at 50 Hz
  prosody codes --RVQ decode--> ssl_proj, added to x_frame
  --W2VEncoder / W2VDecoder (WN)--> w2v (B, T, 1024)
  --PitchPredictor--> log-f0 at 200 Hz (B, 4T)

Parameter names are the reference checkpoint's (`enc_p`, `mel_encoder`,
`mha`, `cond_g`, `w2v_encoder`, `w2v_decoder`, `emb_g`,
`duration_predictor`, `RangePredictor`, `dur_downsample`, `pp`,
`plm_conv1/2`, `quantizer`, `ssl_proj`). The training forward is not
ported. The port runs at each request's own length, so no shape carries
padding beyond the batch's longest member.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.attention import Encoder, MultiHeadAttention
from megatts2_hierspeechpp_torch.nn.basic import Embed, leaky_relu
from megatts2_hierspeechpp_torch.nn.conv import Conv1d, WNConvTranspose1d
from megatts2_hierspeechpp_torch.nn.duration import (
    DurationPredictor,
    RangePredictor,
    gaussian_upsample,
)
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.nn.quantize import ResidualVectorQuantizer
from megatts2_hierspeechpp_torch.nn.resblocks import ResBlock1
from megatts2_hierspeechpp_torch.nn.styleencoder import StyleEncoder
from megatts2_hierspeechpp_torch.nn.wavenet import WN
from megatts2_hierspeechpp_torch.utils.masking import feature_mask


class TextEncoder(nn.Module):
    def __init__(self, n_vocab: int, n_tone: int, n_language: int,
                 hidden_channels: int = 256, filter_channels: int = 1024,
                 n_heads: int = 4, n_layers: int = 3, kernel_size: int = 9):
        super().__init__()
        h = hidden_channels
        self.scale = math.sqrt(h)
        self.emb = Embed(n_vocab, h)
        self.emb_tone = Embed(n_tone, h)
        self.emb_language = Embed(n_language, h)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size)
        self.encoder2 = Encoder(h, filter_channels, n_heads, 1, kernel_size)

    def forward(self, x_ids, tone, language, x_mask):
        x = (self.emb(x_ids) * self.scale + self.emb_tone(tone) * self.scale
             + self.emb_language(language) * self.scale)
        x = self.encoder(x * x_mask, x_mask)
        return self.encoder2(x * x_mask, x_mask)


class MelEncoder(nn.Module):
    def __init__(self, out_channels: int = 256, hidden_channels: int = 80,
                 filter_channels: int = 320, n_heads: int = 4,
                 n_layers: int = 2, kernel_size: int = 9):
        super().__init__()
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels, 1)

    def forward(self, mel, mel_mask):
        return self.proj(self.encoder(mel * mel_mask, mel_mask)) * mel_mask


class W2VEncoder(nn.Module):
    def __init__(self, hidden_channels: int = 256, filter_channels: int = 1024,
                 n_heads: int = 4, n_layers: int = 3, kernel_size: int = 9,
                 gin_channels: int = 256):
        super().__init__()
        h = hidden_channels
        self.cond = Conv1d(gin_channels, h, 1)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size)
        self.encoder2 = Encoder(h, filter_channels, n_heads, 1, kernel_size)

    def forward(self, x, x_mask, g):
        x = x + self.cond(g)[:, None, :]
        x = self.encoder(x * x_mask, x_mask)
        return self.encoder2(x * x_mask, x_mask)


class W2VDecoder(nn.Module):
    def __init__(self, in_channels: int = 256, hidden_channels: int = 512,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 8, output_size: int = 1024,
                 gin_channels: int = 256):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels)
        self.proj = Conv1d(hidden_channels, output_size, 1)

    def forward(self, x, x_mask, g):
        y = self.pre(x * x_mask) * x_mask
        y = self.enc(y, x_mask, g[:, None, :])
        return self.proj(y) * x_mask


class PitchPredictor(nn.Module):
    """HiFiGAN-style mini-generator: w2v (50 Hz) -> log-f0 (200 Hz)."""

    resblock_kernels = (3, 5, 7)

    def __init__(self, initial_channel: int = 1024,
                 upsample_initial_channel: int = 256, gin_channels: int = 256):
        super().__init__()
        uic = upsample_initial_channel
        self.conv_pre = Conv1d(initial_channel, uic, 7, padding=3)
        self.cond = Conv1d(gin_channels, uic, 1)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i in range(2):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, 4, stride=2, padding=1))
            for rk in self.resblock_kernels:
                self.resblocks.append(ResBlock1(ch, rk, (1, 3, 5)))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)

    def forward(self, x, g):
        """x: (B, T, 1024); g: (B, Gin) -> (B, 4T, 1)."""
        y = self.conv_pre(x) + self.cond(g)[:, None, :]
        n = len(self.resblock_kernels)
        for i, up in enumerate(self.ups):
            y = up(leaky_relu(y))
            y = sum(b(y) for b in self.resblocks[i * n:(i + 1) * n]) / 3.0
        # the last activation uses torch's default slope
        return self.conv_post(leaky_relu(y, 0.01))


class PLMConv(nn.Module):
    def __init__(self, hidden_channels: int = 20):
        super().__init__()
        self.conv1 = Conv1d(hidden_channels, hidden_channels, 5, padding=2)
        self.conv2 = Conv1d(hidden_channels, hidden_channels, 5, padding=2)

    def forward(self, x, mask):
        x = self.conv1(x * mask)
        return self.conv2(x * mask) * mask


def max_pool8(x):
    """MaxPool1d(8, 8) on (B, T, C); T truncated to a multiple of 8."""
    b, t, c = x.shape
    t8 = t // 8 * 8
    return x[:, :t8].reshape(b, t8 // 8, 8, c).amax(dim=2)


def upsample_codes(x, stride: int, out_len: int):
    """Repeat code frames `stride` times along T and truncate to out_len."""
    return torch.repeat_interleave(x, stride, dim=1)[:, :out_len]


class TTVModel(nn.Module):
    """SynthesizerTrn equivalent (acoustic stage), inference methods.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent)."""

    def __init__(self, n_vocab: int = 200, n_tone: int = 10,
                 n_language: int = 3, inter_channels: int = 256,
                 hidden_channels: int = 256, gin_channels: int = 256,
                 prosody_size: int = 20, vq_bins: int = 1024, stride: int = 8,
                 text_layers: int = 3, mel_enc_layers: int = 2,
                 w2v_enc_layers: int = 3, w2v_dec_layers: int = 8,
                 seed: int = 0, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        ic = inter_channels
        self.prosody_size, self.stride = prosody_size, stride
        self.enc_p = TextEncoder(n_vocab, n_tone, n_language, ic, 4 * ic, 4,
                                 text_layers, 9)
        self.mel_encoder = MelEncoder(256, 80, 320, 4, mel_enc_layers, 9)
        self.mha = MultiHeadAttention(ic, ic, 4)
        self.cond_g = Conv1d(gin_channels, ic, 1)
        self.w2v_encoder = W2VEncoder(ic, 4 * ic, 4, w2v_enc_layers, 9,
                                      gin_channels)
        self.w2v_decoder = W2VDecoder(ic, 2 * ic, 5, 1, w2v_dec_layers, 1024,
                                      256)
        self.emb_g = StyleEncoder(80, 256, 256)
        self.duration_predictor = DurationPredictor(ic, 256, gin_channels)
        # attribute name as in the reference checkpoint
        self.RangePredictor = RangePredictor(ic, 256)
        self.dur_downsample = Conv1d(ic, hidden_channels, 1, stride=2)
        self.pp = PitchPredictor(1024, 256, gin_channels)
        self.plm_conv1 = PLMConv(prosody_size)
        self.plm_conv2 = PLMConv(prosody_size)
        self.quantizer = ResidualVectorQuantizer(prosody_size, 1, vq_bins)
        self.ssl_proj = Conv1d(prosody_size, ic, 1)
        init_weights(self, seed)
        self.eval().requires_grad_(False).to(dev)

    # ---------- shared sub-paths ----------

    def _text_mrte(self, x_ids, tone, language, x_mask, mrte_mel, mrte_mask, g):
        x = self.enc_p(x_ids, tone, language, x_mask)
        mel_enc = self.mel_encoder(mrte_mel, mrte_mask)
        attn_mask = (x_mask[:, None, :, 0:1]
                     * mrte_mask[:, None, None, :, 0]).bool()
        return x + self.mha(x, mel_enc, attn_mask) + self.cond_g(g)[:, None, :]

    def _durations(self, x_ids, tone, language, x_lengths, mrte_mel,
                   mrte_mel_lengths, length_scale):
        """(x, g, x_mask, dur): text + MRTE + duration predictor; dur (B, N)
        frames at 100 Hz."""
        x_mask = feature_mask(x_lengths, x_ids.shape[1])
        mrte_mask = feature_mask(mrte_mel_lengths, mrte_mel.shape[1])
        g = self.emb_g(mrte_mel, mrte_mask)
        x = self._text_mrte(x_ids, tone, language, x_mask, mrte_mel,
                            mrte_mask, g)
        logw = self.duration_predictor(x, x_mask, g)
        dur = torch.ceil(torch.exp(logw) * x_mask * length_scale)[..., 0]
        return x, g, x_mask, dur

    def _upsample_to_frames(self, x, dur, x_lengths, out_length: int):
        rng = self.RangePredictor(x, dur, x_lengths)
        rng = torch.clamp(torch.minimum(rng, dur * 2), min=1e-5)
        x_frame = gaussian_upsample(x, dur, rng, x_lengths, out_length)
        return self.dur_downsample(x_frame)  # ceil(out_length / 2)

    def _prosody_codes(self, mel, mel_lengths):
        """mel (B, T, 80) -> RVQ codes (n_q, B, T // 8)."""
        mel_len = mel.shape[1]
        mel_mask = feature_mask(mel_lengths, mel_len)
        pool_mask = feature_mask(torch.ceil(mel_lengths / 8).long(),
                                 mel_len // 8)
        m = self.plm_conv1(mel[..., :self.prosody_size].float(), mel_mask)
        m = self.plm_conv2(max_pool8(m), pool_mask)
        return self.quantizer.encode(m)

    # ---------- inference ----------

    def predict_frame_lengths(self, x_ids, tone, language, x_lengths,
                              mrte_mel, mrte_mel_lengths,
                              length_scale: float = 1.0):
        """Duration-only pre-pass: predicted 50 Hz frame lengths (B,) int32."""
        _, _, x_mask, dur = self._durations(
            x_ids, tone, language, x_lengths, mrte_mel, mrte_mel_lengths,
            length_scale)
        total = (dur * x_mask[..., 0]).sum(dim=1)
        return torch.ceil(total / 2).int()

    def inf_extract_tc_latent(self, x_ids, tone, language, x_lengths, y_mel,
                              y_lengths, out_length: int, mrte_mel=None,
                              mrte_mel_lengths=None,
                              length_scale: float = 1.0):
        """-> (x_frame (B, ceil(out_length / 2), C), g, frame_lengths,
        frame_mask). out_length is the 100 Hz frame budget."""
        if mrte_mel is None:
            mrte_mel, mrte_mel_lengths = y_mel, y_lengths
        x, g, x_mask, dur = self._durations(
            x_ids, tone, language, x_lengths, mrte_mel, mrte_mel_lengths,
            length_scale)
        x_frame = self._upsample_to_frames(x, dur, x_lengths, out_length)
        total = (dur * x_mask[..., 0]).sum(dim=1)
        frame_lengths = torch.clamp(torch.ceil(total / 2).int(),
                                    max=x_frame.shape[1])
        return x_frame, g, frame_lengths, feature_mask(frame_lengths,
                                                       x_frame.shape[1])

    def inf_plm_gen(self, x_frame, g, codes, frame_mask):
        """codes (n_q, B, T) -> (w2v_pred (B, T, 1024), pred_lf0 (B, 4T))."""
        x_frame = x_frame + self.ssl_proj(self.quantizer.decode(codes))
        x2v = self.w2v_encoder(x_frame, frame_mask, g)
        w2v_pred = self.w2v_decoder(x2v, frame_mask, g)
        return w2v_pred, self.pp(w2v_pred, g)[..., 0]

    def prompt_codes(self, mel, mel_lengths):
        """Prompt-mel RVQ codes at mel frame rate (B, <= T) int32: the
        no-PLM path's prosody."""
        codes = self._prosody_codes(mel, mel_lengths)
        return upsample_codes(codes[0], self.stride, mel.shape[1]).int()
