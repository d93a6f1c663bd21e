"""MegaTTS2-style acoustic model (text -> wav2vec2 features and log-f0).

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
`plm_conv1/2`, `quantizer`, `ssl_proj`). The port runs at each request's
own length, so no shape carries padding beyond the batch's longest member.

The s2 trainer's methods (`forward`, `pre_vq_features`) and the s1
trainer's (`extract_tc_latent_code`), with `pooled_prosody_codes` and
`infer_gt_dur` (the s2 eval hook), are the JAX TTVModel's. Dropout sits
where the JAX package has it (p 0.2 in the text, mel and w2v encoders and
the MRTE attention, 0.1 in the style encoder and the W2V decoder's WN, 0.5
in the duration predictor); it draws only in a training build's train()
mode under an active nn/basic.MaskSource.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.data import text as text_frontend
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
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.utils.masking import feature_mask
from megatts2_hierspeechpp_torch.utils.profiling import annotate


class TextEncoder(nn.Module):
    p_dropout = 0.2

    def __init__(self, n_vocab: int, n_tone: int, n_language: int,
                 hidden_channels: int = 256, filter_channels: int = 1024,
                 n_heads: int = 4, n_layers: int = 3, kernel_size: int = 9,
                 dtype=None):
        super().__init__()
        h = hidden_channels
        self.scale, self.dtype = math.sqrt(h), dtype
        self.emb = Embed(n_vocab, h)
        self.emb_tone = Embed(n_tone, h)
        self.emb_language = Embed(n_language, h)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size,
                               p_dropout=self.p_dropout, dtype=dtype)
        self.encoder2 = Encoder(h, filter_channels, n_heads, 1, kernel_size,
                                p_dropout=self.p_dropout, dtype=dtype)

    def forward(self, x_ids, tone, language, x_mask):
        x = (self.emb(x_ids) * self.scale + self.emb_tone(tone) * self.scale
             + self.emb_language(language) * self.scale)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.encoder(x * x_mask, x_mask)
        return self.encoder2(x * x_mask, x_mask)


class MelEncoder(nn.Module):
    p_dropout = 0.2

    def __init__(self, out_channels: int = 256, hidden_channels: int = 80,
                 filter_channels: int = 320, n_heads: int = 4,
                 n_layers: int = 2, kernel_size: int = 9, dtype=None):
        super().__init__()
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size, p_dropout=self.p_dropout,
                               dtype=dtype)
        self.proj = Conv1d(hidden_channels, out_channels, 1, dtype=dtype)

    def forward(self, mel, mel_mask):
        return self.proj(self.encoder(mel * mel_mask, mel_mask)) * mel_mask


class W2VEncoder(nn.Module):
    p_dropout = 0.2

    def __init__(self, hidden_channels: int = 256, filter_channels: int = 1024,
                 n_heads: int = 4, n_layers: int = 3, kernel_size: int = 9,
                 gin_channels: int = 256, dtype=None):
        super().__init__()
        h = hidden_channels
        self.cond = Conv1d(gin_channels, h, 1, dtype=dtype)
        self.encoder = Encoder(h, filter_channels, n_heads, n_layers, kernel_size,
                               p_dropout=self.p_dropout, dtype=dtype)
        self.encoder2 = Encoder(h, filter_channels, n_heads, 1, kernel_size,
                                p_dropout=self.p_dropout, dtype=dtype)

    def forward(self, x, x_mask, g):
        x = x + self.cond(g)[:, None, :]
        x = self.encoder(x * x_mask, x_mask)
        return self.encoder2(x * x_mask, x_mask)


class W2VDecoder(nn.Module):
    p_dropout = 0.1

    def __init__(self, in_channels: int = 256, hidden_channels: int = 512,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 8, output_size: int = 1024,
                 gin_channels: int = 256, dtype=None):
        super().__init__()
        self.pre = Conv1d(in_channels, hidden_channels, 1, dtype=dtype)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels, self.p_dropout, dtype)
        self.proj = Conv1d(hidden_channels, output_size, 1, dtype=dtype)

    def forward(self, x, x_mask, g):
        y = self.pre(x * x_mask) * x_mask
        y = self.enc(y, x_mask, g[:, None, :])
        return self.proj(y) * x_mask


class PitchPredictor(nn.Module):
    """HiFiGAN-style mini-generator: w2v (50 Hz) -> log-f0 (200 Hz)."""

    resblock_kernels = (3, 5, 7)

    def __init__(self, initial_channel: int = 1024,
                 upsample_initial_channel: int = 256, gin_channels: int = 256,
                 dtype=None):
        super().__init__()
        uic = upsample_initial_channel
        self.conv_pre = Conv1d(initial_channel, uic, 7, padding=3, dtype=dtype)
        self.cond = Conv1d(gin_channels, uic, 1, dtype=dtype)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i in range(2):
            ch = uic // 2 ** (i + 1)
            self.ups.append(WNConvTranspose1d(2 * ch, ch, 4, stride=2, padding=1,
                                              dtype=dtype))
            for rk in self.resblock_kernels:
                self.resblocks.append(ResBlock1(ch, rk, (1, 3, 5), dtype))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, dtype=dtype)

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
    def __init__(self, hidden_channels: int = 20, dtype=None):
        super().__init__()
        self.conv1 = Conv1d(hidden_channels, hidden_channels, 5, padding=2,
                            dtype=dtype)
        self.conv2 = Conv1d(hidden_channels, hidden_channels, 5, padding=2,
                            dtype=dtype)

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
    """SynthesizerTrn equivalent (acoustic stage).

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent). A serving build
    (the default) is frozen in eval() mode; `train=True` leaves the
    parameters trainable (but the LSTMs' bias_hh, nn/lstm.py) and the
    module in train() mode (the same members and the same seeded weights:
    the TTV has no training-only member).

    `dtype` (None: float32) is the JAX TTVModel's compute dtype, handed to
    every member but the quantizer: the convs, projections and attention
    products take their operands in it, the parameters stay float32, and
    the LSTMs, LayerNorm statistics, RVQ and Gaussian upsampling stay
    float32. Between modules the tensors take the dtype the JAX dataflow
    promotes them to: a bf16 result times a float32 mask is float32, so
    the encoders' outputs, w2v_pred and the log-f0 are float32, while the
    latent x_frame (the PLM's input) and the pitch predictor's stack are
    bf16."""

    def __init__(self, n_vocab: int = 200, n_tone: int = 10,
                 n_language: int = 3, inter_channels: int = 256,
                 hidden_channels: int = 256, gin_channels: int = 256,
                 prosody_size: int = 20, vq_bins: int = 1024, stride: int = 8,
                 text_layers: int = 3, mel_enc_layers: int = 2,
                 w2v_enc_layers: int = 3, w2v_dec_layers: int = 8,
                 seed: int = 0, device: str | torch.device = "cuda",
                 train: bool = False, dtype=None):
        super().__init__()
        dev = resolve_device(device)
        ic = inter_channels
        self.prosody_size, self.stride, self.dtype = prosody_size, stride, dtype
        self.enc_p = TextEncoder(n_vocab, n_tone, n_language, ic, 4 * ic, 4,
                                 text_layers, 9, dtype)
        self.mel_encoder = MelEncoder(256, 80, 320, 4, mel_enc_layers, 9, dtype)
        self.mha = MultiHeadAttention(ic, ic, 4, p_dropout=0.2, dtype=dtype)
        self.cond_g = Conv1d(gin_channels, ic, 1, dtype=dtype)
        self.w2v_encoder = W2VEncoder(ic, 4 * ic, 4, w2v_enc_layers, 9,
                                      gin_channels, dtype)
        self.w2v_decoder = W2VDecoder(ic, 2 * ic, 5, 1, w2v_dec_layers, 1024,
                                      256, dtype)
        self.emb_g = StyleEncoder(80, 256, 256, dtype)
        self.duration_predictor = DurationPredictor(ic, 256, gin_channels, dtype)
        # attribute name as in the reference checkpoint
        self.RangePredictor = RangePredictor(ic, 256, dtype)
        self.dur_downsample = Conv1d(ic, hidden_channels, 1, stride=2,
                                     dtype=dtype)
        self.pp = PitchPredictor(1024, 256, gin_channels, dtype)
        self.plm_conv1 = PLMConv(prosody_size, dtype)
        self.plm_conv2 = PLMConv(prosody_size, dtype)
        self.quantizer = ResidualVectorQuantizer(prosody_size, 1, vq_bins)
        self.ssl_proj = Conv1d(prosody_size, ic, 1, dtype=dtype)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

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
        frames at 100 Hz. The span ttv.durations."""
        with annotate("ttv.durations"):
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

    def pre_vq_features(self, mel, mel_lengths):
        """The quantizer's input (plm_conv1 -> max-pool 8 -> plm_conv2) and
        its mask: (B, T // 8, 20), (B, T // 8, 1). k-means fits the
        codebooks on these (cli/train_s2.py)."""
        mel_len = mel.shape[1]
        mel_mask = feature_mask(mel_lengths, mel_len)
        pool_mask = feature_mask(torch.ceil(mel_lengths / 8).long(),
                                 mel_len // 8)
        m = self.plm_conv1(mel[..., :self.prosody_size].float(), mel_mask)
        return self.plm_conv2(max_pool8(m), pool_mask), pool_mask

    def _prosody_codes(self, mel, mel_lengths):
        """mel (B, T, 80) -> RVQ codes (n_q, B, T // 8)."""
        return self.quantizer.encode(self.pre_vq_features(mel, mel_lengths)[0])

    # ---------- training (the s2 and s1 trainers) ----------

    def forward(self, x_ids, tone, language, x_lengths, w2v, w2v_lengths,
                mel, mel_lengths, pitch, pitch_lengths, dur, mrte_mel,
                mrte_mel_lengths, teacher_force_w2v=True,
                train_vq: bool = False):
        """The s2 training forward (JAX TTVModel.__call__). dur (B, N) are
        the ground-truth 100 Hz frame counts; `teacher_force_w2v` (a bool
        or a 0-d bool tensor) feeds the pitch predictor the ground-truth
        w2v, else the prediction; `train_vq` takes one EMA step of the
        codebooks (in place) and makes the quantizer straight-through.
        Returns the JAX dict: l_length, l_pitch, pred_lf0 (B, 4T), w2v_pred
        (B, T, 1024), commit_loss, codes (n_q, B, T // 8), y_mask, x_mask."""
        mel_len = mel.shape[1]
        x_mask = feature_mask(x_lengths, x_ids.shape[1])
        mel_mask = feature_mask(mel_lengths, mel_len)
        mrte_mask = feature_mask(mrte_mel_lengths, mrte_mel.shape[1])
        pitch_mask = feature_mask(pitch_lengths, pitch.shape[1])

        g = self.emb_g(mrte_mel, mrte_mask)
        x = self._text_mrte(x_ids, tone, language, x_mask, mrte_mel,
                            mrte_mask, g)
        # log-domain MSE against the ground-truth durations
        logw_ = torch.log(dur.float() + 1)[:, :, None] * x_mask
        logw = self.duration_predictor(x, x_mask, g)
        # a data-parallel step's share of the global batch's masked mean
        l_length = ((logw - logw_).square().sum()
                    / mesh.share_denominator(x_mask.sum()))

        x_frame = self._upsample_to_frames(x, dur, x_lengths, 2 * mel_len)
        x_frame = x_frame[:, :mel_len]
        m, _ = self.pre_vq_features(mel, mel_lengths)
        quantized, codes, commit_loss = self.quantizer(m, train=train_vq)
        q_up = upsample_codes(quantized, self.stride, mel_len) * mel_mask
        x_frame = x_frame + self.ssl_proj(q_up) * mel_mask

        y_mask = feature_mask(w2v_lengths, w2v.shape[1])
        x2v = self.w2v_encoder(x_frame, y_mask, g)
        w2v_pred = self.w2v_decoder(x2v, y_mask, g)
        if isinstance(teacher_force_w2v, bool):
            pp_in = w2v if teacher_force_w2v else w2v_pred
        else:
            pp_in = torch.where(teacher_force_w2v, w2v, w2v_pred)
        pred_lf0 = self.pp(pp_in, g)[..., 0] * pitch_mask[..., 0]
        lf0 = torch.log(pitch.float() + 1)
        l_pitch = (pred_lf0 - lf0).abs().mean()
        return {"l_length": l_length, "l_pitch": l_pitch,
                "pred_lf0": pred_lf0, "w2v_pred": w2v_pred,
                "commit_loss": commit_loss, "codes": codes,
                "y_mask": y_mask, "x_mask": x_mask}

    def extract_tc_latent_code(self, x_ids, tone, language, x_lengths, mel,
                               mel_lengths, dur, mrte_mel, mrte_mel_lengths):
        """The s1 trainer's inputs from ground-truth durations: (x_frame
        (B, T, 256), frame-rate code ids (B, T) int32, 0 past each length)."""
        mel_len = mel.shape[1]
        x_mask = feature_mask(x_lengths, x_ids.shape[1])
        mel_mask = feature_mask(mel_lengths, mel_len)
        mrte_mask = feature_mask(mrte_mel_lengths, mrte_mel.shape[1])
        g = self.emb_g(mrte_mel, mrte_mask)
        x = self._text_mrte(x_ids, tone, language, x_mask, mrte_mel,
                            mrte_mask, g)
        x_frame = self._upsample_to_frames(x, dur, x_lengths, 2 * mel_len)
        x_frame = x_frame[:, :mel_len]
        codes = self._prosody_codes(mel, mel_lengths)
        lr = upsample_codes(codes[0][..., None], self.stride, mel_len)[..., 0]
        return x_frame, (lr * mel_mask[..., 0]).int()

    def pooled_prosody_codes(self, mel, mel_lengths):
        """mel (B, T, 80) -> RVQ code ids at the pooled rate (B, T // 8)
        int32."""
        return self._prosody_codes(mel, mel_lengths)[0].int()

    def extract_latent(self, x):
        """Mel-pooled features (B, T, 20) -> RVQ codes (B, n_q, T) int32
        (JAX TTVModel.extract_latent)."""
        return self.quantizer.encode(x).transpose(0, 1).int()

    def infer_gt_dur(self, x_ids, tone, language, x_lengths, mel, mel_lengths,
                     dur, mrte_mel=None, mrte_mel_lengths=None):
        """Inference from ground-truth durations with the mel's own prosody
        codes (the s2 eval hook): (w2v_pred (B, T, 1024), pred_lf0
        (B, 4T)). The style vector comes from `mel` itself."""
        mel_len = mel.shape[1]
        x_mask = feature_mask(x_lengths, x_ids.shape[1])
        mel_mask = feature_mask(mel_lengths, mel_len)
        g = self.emb_g(mel, mel_mask)
        if mrte_mel is None:
            mrte_mel, mrte_mel_lengths = mel, mel_lengths
        mrte_mask = feature_mask(mrte_mel_lengths, mrte_mel.shape[1])
        x = self._text_mrte(x_ids, tone, language, x_mask, mrte_mel,
                            mrte_mask, g)
        x_frame = self._upsample_to_frames(x, dur, x_lengths, 2 * mel_len)
        x_frame = x_frame[:, :mel_len]
        quantized = self.quantizer.decode(self._prosody_codes(mel, mel_lengths))
        q_up = upsample_codes(quantized, self.stride, mel_len) * mel_mask
        x_frame = x_frame + self.ssl_proj(q_up) * mel_mask
        x2v = self.w2v_encoder(x_frame, mel_mask, g)
        w2v_pred = self.w2v_decoder(x2v, mel_mask, g)
        return w2v_pred, self.pp(w2v_pred, g)[..., 0]

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


DEPTH_KEYS = ("text_layers", "mel_enc_layers", "w2v_enc_layers",
              "w2v_dec_layers")


def build_ttv(hps, device, seed: int, train: bool, dtype=None) -> TTVModel:
    """The TTVModel of a config: the published widths, the depths of its
    model.* keys where present, compute in `dtype`."""
    depth = {k: hps.model[k] for k in DEPTH_KEYS if k in hps.model}
    return TTVModel(n_vocab=text_frontend.N_VOCAB, n_tone=text_frontend.N_TONE,
                    n_language=text_frontend.N_LANGUAGE, seed=seed,
                    device=device, train=train, dtype=dtype, **depth)
