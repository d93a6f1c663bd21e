"""Tortoise/XTTS-style GPT prosody stack (alternative PLM stack A, compact).

Counterpart of `megatts2_hierspeechpp_tpu/models/plm_gpt.py` (reference
plm/gpt.py, gpt_inference.py, latent_encoder.py, dvae.py, which the
reference keeps experimental and un-wired):

  - `ConditioningEncoder`: conv stem + attention blocks (GroupNorm of 32
    groups when the width divides, else 1) over a prompt mel, first-token
    readout;
  - `GPTProsody`: a pre-norm tanh-GELU causal decoder over [cond; text
    tokens; start, mel tokens] with learned positions and start / stop mel
    tokens; the CE loss over pos <= mel_len (targets after the length are
    the stop token); `gpt_generate` is the KV-cached sampler (prefill of
    [cond; text; start], top-k draws as jax.random.categorical, the
    Gumbel noise injectable as in ar/t2s.py (nn/decode.py), the stop token);
  - `DiscreteVAE`: strided conv encoder -> EMA codebook (nn/quantize
    EuclideanCodebook) -> transposed-conv decoder over mels; recon MSE +
    0.25 x commit with the straight-through estimator.

The reference has no state_dict names for this stack (the JAX package has
no converter for it), so the port's names follow the JAX tree: `h.{i}` for
h_{i}, `attn.{i}` for attn_{i}, `enc.{i}` / `dec.{i}` for enc_{i} / dec_{i},
torch's weight / bias for scale / bias; convert.gpt_prosody_from_jax and
convert.dvae_from_jax carry JAX params over. The JAX DVAE's dead-code draw
is overwritten by the same update's embed_avg / smoothed, so the port draws
nothing (as nn/quantize.py). Float32 throughout; built on the CPU with
seeded weights (nn/init.py; the learned positions N(0, 0.02^2), the DVAE's
embed_avg a copy of its codebook, as the JAX init), then moved to `device`
("cuda" by default; raises if CUDA is absent).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.conv import Conv1d, ConvTranspose1d
from megatts2_hierspeechpp_torch.nn.decode import (
    NEG_INF,
    attend,
    default_noise,
    merge_heads,
    sample_tokens,
    split_heads,
)
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.nn.quantize import EuclideanCodebook


class AttentionBlock(nn.Module):
    """GroupNorm + 1x1 qkv + attention + 1x1 projection + residual, on
    (B, T, C)."""

    def __init__(self, channels: int, n_heads: int = 8):
        super().__init__()
        self.n_heads = n_heads
        self.norm = nn.GroupNorm(32 if channels % 32 == 0 else 1, channels,
                                 eps=1e-6)
        self.qkv = Conv1d(channels, 3 * channels, 1)
        self.proj_out = Conv1d(channels, channels, 1)

    def forward(self, x):
        g = self.norm(x.transpose(1, 2)).transpose(1, 2)
        q, k, v = (split_heads(y, self.n_heads) for y in self.qkv(g).chunk(3, -1))
        return x + self.proj_out(merge_heads(attend(q, k, v)))


class ConditioningEncoder(nn.Module):
    """Prompt mel (B, T, n_mels) -> conditioning vector (B, C)."""

    def __init__(self, n_mels: int = 80, channels: int = 512, n_attn: int = 6,
                 n_heads: int = 8):
        super().__init__()
        self.init = Conv1d(n_mels, channels, 3, padding=1)
        self.attn = nn.ModuleList(AttentionBlock(channels, n_heads)
                                  for _ in range(n_attn))

    def forward(self, mel):
        x = self.init(mel)
        for blk in self.attn:
            x = blk(x)
        return x[:, 0]


class GPTBlock(nn.Module):
    """Pre-norm GPT-2 block with a tanh-GELU MLP."""

    def __init__(self, dim: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.ln_1 = nn.LayerNorm(dim)
        self.c_attn = nn.Linear(dim, 3 * dim)
        self.c_proj = nn.Linear(dim, dim)
        self.ln_2 = nn.LayerNorm(dim)
        self.mlp_fc = nn.Linear(dim, 4 * dim)
        self.mlp_proj = nn.Linear(4 * dim, dim)

    def qkv(self, x):
        return (split_heads(y, self.n_heads)
                for y in self.c_attn(self.ln_1(x)).chunk(3, -1))

    def mlp(self, x):
        """x plus attention -> the block's output."""
        return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x)),
                                        approximate="tanh"))

    def forward(self, x, bias):
        q, k, v = self.qkv(x)
        return self.mlp(x + self.c_proj(merge_heads(attend(q, k, v, bias))))


class GPTProsody(nn.Module):
    """Causal LM over [cond; text tokens; start, mel tokens, stop]."""

    def __init__(self, dim: int = 512, n_layers: int = 8, n_heads: int = 8,
                 n_text_tokens: int = 256, n_mel_tokens: int = 1024,
                 max_text: int = 402, max_mel: int = 604, n_mels: int = 80,
                 seed: int = 0, device: str | torch.device = "cuda",
                 train: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.dim, self.n_heads, self.n_mel_tokens = dim, n_heads, n_mel_tokens
        self.cond_encoder = ConditioningEncoder(n_mels, dim, 4, n_heads)
        self.text_emb = nn.Embedding(n_text_tokens, dim)
        self.mel_emb = nn.Embedding(n_mel_tokens + 2, dim)
        self.text_pos = nn.Parameter(torch.empty(max_text, dim))
        self.mel_pos = nn.Parameter(torch.empty(max_mel, dim))
        self.h = nn.ModuleList(GPTBlock(dim, n_heads) for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(dim)
        self.mel_head = nn.Linear(dim, n_mel_tokens + 2)
        init_weights(self, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for p in (self.text_pos, self.mel_pos):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    @property
    def start_mel(self) -> int:
        return self.n_mel_tokens

    @property
    def stop_mel(self) -> int:
        return self.n_mel_tokens + 1

    def assemble(self, cond_mel, text_ids, mel_in):
        cond = self.cond_encoder(cond_mel)[:, None]
        te = self.text_emb(text_ids.long()) + self.text_pos[:text_ids.shape[1]]
        me = self.mel_emb(mel_in.long()) + self.mel_pos[:mel_in.shape[1]]
        return torch.cat([cond, te, me], dim=1)

    def mel_logits(self, cond_mel, text_ids, mel_in):
        """The causal forward: logits at the mel positions (B, Nm, V), row j
        the prediction after mel_in[:, j]."""
        x = self.assemble(cond_mel, text_ids, mel_in)
        t = x.shape[1]
        causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        bias = torch.where(causal, 0.0, NEG_INF)
        for blk in self.h:
            x = blk(x, bias)
        return self.mel_head(self.ln_f(x)[:, 1 + text_ids.shape[1]:])

    def forward(self, cond_mel, text_ids, mel_tokens, mel_lens):
        """Training: CE over the mel tokens with start / stop framing;
        cond_mel (B, Tc, n_mels), text_ids (B, Nt), mel_tokens (B, Nm) ->
        {loss (mean over pos <= mel_len), logits (B, Nm + 1, V), targets}."""
        b, nm = mel_tokens.shape
        dev = mel_tokens.device
        tokens = mel_tokens.long()
        pos = torch.arange(nm + 1, device=dev)
        lens = mel_lens.to(dev)[:, None]
        start = torch.full((b, 1), self.start_mel, dtype=torch.long, device=dev)
        stop = torch.full((b, 1), self.stop_mel, dtype=torch.long, device=dev)
        targets = torch.where(pos[None] < lens, torch.cat([tokens, stop], 1),
                              self.stop_mel)
        logits = self.mel_logits(cond_mel, text_ids, torch.cat([start, tokens], 1))
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, targets[..., None])[..., 0]
        valid = (pos[None] <= lens).float()
        loss = (nll * valid).sum() / valid.sum().clamp_min(1)
        return {"loss": loss, "logits": logits, "targets": targets}


@torch.inference_mode()
def gpt_generate(model: GPTProsody, cond_mel, text_ids, max_new: int = 300,
                 top_k: int = 50, temperature: float = 1.0,
                 noise: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached sampling: prefill of [cond; text; start] once, then each
    step attends to the cache. -> (tokens (B, max_new) int64, the stop
    token after a row stops; lengths (B,) int32). `noise(shape)` gives each
    step's Gumbel draw (default: nn/decode.GumbelNoise seeded 0 on the
    device). Stops once every row has drawn the stop token."""
    dev = text_ids.device
    noise = default_noise(dev) if noise is None else noise
    b = text_ids.shape[0]
    start = torch.full((b, 1), model.start_mel, dtype=torch.long, device=dev)
    cur = model.assemble(cond_mel, text_ids, start)
    prefix = cur.shape[1]
    total = prefix + max_new
    h, hd = model.n_heads, model.dim // model.n_heads
    k_cache = torch.zeros(len(model.h), b, h, total, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)
    causal = torch.ones(prefix, prefix, dtype=torch.bool, device=dev).tril()
    bias = torch.where(causal, 0.0, NEG_INF)
    for i, blk in enumerate(model.h):
        q, k, v = blk.qkv(cur)
        k_cache[i, :, :, :prefix] = k
        v_cache[i, :, :, :prefix] = v
        cur = blk.mlp(cur + blk.c_proj(merge_heads(attend(q, k, v, bias))))
    logits = model.mel_head(model.ln_f(cur[:, -1]))

    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)
    tokens = torch.full((b, max_new), model.stop_mel, dtype=torch.long, device=dev)
    for step in range(max_new):
        tok = sample_tokens(logits.float() / temperature, noise, top_k)
        tok = torch.where(done, model.stop_mel, tok)
        done = done | (tok == model.stop_mel)
        tokens[:, step] = tok
        lengths += (~done).int()
        if step == max_new - 1 or bool(done.all()):
            break
        cur = (model.mel_emb.weight[tok] + model.mel_pos[1 + step])[:, None]
        pos = prefix + step
        for i, blk in enumerate(model.h):
            q, k, v = blk.qkv(cur)
            k_cache[i, :, :, pos] = k[:, :, 0]
            v_cache[i, :, :, pos] = v[:, :, 0]
            att = attend(q, k_cache[i, :, :, :pos + 1], v_cache[i, :, :, :pos + 1])
            cur = blk.mlp(cur + blk.c_proj(merge_heads(att)))
        logits = model.mel_head(model.ln_f(cur[:, 0]))
    return tokens, lengths


class DiscreteVAE(nn.Module):
    """Tortoise DVAE mel codec: strided conv encoder -> EMA codebook ->
    transposed-conv decoder (x 2^downsamples temporal compression)."""

    def __init__(self, channels: int = 256, codebook_size: int = 512,
                 codebook_dim: int = 256, n_mels: int = 80, downsamples: int = 2,
                 seed: int = 0, device: str | torch.device = "cuda",
                 train: bool = False):
        super().__init__()
        dev = resolve_device(device)
        self.enc = nn.ModuleList(
            Conv1d(n_mels if i == 0 else channels, channels, 4, stride=2, padding=1)
            for i in range(downsamples))
        self.enc_out = Conv1d(channels, codebook_dim, 3, padding=1)
        self.codebook = EuclideanCodebook(codebook_dim, codebook_size)
        self.dec_in = Conv1d(codebook_dim, channels, 3, padding=1)
        self.dec = nn.ModuleList(
            ConvTranspose1d(channels, channels, 4, stride=2, padding=1)
            for _ in range(downsamples))
        self.dec_out = Conv1d(channels, n_mels, 3, padding=1)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    def _encode(self, mel):
        x = mel
        for conv in self.enc:
            x = F.relu(conv(x))
        return self.enc_out(x)

    def _decode(self, x):
        y = F.relu(self.dec_in(x))
        for conv in self.dec:
            y = F.relu(conv(y))
        return self.dec_out(y)

    def encode(self, mel):
        """mel (B, T, n_mels) -> codes (B, T / 2^downsamples)."""
        return self.codebook.encode(self._encode(mel))

    def decode(self, codes):
        """codes (B, T') -> mel (B, T' x 2^downsamples, n_mels)."""
        return self._decode(self.codebook.decode(codes))

    def forward(self, mel, train: bool = False):
        """-> {recon, codes, commit, loss = recon MSE + 0.25 x commit}; with
        `train` the codebook takes one EMA step (after the codes and the
        quantized output are read from the old codebook)."""
        z = self._encode(mel)
        quantized, codes = self.codebook(z, train=train)
        commit = (quantized.detach() - z).square().mean()
        recon = self._decode(z + (quantized - z).detach())
        t = min(recon.shape[1], mel.shape[1])
        loss_recon = (recon[:, :t] - mel[:, :t]).square().mean()
        return {"recon": recon, "codes": codes, "commit": commit,
                "loss": loss_recon + 0.25 * commit}
