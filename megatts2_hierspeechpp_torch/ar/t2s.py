"""GPT-SoVITS-style text-to-semantic AR decoder (alternative PLM stack B).

Counterpart of `megatts2_hierspeechpp_tpu/ar/t2s.py` (reference
AR/models/t2s_model.py Text2SemanticDecoder): phoneme + BERT-feature
embeddings with sine positions (trainable alpha), audio-token embedding, the
joint [x; y] sequence through post-norm transformer layers with a combined
(text-sees-text, audio-causal) + key-padding mask, a CE-sum loss over the
audio segment with EOS-padded targets, and top-k accuracy.

Parameter names are the reference checkpoint's, the ones JAX convert_t2s
reads: `bert_proj`, `ar_text_embedding.word_embeddings.weight`,
`ar_audio_embedding.word_embeddings.weight`, `ar_text_position.alpha`,
`ar_audio_position.alpha`, `h.layers.{i}.self_attn.{in_proj_weight,
in_proj_bias,out_proj}`, `h.layers.{i}.{linear1,linear2,norm1,norm2}` and
`ar_predict_layer` (no bias).

The dropouts (on the attention probabilities, after out_proj, after the
FFN's relu and after linear2, as the JAX T2SLayer) draw only in a training
build's train() mode under an active nn/basic.MaskSource.

`t2s_decode` is the JAX KV-cached decode: one prefill over [text; prompt]
fills a preallocated (n_layers, B, H, total, hd) cache, each step attends to
the cache up to its own position, and the sampler applies the repetition
penalty, the temperature, top-k and top-p, then draws as
jax.random.categorical does, argmax(gumbel + logits). The Gumbel noise comes
from an injectable source (nn/decode.GumbelNoise of a torch.Generator by
default; the tests feed JAX's draws). It stops once every row has emitted EOS; what it
returns equals the JAX fixed-length scan's.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.basic import Dropout
from megatts2_hierspeechpp_torch.nn.decode import (
    NEG_INF,
    attend,
    default_noise,
    merge_heads,
    sample_tokens,
    split_heads,
)
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.ops.plm_decode import sine_positions

BERT_DIM = 1024


class SelfAttention(nn.Module):
    """torch MultiheadAttention's packed projection: in_proj_weight (3d, d),
    in_proj_bias (3d,), out_proj; dropout on the probabilities."""

    def __init__(self, dim: int, n_heads: int, p_dropout: float):
        super().__init__()
        self.n_heads, self.hd = n_heads, dim // n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)
        self.dropout = Dropout(p_dropout)

    def qkv(self, x):
        """x (B, T, d) -> q, k, v, each (B, H, T, hd)."""
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        return (split_heads(y, self.n_heads) for y in qkv.chunk(3, dim=-1))

    def attend(self, q, k, v, bias=None):
        """Attention of q over k, v, merged to (B, T, d) and projected."""
        return self.out_proj(merge_heads(attend(q, k, v, bias, self.dropout)))

    def forward(self, x, bias):
        return self.attend(*self.qkv(x), bias)


class T2SLayer(nn.Module):
    """Post-norm torch TransformerEncoderLayer (relu FFN)."""

    def __init__(self, dim: int, n_heads: int, ffn_dim: int, p_dropout: float):
        super().__init__()
        self.self_attn = SelfAttention(dim, n_heads, p_dropout)
        self.linear1 = nn.Linear(dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, dim)
        self.norm1 = nn.LayerNorm(dim)
        self.norm2 = nn.LayerNorm(dim)
        self.dropout1 = Dropout(p_dropout)
        self.dropout = Dropout(p_dropout)
        self.dropout2 = Dropout(p_dropout)

    def ffn(self, x):
        """The block after attention: x is norm1's input plus attention."""
        x = self.norm1(x)
        y = self.dropout(F.relu(self.linear1(x)))
        return self.norm2(x + self.dropout2(self.linear2(y)))

    def forward(self, x, bias):
        return self.ffn(x + self.dropout1(self.self_attn(x, bias)))


class _TokenEmbedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.word_embeddings = nn.Embedding(n, dim)


class _Position(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def prefix_bias(x_len: int, total: int, device) -> torch.Tensor:
    """(total, total) additive mask: text rows see the text, audio rows the
    text and the audio up to themselves."""
    q = torch.arange(total, device=device)[:, None]
    k = torch.arange(total, device=device)[None, :]
    allowed = torch.where(q < x_len, k < x_len, (k < x_len) | (k <= q))
    return torch.where(allowed, 0.0, NEG_INF)


class Text2Semantic(nn.Module):
    """The training forward and the pieces `t2s_decode` needs.

    Built on the CPU with seeded weights (nn/init.py; the packed attention
    projections N(0, 1/d), the position alphas 1), then moved to `device`
    ("cuda" by default; raises if CUDA is absent). A serving build (the
    default) is frozen in eval() mode; `train=True` leaves the parameters
    trainable and the module in train() mode. Float32 throughout (the JAX
    CLI sets no dtype)."""

    def __init__(self, hidden_dim: int = 512, embedding_dim: int = 512,
                 n_heads: int = 8, n_layers: int = 12, vocab_size: int = 1025,
                 phoneme_vocab_size: int = 512, p_dropout: float = 0.0,
                 top_k_acc: int = 3, seed: int = 0,
                 device: str | torch.device = "cuda", train: bool = False):
        super().__init__()
        dev = resolve_device(device)
        e = embedding_dim
        self.hidden_dim, self.embedding_dim = hidden_dim, embedding_dim
        self.n_heads, self.n_layers = n_heads, n_layers
        self.vocab_size, self.top_k_acc = vocab_size, top_k_acc
        self.bert_proj = nn.Linear(BERT_DIM, e)
        self.ar_text_embedding = _TokenEmbedding(phoneme_vocab_size, e)
        self.ar_audio_embedding = _TokenEmbedding(vocab_size, e)
        self.ar_text_position = _Position()
        self.ar_audio_position = _Position()
        self.h = _Layers(T2SLayer(hidden_dim, n_heads, 4 * hidden_dim, p_dropout)
                         for _ in range(n_layers))
        self.ar_predict_layer = nn.Linear(hidden_dim, vocab_size, bias=False)
        init_weights(self, seed)
        gen = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for layer in self.h.layers:
                w = layer.self_attn.in_proj_weight
                w.copy_(torch.randn(w.shape, generator=gen) * hidden_dim ** -0.5)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    @property
    def eos(self) -> int:
        return self.vocab_size - 1

    def embed_text(self, x_ids, bert_feature):
        """(B, Nx) ids, (B, Nx, 1024) features -> (B, Nx, e)."""
        x = self.ar_text_embedding.word_embeddings(x_ids.long())
        x = x + self.bert_proj(bert_feature)
        pe = sine_positions(x.shape[1], self.embedding_dim, x.device)
        return x + self.ar_text_position.alpha * pe

    def embed_audio(self, y_ids):
        """(B, Ny) ids -> (B, Ny, e)."""
        y = self.ar_audio_embedding.word_embeddings(y_ids.long())
        pe = sine_positions(y.shape[1], self.embedding_dim, y.device)
        return y + self.ar_audio_position.alpha * pe

    def _stack(self, xy, bias):
        for layer in self.h.layers:
            xy = layer(xy, bias)
        return xy

    def forward(self, x_ids, x_lens, y_ids, y_lens, bert_feature):
        """Training forward. x_ids (B, Nx), y_ids (B, Ny), bert_feature
        (B, Nx, 1024) -> {loss (CE summed over every position, pads
        included, as the reference), acc (top-`top_k_acc` over the non-EOS
        targets), logits (B, Ny, V), targets}."""
        b, x_len = x_ids.shape
        y_len = y_ids.shape[1]
        dev = x_ids.device
        x = self.embed_text(x_ids, bert_feature)
        pos_y = torch.arange(y_len, device=dev)
        y_pad = pos_y[None] >= y_lens.to(dev)[:, None]
        codes = torch.where(y_pad, 0, y_ids.long())
        # input keeps the codes with EOS on the pads; the target shifts left
        eos_filled = codes + self.eos * y_pad.long()
        ext = torch.cat([eos_filled, torch.full((b, 1), self.eos, device=dev,
                                                dtype=torch.long)], dim=1)
        y_in, targets = ext[:, :-1], ext[:, 1:]
        xy = torch.cat([x, self.embed_audio(y_in)], dim=1)

        x_pad = torch.arange(x_len, device=dev)[None] >= x_lens.to(dev)[:, None]
        pad_k = torch.cat([x_pad, y_pad], dim=1)
        bias = prefix_bias(x_len, x_len + y_len, dev)[None, None]
        bias = torch.where(pad_k[:, None, None, :], NEG_INF, bias)
        logits = self.ar_predict_layer(self._stack(xy, bias)[:, x_len:])

        logp = F.log_softmax(logits.float(), dim=-1)
        loss = -logp.gather(-1, targets[..., None])[..., 0].sum()
        hit = (logits.topk(self.top_k_acc, dim=-1).indices
               == targets[..., None]).any(-1)
        valid = targets != self.eos
        acc = (hit & valid).sum() / valid.sum().clamp_min(1)
        return {"loss": loss, "acc": acc, "logits": logits, "targets": targets}

    def prefix_logits(self, x_ids, bert_feature, y_ids):
        """Full recompute without padding: logits (B, Ny, V), row j the
        prediction after y_ids[:, j] (what the decode reads at that step)."""
        x_len = x_ids.shape[1]
        xy = torch.cat([self.embed_text(x_ids, bert_feature),
                        self.embed_audio(y_ids)], dim=1)
        bias = prefix_bias(x_len, xy.shape[1], xy.device)[None, None]
        return self.ar_predict_layer(self._stack(xy, bias)[:, x_len:])


def _layer_step(layer: T2SLayer, cur, k_cache, v_cache, pos: int):
    """One token (B, d) through a layer, its K / V written at `pos` of the
    layer's cache (B, H, total, hd)."""
    q, k, v = layer.self_attn.qkv(cur[:, None])
    k_cache[:, :, pos] = k[:, :, 0]
    v_cache[:, :, pos] = v[:, :, 0]
    att = layer.self_attn.attend(q, k_cache[:, :, :pos + 1],
                                 v_cache[:, :, :pos + 1])[:, 0]
    return layer.ffn(cur + att)


@torch.inference_mode()
def t2s_decode(model: Text2Semantic, x_ids, bert_feature, prompts,
               max_new: int = 600, top_k: int = 3, top_p: float = 1.0,
               temperature: float = 1.0, repetition_penalty: float = 1.0,
               noise: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cached AR decode. x_ids (B, Nx), bert_feature (B, Nx, 1024),
    prompts (B, P) -> (tokens (B, max_new) int64, EOS after a row stops;
    lengths (B,) int32, the tokens before EOS). `noise(shape)` gives the
    Gumbel draw of each step (default: GumbelNoise seeded 0 on x_ids'
    device)."""
    nl, h, eos = model.n_layers, model.n_heads, model.eos
    hd = model.hidden_dim // h
    dev = x_ids.device
    noise = default_noise(dev) if noise is None else noise
    b, x_len = x_ids.shape
    p_len = prompts.shape[1]
    prefix = x_len + p_len
    total = prefix + max_new

    cur = torch.cat([model.embed_text(x_ids, bert_feature),
                     model.embed_audio(prompts)], dim=1)
    bias = prefix_bias(x_len, prefix, dev)[None, None]
    k_cache = torch.zeros(nl, b, h, total, hd, device=dev)
    v_cache = torch.zeros_like(k_cache)
    for i, layer in enumerate(model.h.layers):
        q, k, v = layer.self_attn.qkv(cur)
        k_cache[i, :, :, :prefix] = k
        v_cache[i, :, :, :prefix] = v
        cur = layer.ffn(cur + layer.self_attn.attend(q, k, v, bias))
    logits = model.ar_predict_layer(cur[:, -1])

    table = model.ar_audio_embedding.word_embeddings.weight
    pe = model.ar_audio_position.alpha * sine_positions(
        p_len + max_new + 1, model.embedding_dim, dev)
    rows = torch.arange(b, device=dev)
    seen = torch.zeros(b, model.vocab_size, dtype=torch.bool, device=dev)
    seen[rows[:, None], prompts.long()] = True
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    lengths = torch.zeros(b, dtype=torch.int32, device=dev)
    tokens = torch.full((b, max_new), eos, dtype=torch.long, device=dev)
    for step in range(max_new):
        lg = logits.float()
        if repetition_penalty != 1.0:
            pen = torch.where(lg < 0, lg * repetition_penalty,
                              lg / repetition_penalty)
            lg = torch.where(seen, pen, lg)
        tok = sample_tokens(lg / temperature, noise, top_k, top_p)
        tok = torch.where(done, eos, tok)
        done = done | (tok == eos)
        tokens[:, step] = tok
        lengths += (~done).int()
        seen[rows, tok] = True
        if step == max_new - 1 or bool(done.all()):
            break
        cur = table[tok] + pe[p_len + step]
        for i, layer in enumerate(model.h.layers):
            cur = _layer_step(layer, cur, k_cache[i], v_cache[i], prefix + step)
        logits = model.ar_predict_layer(cur)
    return tokens, lengths
