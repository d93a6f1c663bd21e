"""Prosody language model (Megatts2PLM1) and its KV-cached decode.

Counterpart of `megatts2_hierspeechpp_tpu/models/plm.py`: a pre-norm causal
transformer over concat(frame-level text latent 256, previous-prosody-code
embedding 20) with sinusoidal positions scaled by a learnt alpha; go token
1024. Parameter names are the reference checkpoint's (`pc_embedding`,
`pos_emb.alpha`, `plm.layers.{i}.{norm1,norm2,attn.w_q,...,attn.out_proj.0,
ff.0,ff.3}`, `predict_layer`); the dropouts (p 0.1 on the attention
weights, after out_proj and after the FFN's relu, as the JAX PLMLayer)
sit where the reference's do, so those indices hold. They draw only in a
training build's train() mode under an active nn/basic.MaskSource.

Training: `loss_dict` is the JAX ProsodyLM.__call__ (summed NLL over the
valid positions, its per-frame log value, top-10 accuracy);
`ProsodyLMNonCausal` is the reference's variant A (the VITS encoder over
the same input, no causal mask), kept for its checkpoints.

`decode` dispatches as the JAX `decode` does: a greedy latent (taken to
float32, as the JAX kernel takes a bf16 one) on the card goes to the
kernel wrapper (`ops/plm_decode.py`) at the kernel's defaults, bf16
weights and bf16 KV cache, the JAX package's serving configuration; a
batch of B rows goes in groups of up to MAX_ROWS rows, one launch a group,
each row's codes its own one-row launch's (greedy causal decode is
independent per row); other dtypes go one row a launch. On the CPU the
greedy rows, and top-k sampling anywhere, take the plain KV-cached loop in
float32, the JAX float32 scan's counterpart. A caller's weight / cache
dtypes hold on every route.

`dtype` (None: float32) is the JAX modules' compute dtype of the training
forwards: the projections, the attention products and the softmax take it
(the mask cast to it, as the JAX mask is weakly typed), while the input
concatenation, the residual stream, the LayerNorms and the loss stay
float32; the decode's packed weights stay float32 whatever it is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.nn.attention import Encoder
from megatts2_hierspeechpp_torch.nn.basic import Dropout, Linear
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.ops.plm_decode import (
    MAX_ROWS,
    PLMWeights,
    plain_decode,
    plm_decode_greedy,
    sine_positions,
)
from megatts2_hierspeechpp_torch.parallel import mesh
from megatts2_hierspeechpp_torch.utils.profiling import annotate


NEG_INF = -1e9


P_DROPOUT = 0.1


class PLMAttention(nn.Module):
    def __init__(self, dim: int, n_heads: int, dtype=None):
        super().__init__()
        self.n_heads = n_heads
        self.w_q = Linear(dim, dim, dtype=dtype)
        self.w_k = Linear(dim, dim, dtype=dtype)
        self.w_v = Linear(dim, dim, dtype=dtype)
        self.drop = Dropout(P_DROPOUT)
        self.out_proj = nn.Sequential(Linear(dim, dim, dtype=dtype),
                                      Dropout(P_DROPOUT))

    def forward(self, x, bias):
        b, t, _ = x.shape
        h = self.n_heads
        d = self.w_q.weight.shape[0]   # a tensor-parallel shard's heads' width
        hd = d // h
        q, k, v = (m(x).view(b, t, h, hd).transpose(1, 2)
                   for m in (self.w_q, self.w_k, self.w_v))
        # the JAX mask is a weakly typed array: it takes the scores' dtype
        scores = (torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
                  + bias.to(q.dtype))
        att = torch.matmul(self.drop(torch.softmax(scores, dim=-1)), v)
        return self.out_proj(att.transpose(1, 2).reshape(b, t, d))


class PLMLayer(nn.Module):
    """Pre-norm transformer layer (reference transformer_mega.py)."""

    def __init__(self, dim: int, ff_dim: int, n_heads: int, dtype=None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn = PLMAttention(dim, n_heads, dtype)
        self.norm2 = nn.LayerNorm(dim)
        self.ff = nn.Sequential(Linear(dim, ff_dim, dtype=dtype), nn.ReLU(),
                                Dropout(P_DROPOUT),
                                Linear(ff_dim, dim, dtype=dtype))

    def forward(self, x, bias):
        x = x + self.attn(self.norm1(x), bias)
        return x + self.ff(self.norm2(x))


class _PosEmb(nn.Module):
    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1))


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


def _embed_inputs(model, tc_latent, p_codes):
    """[go, p_codes[:, :-1]] embedded beside tc_latent, plus alpha x the
    sinusoidal positions: (B, T, d)."""
    b, t, _ = tc_latent.shape
    go = torch.full((b, 1), model.go_id, dtype=torch.long,
                    device=p_codes.device)
    inputs = torch.cat([go, p_codes[:, :-1].long()], dim=1)
    emb = model.pc_embedding(inputs)
    x = torch.cat([tc_latent.to(emb.dtype), emb], dim=-1)
    return x + model.pos_emb.alpha * sine_positions(t, x.shape[-1], x.device)


def _nll(model, logits, targets, valid):
    """The NLL summed over the valid positions (valid (B, T) float), the
    targets clipped to the code range, as the JAX loss."""
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = targets.long().clamp(0, model.vq_bins - 1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * valid).sum()


class ProsodyLM(nn.Module):
    """Megatts2PLM1: teacher-forced forward, the training loss and the
    pieces `decode` needs.

    Built on the CPU with seeded weights (nn/init.py), then moved to
    `device` ("cuda" by default; raises if CUDA is absent). A serving build
    (the default) is frozen in eval() mode; `train=True` leaves the
    parameters trainable and the module in train() mode. The decode's
    stacked weights are built on first use and kept while every parameter
    is the same tensor at the same version: loading, moving or an
    optimizer's in-place update makes `packed()` build them again."""

    def __init__(self, n_layers: int = 4, n_heads: int = 4, vq_dim: int = 20,
                 tc_latent_dim: int = 256, vq_bins: int = 1024, seed: int = 0,
                 device: str | torch.device = "cuda", train: bool = False,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.n_heads, self.vq_bins = n_heads, vq_bins
        d = vq_dim + tc_latent_dim
        self.pc_embedding = nn.Embedding(vq_bins + 2, vq_dim)
        self.pos_emb = _PosEmb()
        self.plm = _Layers(PLMLayer(d, 4 * d, n_heads, dtype)
                           for _ in range(n_layers))
        self.predict_layer = Linear(d, vq_bins, bias=False, dtype=dtype)
        self._packed: Optional[tuple] = None
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        # also for inference tensors, whose in-place copy bumps no version
        self._packed = None
        return super().load_state_dict(*args, **kwargs)

    @property
    def go_id(self) -> int:
        return self.vq_bins

    def forward(self, tc_latent, p_codes, lens=None):
        """Teacher-forced logits: tc_latent (B, T, 256); p_codes (B, T) int
        targets (inputs are [go, p_codes[:, :-1]]); lens (B,) or None ->
        (B, T, bins)."""
        t = tc_latent.shape[1]
        x = _embed_inputs(self, tc_latent, p_codes)
        pos = torch.arange(t, device=x.device)
        allowed = (pos[None, :] <= pos[:, None])[None]
        if lens is not None:
            allowed = allowed & (pos[None, :] < lens.to(x.device)[:, None])[:, None]
        bias = torch.where(allowed, 0.0, NEG_INF)[:, None]
        for layer in self.plm.layers:
            x = layer(x, bias)
        return self.predict_layer(x)

    def loss_dict(self, tc_latent, p_codes, lens):
        """The training loss (JAX ProsodyLM.__call__): tc_latent (B, T,
        256), p_codes (B, T) targets, lens (B,) -> {logits, targets, loss
        (summed NLL over positions < lens), loss_log (loss / sum(lens)),
        acc (top-10 hit rate over those positions)}."""
        logits = self(tc_latent, p_codes, lens)
        t = tc_latent.shape[1]
        valid = (torch.arange(t, device=logits.device)[None]
                 < lens.to(logits.device)[:, None]).float()
        loss = _nll(self, logits, p_codes, valid)
        top10 = logits.topk(10, dim=-1).indices
        hit = (top10 == p_codes.long()[..., None]).any(-1).float()
        # in a data-parallel step, this rank's shares of the global ratios
        acc = (hit * valid).sum() / mesh.batch_sum(valid.sum()).clamp_min(1)
        return {"logits": logits, "targets": p_codes, "loss": loss,
                "loss_log": loss / mesh.batch_sum(lens.sum()), "acc": acc}

    def _pack_key(self) -> tuple:
        # a model built under inference_mode has inference tensors, which
        # carry no version counter (and no optimizer can step them)
        return tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                     for p in self.parameters())

    def packed(self) -> PLMWeights:
        """The weights stacked over layers, as ops/plm_decode takes them:
        built on first use and again whenever a parameter was replaced or
        written in place since (an optimizer step bumps its version)."""
        key = self._pack_key()
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                self._packed = (key, self._pack())
        return self._packed[1]

    def _pack(self) -> PLMWeights:
        layers = self.plm.layers

        def stack(fn):
            return torch.stack([fn(lyr) for lyr in layers]).contiguous()

        return PLMWeights(
            emb=self.pc_embedding.weight,
            pos_alpha=self.pos_emb.alpha,
            wqkv=stack(lambda l: torch.cat(
                [l.attn.w_q.weight, l.attn.w_k.weight, l.attn.w_v.weight])),
            bqkv=stack(lambda l: torch.cat(
                [l.attn.w_q.bias, l.attn.w_k.bias, l.attn.w_v.bias])),
            wo=stack(lambda l: l.attn.out_proj[0].weight),
            bo=stack(lambda l: l.attn.out_proj[0].bias),
            ln=stack(lambda l: torch.stack([l.norm1.weight, l.norm1.bias,
                                            l.norm2.weight, l.norm2.bias])),
            ff0=stack(lambda l: l.ff[0].weight),
            ff0b=stack(lambda l: l.ff[0].bias),
            ff1=stack(lambda l: l.ff[3].weight),
            ff1b=stack(lambda l: l.ff[3].bias),
            pred=self.predict_layer.weight,
            n_heads=self.n_heads,
        )


class ProsodyLMNonCausal(nn.Module):
    """Megatts2PLM variant A (JAX ProsodyLMNonCausal; reference
    t2w2v_transformer.py:531-624): the relative-position VITS Encoder `plm`
    over the same [tc_latent, code embedding] input with positions, masked
    by length but not causally. The reference ships Megatts2PLM1 instead;
    this one loads its checkpoints. Built as ProsodyLM is."""

    def __init__(self, n_layers: int = 4, n_heads: int = 4, vq_dim: int = 20,
                 tc_latent_dim: int = 256, vq_bins: int = 1024, seed: int = 0,
                 device: str | torch.device = "cuda", train: bool = False,
                 dtype=None):
        super().__init__()
        dev = resolve_device(device)
        self.vq_bins = vq_bins
        d = vq_dim + tc_latent_dim
        self.pc_embedding = nn.Embedding(vq_bins + 2, vq_dim)
        self.pos_emb = _PosEmb()
        self.plm = Encoder(d, 4 * d, n_heads, n_layers, 9, p_dropout=P_DROPOUT,
                           dtype=dtype)
        self.predict_layer = Linear(d, vq_bins, bias=False, dtype=dtype)
        init_weights(self, seed)
        if not train:
            self.eval().requires_grad_(False)
        self.to(dev)

    @property
    def go_id(self) -> int:
        return self.vq_bins

    def loss_dict(self, tc_latent, p_codes, lens):
        """-> {logits, targets, loss, loss_log}, as ProsodyLM.loss_dict
        without the accuracy (the JAX module's outputs)."""
        t = tc_latent.shape[1]
        x = _embed_inputs(self, tc_latent, p_codes)
        mask = (torch.arange(t, device=x.device)[None]
                < lens.to(x.device)[:, None])[..., None].to(x.dtype)
        logits = self.predict_layer(self.plm(x * mask, mask))
        loss = _nll(self, logits, p_codes, mask[..., 0])
        return {"logits": logits, "targets": p_codes, "loss": loss,
                "loss_log": loss / mesh.batch_sum(lens.sum())}


@torch.inference_mode()
def teacher_forced_gap(model: ProsodyLM, tc_latent: torch.Tensor,
                       codes: torch.Tensor) -> tuple[float, float]:
    """Greedy-decode check that tolerates near-tie flips, on the
    teacher-forced forward over [go, codes[:-1]]: (the largest row max -
    logit of the chosen code, max|logits|). The gap is 0 for an exact greedy
    decode; a decode that flips a near tie keeps it within its float error
    of the scale."""
    logits = model(tc_latent, codes.long())
    chosen = logits.gather(-1, codes.long()[..., None])[..., 0]
    return (float((logits.amax(-1) - chosen).max()),
            float(logits.abs().max()))


@torch.inference_mode()
def decode(model: ProsodyLM, tc_latent: torch.Tensor, top_k: int = 0,
           temperature: float = 1.0,
           generator: Optional[torch.Generator] = None,
           weight_dtype: Optional[torch.dtype] = None,
           cache_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """tc_latent (B, T, 256) -> codes (B, T) int32: greedy when top_k == 0,
    else top-k sampling from `generator` (a torch.Generator on tc_latent's
    device). A latent of a lower float dtype (a bf16 TTV's) is taken to
    float32 first, as the JAX kernel takes it
    (ops/pallas_plm_decode.py:310).

    Routed as the JAX `decode` routes it: a greedy decode on the card runs
    the decode kernel at the kernel's defaults, bf16 weights and bf16 cache
    (plm_decode_bf16.cu), as JAX sends a B = 1 greedy decode to its kernel,
    the rows in order in groups of up to MAX_ROWS, one launch a group, each
    row's codes those of its own one-row launch; any other dtype pair one
    row a launch (plm_decode.cu); on the CPU (row by row) and for sampling
    the plain loop runs in float32, the counterpart of the JAX float32 scan.
    An explicit `weight_dtype` / `cache_dtype` holds on either route. (JAX
    decodes a B > 1 batch in its scan; here each row is decoded as JAX
    decodes a B = 1 request.) The span plm.decode, its args the rows and
    the kernel wrapper's calls."""
    f32, bf = torch.float32, torch.bfloat16
    if top_k:
        with annotate("plm.decode"):
            return plain_decode(model.packed(), tc_latent.float(), model.go_id,
                                top_k, temperature, generator,
                                weight_dtype or f32, cache_dtype or f32)
    on_card = tc_latent.device.type != "cpu"
    if not on_card:
        weight_dtype, cache_dtype = weight_dtype or f32, cache_dtype or f32
    dts = {k: v for k, v in (("weight_dtype", weight_dtype),
                             ("cache_dtype", cache_dtype)) if v is not None}
    step = (MAX_ROWS if on_card and (weight_dtype or bf) == (cache_dtype or bf) == bf
            else 1)
    rows = tc_latent.shape[0]
    with annotate("plm.decode", (rows, -(-rows // step)), _decode_args):
        w = model.packed()
        tc_latent = tc_latent.float()
        return torch.cat([plm_decode_greedy(w, tc_latent[i:i + step],
                                            model.go_id, **dts)
                          for i in range(0, rows, step)])


def _decode_args(a: tuple) -> str:
    """plm.decode's args: the rows and the kernel wrapper's calls."""
    return f"rows={a[0]} launches={a[1]}"
