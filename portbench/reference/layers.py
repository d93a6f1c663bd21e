"""Plain float32 building blocks of the reference, channels-last (B, T, C).

A frozen copy of the plain math of the models that TTS serving runs
(VITS attention and encoder, WaveNet, the style encoder, the LSTMs, the
DiT flows, the anti-aliased SnakeBeta and the AMP / HiFiGAN blocks), with
no kernel, no cache and no compute dtype. Parameter names are those of
the published checkpoints, so one state_dict loads here and into the
served program alike.

Every product (convolution, linear layer, attention and LSTM matrices,
the Gaussian upsampler's weighted sum) takes its two operands through
`operand`, the identity unless a control runs the reference in a lower
precision (`lowered`, see precision.py).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1
MASK_VALUE = -1e4
SNAKE_EPS = 1e-9

_ROUNDING = contextvars.ContextVar("portbench_rounding", default=None)


@contextlib.contextmanager
def lowered(round_fn):
    """Inside the block every product's operands pass through round_fn."""
    token = _ROUNDING.set(round_fn)
    try:
        yield
    finally:
        _ROUNDING.reset(token)


def operand(t):
    fn = _ROUNDING.get()
    return t if fn is None else fn(t)


def matmul(a, b):
    return torch.matmul(operand(a), operand(b))


def linear(x, w, b=None):
    return F.linear(operand(x), operand(w), b)


def conv1d(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
    """x (B, T, Cin), w (Cout, Cin / groups, K); padding symmetric or a
    (left, right) pair of zeros. A pointwise conv is a linear layer on the
    channels (any leading shape)."""
    if w.shape[-1] == 1 and stride == 1 and groups == 1 and padding == 0:
        return linear(x, w[:, :, 0], b)
    xc = operand(x).transpose(1, 2)
    if isinstance(padding, tuple):
        xc, padding = F.pad(xc, padding), 0
    y = F.conv1d(xc, operand(w), b, stride, padding, dilation, groups)
    return y.transpose(1, 2)


def conv_transpose1d(x, w, b=None, stride=1, padding=0):
    y = F.conv_transpose1d(operand(x).transpose(1, 2), operand(w), b, stride,
                           padding)
    return y.transpose(1, 2)


def weight_norm(g, v):
    return g * (v / v.pow(2).sum(dim=tuple(range(1, v.dim())),
                                 keepdim=True).sqrt())


def leaky_relu(x, slope=LRELU_SLOPE):
    return F.leaky_relu(x, slope)


def feature_mask(lengths, t):
    return (torch.arange(t, device=lengths.device)[None] < lengths[:, None]
            )[..., None].float()


# ---------------- parameterised layers ----------------


class Conv1d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1, bias=True):
        super().__init__()
        self.stride, self.padding, self.dilation, self.groups = (
            stride, padding, dilation, groups)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.stride, self.padding,
                      self.dilation, self.groups)


class WNConv1d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 bias=True):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight_g = nn.Parameter(torch.empty(cout, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(cout, cin, k))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def weight(self):
        return weight_norm(self.weight_g, self.weight_v)

    def forward(self, x):
        return conv1d(x, self.weight(), self.bias, self.stride, self.padding,
                      self.dilation)


class WNConvTranspose1d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight_g = nn.Parameter(torch.empty(cin, 1, 1))
        self.weight_v = nn.Parameter(torch.empty(cin, cout, k))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return conv_transpose1d(x, weight_norm(self.weight_g, self.weight_v),
                                self.bias, self.stride, self.padding)


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class AffineLayerNorm(nn.Module):
    """VITS LayerNorm over channels, named gamma / beta."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.gamma, self.beta, self.eps)


class LayerNorm(nn.Module):
    """LayerNorm with torch's names (weight / bias)."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, self.eps)


# ---------------- attention ----------------


def _rel_to_abs(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def _abs_to_rel(x):
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def _rel_slice(emb, length, window):
    pad = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


class MultiHeadAttention(nn.Module):
    """VITS attention: 1x1 projections, optional windowed relative
    positions shared by the heads, -1e4 masking."""

    def __init__(self, channels, out_channels, n_heads, window_size=None):
        super().__init__()
        self.channels, self.n_heads, self.window = channels, n_heads, window_size
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        if window_size is not None:
            kc = channels // n_heads
            self.emb_rel_k = nn.Parameter(torch.empty(1, 2 * window_size + 1, kc))
            self.emb_rel_v = nn.Parameter(torch.empty(1, 2 * window_size + 1, kc))

    def forward(self, x, c, attn_mask=None):
        h, kc = self.n_heads, self.channels // self.n_heads
        b, tq, _ = x.shape
        tk = c.shape[1]
        q = self.conv_q(x).view(b, tq, h, kc).transpose(1, 2)
        k = self.conv_k(c).view(b, tk, h, kc).transpose(1, 2)
        v = self.conv_v(c).view(b, tk, h, kc).transpose(1, 2)
        q = q / math.sqrt(kc)
        scores = matmul(q, k.transpose(-1, -2))
        if self.window is not None:
            rel_k = _rel_slice(self.emb_rel_k, tk, self.window)
            scores = scores + _rel_to_abs(matmul(q, rel_k[0].t()))
        if attn_mask is not None:
            scores = scores.masked_fill(~attn_mask.bool(), MASK_VALUE)
        p = torch.softmax(scores, dim=-1)
        out = matmul(p, v)
        if self.window is not None:
            rel_v = _rel_slice(self.emb_rel_v, tk, self.window)
            out = out + matmul(_abs_to_rel(p), rel_v[0])
        return self.conv_o(out.transpose(1, 2).reshape(b, tq, self.channels))


class FFN(nn.Module):
    def __init__(self, cin, cout, filt, k):
        super().__init__()
        pad = ((k - 1) // 2, k // 2) if k > 1 else 0
        self.conv_1 = Conv1d(cin, filt, k, padding=pad)
        self.conv_2 = Conv1d(filt, cout, k, padding=pad)

    def forward(self, x, mask):
        y = torch.relu(self.conv_1(x * mask))
        return self.conv_2(y * mask) * mask


def pair_mask(mask):
    return (mask[:, None, :, 0:1] * mask[:, None, None, :, 0]).bool()


class Encoder(nn.Module):
    """Post-norm transformer encoder, windowed relative attention."""

    def __init__(self, hidden, filt, n_heads, n_layers, k=1, window=4):
        super().__init__()
        self.attn_layers = nn.ModuleList(
            MultiHeadAttention(hidden, hidden, n_heads, window)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            AffineLayerNorm(hidden) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden, hidden, filt, k) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            AffineLayerNorm(hidden) for _ in range(n_layers))

    def forward(self, x, mask):
        am = pair_mask(mask)
        x = x * mask
        for attn, n1, ffn, n2 in zip(self.attn_layers, self.norm_layers_1,
                                     self.ffn_layers, self.norm_layers_2):
            x = n1(x + attn(x, x, am))
            x = n2(x + ffn(x, mask))
        return x * mask


# ---------------- WaveNet, style ----------------


class WN(nn.Module):
    def __init__(self, hidden, k, dilation_rate, n_layers, gin=0):
        super().__init__()
        self.hidden, self.n_layers = hidden, n_layers
        self.cond_layer = WNConv1d(gin, 2 * hidden * n_layers, 1) if gin else None
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            d = dilation_rate ** i
            self.in_layers.append(WNConv1d(hidden, 2 * hidden, k,
                                           padding=(k * d - d) // 2, dilation=d))
            self.res_skip_layers.append(WNConv1d(
                hidden, 2 * hidden if i < n_layers - 1 else hidden, 1))

    def forward(self, x, mask, g=None):
        """g: (B, 1, Gin) or None."""
        hc = self.hidden
        out = torch.zeros_like(x)
        g_all = self.cond_layer(g) if g is not None else None
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            g_l = (g_all[..., i * 2 * hc:(i + 1) * 2 * hc] if g is not None
                   else torch.zeros_like(x_in))
            s = x_in + g_l
            acts = torch.tanh(s[..., :hc]) * torch.sigmoid(s[..., hc:])
            rs = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + rs[..., :hc]) * mask
                out = out + rs[..., hc:]
            else:
                out = out + rs
        return out * mask


def mish(x):
    return x * torch.tanh(F.softplus(x))


class _Act(nn.Module):
    def __init__(self, fn=None):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return x if self.fn is None else self.fn(x)


class Conv1dGLU(nn.Module):
    def __init__(self, cin, cout, k=5):
        super().__init__()
        self.cout = cout
        self.conv1 = Conv1d(cin, 2 * cout, k, padding=2)

    def forward(self, x):
        y = self.conv1(x)
        return x + y[..., :self.cout] * torch.sigmoid(y[..., self.cout:])


class StyleEncoder(nn.Module):
    """Mel -> global style vector (B, out): spectral 1x1 convs with Mish,
    two gated temporal convs, self-attention, fc, the sum over all frames
    divided by the true length."""

    def __init__(self, in_dim=80, hidden=256, out_dim=256):
        super().__init__()
        self.spectral = nn.Sequential(
            Conv1d(in_dim, hidden, 1), _Act(mish), _Act(),
            Conv1d(hidden, hidden, 1), _Act(mish), _Act())
        self.temporal = nn.Sequential(Conv1dGLU(hidden, hidden),
                                      Conv1dGLU(hidden, hidden))
        self.slf_attn = MultiHeadAttention(hidden, hidden, 2)
        self.fc = Conv1d(hidden, out_dim, 1)

    def forward(self, x, mask):
        y = self.spectral(x) * mask
        y = self.temporal(y) * mask
        y = y + self.slf_attn(y, y, pair_mask(mask))
        return self.fc(y).sum(dim=1) / mask.sum(dim=1)


# ---------------- LSTM ----------------


class BiLSTM(nn.Module):
    """Bidirectional LSTM with torch's parameter names, one row at a time:
    the input projection of all steps in one product, then the recurrence
    step by step. `lengths` runs each direction over the first n steps
    only (the packed form) with zeros after; without it the backward
    direction starts at the padded end."""

    def __init__(self, cin, hidden, num_layers=1):
        super().__init__()
        self.hidden, self.num_layers = hidden, num_layers
        for layer in range(num_layers):
            n_in = cin if layer == 0 else 2 * hidden
            for sfx in ("", "_reverse"):
                self.register_parameter(f"weight_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, n_in)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden, hidden)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(4 * hidden)))

    def _direction(self, x, layer, sfx):
        """x (T, In) -> (T, H), one direction over all T steps."""
        p = lambda n: getattr(self, f"{n}_l{layer}{sfx}")  # noqa: E731
        xw = linear(x, p("weight_ih"), p("bias_ih") + p("bias_hh"))
        h = x.new_zeros(self.hidden)
        c = x.new_zeros(self.hidden)
        whh = p("weight_hh")
        out = []
        for t in range(x.shape[0]):
            gates = xw[t] + linear(h[None], whh)[0]
            i, f, g, o = gates.chunk(4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        return torch.stack(out)

    def forward(self, x, length=None):
        """x (1, T, In) -> (1, T, 2H)."""
        t = x.shape[1]
        n = t if length is None else int(length)
        y = x[0, :n]
        for layer in range(self.num_layers):
            fwd = self._direction(y, layer, "")
            bwd = self._direction(y.flip(0), layer, "_reverse").flip(0)
            y = torch.cat([fwd, bwd], dim=-1)
        return F.pad(y, (0, 0, 0, t - n))[None]


# ---------------- DiT coupling flow ----------------


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


class TimmAttention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x):
        b, t, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).view(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        a = torch.softmax(matmul(q * hd ** -0.5, k.transpose(-1, -2)), dim=-1)
        return self.proj(matmul(a, v).transpose(1, 2).reshape(b, t, c))


class FFNConv(nn.Module):
    def __init__(self, cin, hidden, cout, k=5):
        super().__init__()
        self.fc1 = Conv1d(cin, hidden, k, padding=(k - 1) // 2)
        self.fc2 = Conv1d(hidden, cout, 1)

    def forward(self, x, mask):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh") * mask) * mask


class DiTConVBlock(nn.Module):
    def __init__(self, hidden, heads, mlp_ratio=4.0, k=9):
        super().__init__()
        self.hidden = hidden
        self.attn = TimmAttention(hidden, heads)
        self.mlp = FFNConv(hidden, int(hidden * mlp_ratio), hidden, k)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              Linear(hidden, 6 * hidden))

    def _norm(self, x):
        return F.layer_norm(x, (self.hidden,), eps=1e-6)

    def forward(self, x, c, mask):
        x = x * mask
        sm, cm, gm, sf, cf, gf = self.adaLN_modulation(c).chunk(6, dim=-1)
        a = self.attn(modulate(self._norm(x) * mask, sm, cm))
        x = x + gm[:, None, :] * a * mask
        m = self.mlp(modulate(self._norm(x), sf, cf), mask)
        return x + gf[:, None, :] * m


class CouplingDiT(nn.Module):
    def __init__(self, channels, hidden, n_layers, heads=2, k=5):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden, 1)
        self.enc_block = nn.ModuleList(DiTConVBlock(hidden, heads, 4.0, k)
                                       for _ in range(n_layers))
        self.post = Conv1d(hidden, self.half, 1)

    def reverse(self, x, mask, c):
        x0, x1 = x[..., :self.half], x[..., self.half:]
        h = self.pre(x0) * mask
        for blk in self.enc_block:
            h = blk(h, c, mask)
        x1 = (x1 - self.post(h) * mask) * mask
        return torch.cat([x0, x1], dim=-1)


class Flip(nn.Module):
    pass


class FlowDiT(nn.Module):
    """n_flows x (DiT coupling, channel flip), run in reverse."""

    def __init__(self, channels, hidden, n_layers=3, n_flows=4, gin=256,
                 heads=2):
        super().__init__()
        self.cond_block = nn.Sequential(Linear(gin, 4 * hidden), nn.SiLU(),
                                        Linear(4 * hidden, hidden))
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(CouplingDiT(channels, hidden, n_layers, heads))
            self.flows.append(Flip())

    def reverse(self, x, mask, g):
        c = self.cond_block(g)
        for flow in reversed(self.flows):
            x = x.flip(-1) if isinstance(flow, Flip) else flow.reverse(x, mask, c)
        return x


# ---------------- anti-aliased SnakeBeta, AMP and HiFiGAN blocks ----------------


def kaiser_sinc(cutoff, half_width, k):
    half = k // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    win = np.kaiser(k, beta)
    time = (np.arange(-half, half) + 0.5) if k % 2 == 0 else np.arange(k) - half
    f = 2 * cutoff * win * np.sinc(2 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


_FILTER = kaiser_sinc(0.25, 0.3, 12)   # the x2 up and down filters


def _depthwise(x):
    c = x.shape[-1]
    return torch.from_numpy(_FILTER).to(x.device, x.dtype).view(1, 1, -1).expand(c, 1, -1)


def aa_snake(x, alpha, beta):
    """down2(s(up2(x))), s(u) = u + sin^2(a u) / (b + eps), a = exp(alpha),
    b = exp(beta): replicate-padded kaiser-sinc x2 up- and downsampling."""
    c = x.shape[-1]
    a, b = alpha.exp(), beta.exp()
    xt = F.pad(x.transpose(1, 2), (5, 5), mode="replicate")
    u = 2 * F.conv_transpose1d(operand(xt), operand(_depthwise(x)), stride=2,
                               groups=c)
    u = u[:, :, 15:u.shape[-1] - 15]
    u = u + torch.sin(u * a[:, None]).square() / (b[:, None] + SNAKE_EPS)
    u = F.pad(u, (5, 6), mode="replicate")
    y = F.conv1d(operand(u), operand(_depthwise(x)), stride=2, groups=c)
    return y.transpose(1, 2)


class _Snake(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(c))
        self.beta = nn.Parameter(torch.empty(c))


class AASnakeBeta(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.act = _Snake(c)

    def forward(self, x):
        return aa_snake(x, self.act.alpha, self.act.beta)


def get_padding(k, d=1):
    return (k * d - d) // 2


class AMPBlock(nn.Module):
    def __init__(self, c, k=3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(WNConv1d(c, c, k, padding=get_padding(k, d),
                                             dilation=d) for d in dilation)
        self.convs2 = nn.ModuleList(WNConv1d(c, c, k, padding=get_padding(k))
                                    for _ in dilation)
        self.activations = nn.ModuleList(AASnakeBeta(c)
                                         for _ in range(2 * len(dilation)))

    def forward(self, x):
        for i, (c1, c2) in enumerate(zip(self.convs1, self.convs2)):
            xt = c2(self.activations[2 * i + 1](c1(self.activations[2 * i](x))))
            x = xt + x
        return x


class ResBlock1(nn.Module):
    def __init__(self, c, k=3, dilation=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(WNConv1d(c, c, k, padding=get_padding(k, d),
                                             dilation=d) for d in dilation)
        self.convs2 = nn.ModuleList(WNConv1d(c, c, k, padding=get_padding(k))
                                    for _ in dilation)

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(leaky_relu(c1(leaky_relu(x)))) + x
        return x


def block_mean(blocks, x):
    return sum(b(x) for b in blocks) / len(blocks)
