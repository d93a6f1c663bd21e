"""f0 extraction: vectorised YIN at 200 Hz (YAAPT-compatible framing).

Counterpart of `megatts2_hierspeechpp_tpu/ops/f0.py`: the reference tracks
f0 with pYAAPT (20 ms frames, 5 ms hop, f0_max 1100, zero-padded by half a
frame), 4 values per w2v frame, 0 where unvoiced. Like the JAX package, this
is a YIN (cumulative mean normalised difference) extractor with the same
framing and voicing contract.

One batched tensor graph: frames by unfold, the difference function from
cumulative sums and one rfft / irfft autocorrelation, then the CMNDF, the
first dip under the threshold descended to its local minimum (else the
global minimum), and parabolic refinement.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def yin_f0(x, sr: int = 16000, hop: int = 80, fmin: float = 60.0,
           fmax: float = 1100.0, win: int = 400, threshold: float = 0.15):
    """x: (B, T) -> f0 (B, T // hop) in Hz, 0 where unvoiced."""
    t = x.shape[1]
    tau_max = int(sr / fmin) + 1  # 267 at 60 Hz
    tau_min = max(int(sr / fmax), 2)  # 14 at 1100 Hz
    seg = win + tau_max
    pad = 160  # half a 20 ms frame, the reference's zero pad
    n_frames = t // hop
    xp = F.pad(x, (pad, pad + seg))
    frames = xp.unfold(-1, seg, hop)[:, :n_frames]  # (B, F, seg)

    # d(tau) = p(0) + p(tau) - 2 ac(tau) over a window of `win` samples
    csum2 = F.pad(torch.cumsum(frames.square(), dim=-1), (1, 0))
    p0 = csum2[..., win] - csum2[..., 0]
    p_tau = csum2[..., win:win + tau_max] - csum2[..., :tau_max]
    nfft = 1 << math.ceil(math.log2(2 * seg))
    spec = torch.fft.rfft(frames, n=nfft, dim=-1)
    win_spec = torch.fft.rfft(frames[..., :win], n=nfft, dim=-1)
    ac = torch.fft.irfft(win_spec.conj() * spec, n=nfft, dim=-1)[..., :tau_max]
    d = torch.clamp(p0[..., None] + p_tau - 2 * ac, min=0.0)

    # cumulative mean normalised difference, +inf below tau_min
    taus = torch.arange(tau_max, device=x.device)
    csum_d = torch.cumsum(d[..., 1:], dim=-1)
    cmndf = torch.cat([torch.ones_like(d[..., :1]),
                       d[..., 1:] * taus[1:] / torch.clamp(csum_d, min=1e-9)],
                      dim=-1)
    cmndf = torch.where(taus >= tau_min, cmndf, torch.inf)

    # the first tau under the threshold where the CMNDF stops falling, else
    # the global minimum (argmax / argmin return the first index)
    nxt = F.pad(cmndf[..., 1:], (0, 1), value=torch.inf)
    under = (cmndf < threshold) & (cmndf <= nxt)
    tau_star = torch.where(under.any(dim=-1), under.int().argmax(dim=-1),
                           cmndf.argmin(dim=-1))

    # parabolic interpolation around tau_star
    def at(tau):
        return torch.gather(cmndf, -1, tau.clamp(0, tau_max - 1)[..., None])[..., 0]

    d0, d1, d2 = at(tau_star - 1), at(tau_star), at(tau_star + 1)
    denom = d0 + d2 - 2 * d1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (d0 - d2) / denom,
                        torch.zeros_like(denom))
    tau_ref = tau_star + torch.clamp(delta, -0.5, 0.5)

    f0 = sr / torch.maximum(tau_ref, torch.full_like(tau_ref, 1e-3))
    voiced = (d1 < threshold * 2.5) & (f0 >= fmin) & (f0 <= fmax)
    energetic = p0 > 1e-6 * win  # frames of negligible energy are unvoiced
    return torch.where(voiced & energetic, f0, torch.zeros_like(f0))


def log_f0_plus1(f0):
    """The reference's log-f0 convention: log(f0 + 1)."""
    return torch.log(f0 + 1.0)
