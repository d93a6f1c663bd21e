"""Traffic of a cell, generated from its data file and the run's seed.

One general generator reads a traffic file (portbench/traffic/<cell>.json):

  kind               "open" (Poisson arrivals at rate_rps) or "closed"
                     (`clients` callers, each sending its next request when
                     the last returns)
  speech_s           the request lengths in seconds of speech: "lognormal"
                     (median, sigma) or "uniform", clipped to [min, max]
  voices, prompt_s   number of voices and the range of their prompt
                     lengths; voice_zipf_s picks voices by a Zipf law
                     (0: evenly)
  syllables_per_s, phrase_syllables   the calibration texts' speaking rate
                     and the texts' phrases
  calibration        `texts` texts per voice, `seconds` long each, whose
                     mean frame count sets the run's length_scale
                     (`frames`, within `tol`); each voice's own mean then
                     sets the syllables per second of its requests' texts,
                     so that every request asks for its speech_s at 50
                     frames a second
  expected_rps       (closed) the request rate the pool of requests is sized for
  warmup             [rows, seconds of speech] calls made before the window
  check_rows         rows of the window whose codes and waveform the
                     reference judges
  dur_rows           rows of the window whose durations it judges
  trace_s            the last seconds of the window a traced run profiles
  drain_s            how long past the window a request may still return
  output_sr          the requested sample rate

Every seed gets the same multiset of sizes and arrival gaps, in another
order (quantile grids, permuted), so seeds change which text and voice a
request has, not how much work the window holds. Texts are seeded
Mandarin phone strings at 5.18 syllables per second (Pellegrino, Coupe and
Marsico 2011), an "sp" phrase break every 8 syllables; prompts are
synthetic voices: a gliding harmonic tone over noise, f0 drawn per voice.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench.reference.frontend import FINALS, INITIALS

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"
BLOCK = 64   # closed-loop requests per block of one size grid


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    s = int(seed)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, *stream])


def tts_text(rng: np.random.Generator, seconds: float, syl_per_s: float,
             phrase: int) -> str:
    n_syl = max(1, round(seconds * syl_per_s))
    ini = rng.integers(0, len(INITIALS), n_syl)
    fin = rng.integers(0, len(FINALS), n_syl)
    tone = rng.integers(1, 6, n_syl)
    words = []
    for i in range(n_syl):
        if i and i % phrase == 0:
            words.append("sp")
        elif i and i % 2 == 0:
            words.append("#1")
        words.append(f"{INITIALS[ini[i]]} {FINALS[fin[i]]}{tone[i]}")
    return "sil " + " ".join(words) + " sil"


def prompt_audio(rng: np.random.Generator, seconds: float, f0: float) -> np.ndarray:
    """A synthetic 16 kHz voice: harmonics 1-5 of an f0 gliding +-1/3 at
    0.5 Hz, plus noise."""
    n = int(round(seconds * 16000))
    t = np.arange(n) / 16000.0
    f = f0 * (1.0 + np.sin(2 * np.pi * 0.5 * t) / 3.0)
    phase = 2 * np.pi * np.cumsum(f) / 16000.0
    y = sum(0.2 / h * np.sin(h * phase) for h in range(1, 6))
    return (y + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _quantiles(spec: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "uniform":
        return lo + (hi - lo) * q
    if spec["dist"] == "lognormal":
        from statistics import NormalDist
        z = np.array([NormalDist().inv_cdf(float(p)) for p in q])
        return np.clip(spec["median"] * np.exp(spec["sigma"] * z), lo, hi)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _voice_counts(n: int, voices: int, zipf_s: float) -> np.ndarray:
    p = 1.0 / np.arange(1, voices + 1) ** zipf_s if zipf_s else np.ones(voices)
    p = p / p.sum()
    counts = np.floor(n * p).astype(int)
    for i in np.argsort(-(n * p - counts))[:n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.arange(voices), counts)


@dataclass
class Request:
    index: int
    text: str
    voice: int
    speech_s: float
    due: float = 0.0   # seconds after the window opens (open loop)


@dataclass
class Traffic:
    spec: dict
    seed: int
    prompts: list            # per voice: 16 kHz audio
    calibration_texts: list  # per voice, its list of texts
    requests: list = field(default_factory=list)   # open: all due; closed: a pool
    rates: list = field(default_factory=list)      # per voice: syllables per second

    def text(self, i: int, seconds: float, voice: int) -> str:
        return tts_text(rng_for(self.seed, 3, i), seconds, self.rates[voice],
                        self.spec["phrase_syllables"])


def make(spec: dict, seed: int, seconds: float) -> Traffic:
    """The run's voices, calibration text and requests."""
    rng = rng_for(seed, 1)
    nv = spec["voices"]
    lo, hi = spec["prompt_s"]
    lens = lo + (hi - lo) * (np.arange(nv) + 0.5) / nv
    lens = lens[rng.permutation(nv)]
    f0s = rng.uniform(100.0, 220.0, nv)
    prompts = [prompt_audio(rng_for(seed, 2, v), float(lens[v]), float(f0s[v]))
               for v in range(nv)]
    cal = spec["calibration"]
    crng = rng_for(seed, 4)
    tr = Traffic(spec, seed, prompts,
                 [[tts_text(crng, cal["seconds"], spec["syllables_per_s"],
                            spec["phrase_syllables"]) for _ in range(cal["texts"])]
                  for _ in range(nv)])
    tr.seconds = seconds
    if spec["kind"] == "open":
        n = max(1, round(spec["rate_rps"] * seconds))
        order = rng_for(seed, 5)
        sizes = _quantiles(spec["speech_s"], n)[order.permutation(n)]
        voices = _voice_counts(n, nv, spec.get("voice_zipf_s", 0))[order.permutation(n)]
        gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / spec["rate_rps"]
        due = np.cumsum(gaps[order.permutation(n)]) - gaps.min() / 2
        tr.requests = [Request(i, "", int(voices[i]), float(sizes[i]), float(due[i]))
                       for i in range(n)]
    elif spec["kind"] == "closed":
        # enough for the window at ten times the rate the cell was sized for
        n_blocks = max(1, math.ceil(10 * spec["expected_rps"] * seconds / BLOCK))
        order = rng_for(seed, 6)
        grid = _quantiles(spec["speech_s"], BLOCK)
        vgrid = _voice_counts(BLOCK, nv, spec.get("voice_zipf_s", 0))
        reqs = []
        for b in range(n_blocks):
            sizes, voices = grid[order.permutation(BLOCK)], vgrid[order.permutation(BLOCK)]
            for j in range(BLOCK):
                i = b * BLOCK + j
                reqs.append(Request(i, "", int(voices[j]), float(sizes[j])))
        tr.requests = reqs
    else:
        raise ValueError(f"unknown traffic kind {spec['kind']!r}")
    return tr


def set_rates(tr: Traffic, frames: list, frames_per_s: float = 50.0) -> None:
    """Each voice's syllables per second, from the frames its calibration
    text gave, and the texts of the requests the window will need (an
    open loop's all; a closed loop's pool, as far as one and a half times
    the rate it is sized for reaches)."""
    n_syl = max(1, round(tr.spec["calibration"]["seconds"] * tr.spec["syllables_per_s"]))
    tr.rates = [frames_per_s * n_syl / f for f in frames]
    reqs = tr.requests
    if tr.spec["kind"] == "closed":
        reqs = reqs[:math.ceil(1.5 * tr.spec["expected_rps"] * tr.seconds) + tr.spec["clients"]]
    for r in reqs:
        text_of(tr, r)


def text_of(tr: Traffic, req: Request) -> str:
    """The request's text (made when first needed: a closed-loop pool is
    larger than any window uses)."""
    if not req.text:
        req.text = tr.text(req.index, req.speech_s, req.voice)
    return req.text
