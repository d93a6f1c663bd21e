"""Training data: filelists, sidecar features, MRTE prompt pairs,
deterministic length-bucketed batches.

The port's copy of `megatts2_hierspeechpp_tpu/data/dataset.py` (behaviour of
reference data_utils.py):
  - filelist-of-filelists, lines `wav|spk|phonemes`; the MRTE prompt is the
    mels of the next two utterances of the same list;
  - sidecars beside each wav: .hw2v.npy/.pt (w2v), .hf0.npy (200 Hz f0),
    .hmel.npy (80-mel), .dur.npy (phone durations in seconds);
  - per item: w2v padded to a multiple of 8, mel to the w2v length, pitch
    to 4x it; durations to 10 ms frames with the rounding error folded into
    the first / last phone;
  - `collate`: sorted by length, zero-padded to multiples of a bucket size;
  - a length-bucketed, epoch-seeded batch sampler.
"""
from __future__ import annotations

import logging
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from megatts2_hierspeechpp_torch.data import text as text_frontend

log = logging.getLogger("megatts2")


def load_filelists(list_of_lists_path: str) -> List[List[str]]:
    """train_list.txt contains paths of per-corpus transcript files; each line
    there is `wav|spk|phonemes`. Returns entries
    [wav, spk, text, mrte_wav1+mrte_wav2]."""
    with open(list_of_lists_path, encoding="utf-8") as f:
        sublists = [l.strip() for l in f if l.strip()]
    out = []
    for sub in sublists:
        with open(sub, encoding="utf-8") as f:
            rows = [l.strip().split("|") for l in f if l.strip()]
        n = len(rows)
        for i, row in enumerate(rows):
            first = rows[i + 1][0] if i + 1 < n else row[0]
            second = rows[i + 2][0] if i + 2 < n else row[0]
            if os.path.exists(_sidecar(first, ".hmel.npy")) and os.path.exists(
                _sidecar(second, ".hmel.npy")
            ):
                out.append(row + [first + "+" + second])
            else:
                out.append(row + [row[0]])
    return out


def _sidecar(wav_path: str, suffix: str) -> str:
    return wav_path.replace(".wav", suffix)


def _load_feature(path: str) -> np.ndarray:
    if os.path.exists(path):
        return np.load(path)
    pt = path.replace(".npy", ".pt")
    if os.path.exists(pt):
        import torch

        return torch.load(pt, map_location="cpu", weights_only=True).numpy()
    raise FileNotFoundError(path)


def durations_to_frames(dur_sec: np.ndarray, total_frames: int) -> np.ndarray:
    """MFA seconds -> 10 ms frames with reference-exact rounding-error
    redistribution (data_utils.py:369-382): a deficit is split half onto the
    first phone and the rest onto the last; a surplus comes off the last
    phone. Deviation (documented): where the reference lets dur[-1] go
    negative on a large surplus, we clip at zero and take the remainder from
    the longest phones so sum(frames) == total_frames always holds (Gaussian
    upsampling centers must stay inside the frame budget)."""
    frames = np.round(np.asarray(dur_sec, np.float64) / 0.010).astype(np.int64)
    err = int(total_frames - frames.sum())
    if err > 0:
        begin = err // 2
        frames[0] += begin
        frames[-1] += err - begin
    elif err < 0:
        frames[-1] += err
        while frames.min() < 0:
            neg_i = int(frames.argmin())
            deficit = int(frames[neg_i])
            frames[neg_i] = 0
            frames[int(frames.argmax())] += deficit
    assert int(frames.sum()) == total_frames, (int(frames.sum()), total_frames)
    return frames


@dataclass
class DatasetConfig:
    max_w2v_frames: int = 900  # 18 s at 50 Hz (data_utils.py:207-209)
    min_w2v_frames: int = 50
    max_text_len: int = 800
    mrte_max_frames: int = 1200  # 24 s cap (data_utils.py:209)
    dur_tolerance: int = 3


class SidecarDataset:
    """Indexable dataset over sidecar features (no torch dependency)."""

    def __init__(self, filelist_path: str, cfg: DatasetConfig = DatasetConfig(),
                 seed: int = 1234):
        self.cfg = cfg
        self.rng = random.Random(seed)
        entries = load_filelists(filelist_path)
        self.items = [e for e in entries if self._valid(e)]

    def _valid(self, entry) -> bool:
        """Existence + tolerance filtering (reference data_utils.py:241-272:
        mis-aligned items are *dropped with a log line*, never silently
        truncated): |2*w2v_frames - sum(dur_frames)| must be within
        2*dur_tolerance, and the phone-duration count must match the text."""
        wav = entry[0]
        for suffix in (".hf0.npy", ".hmel.npy", ".dur.npy"):
            if not os.path.exists(_sidecar(wav, suffix)):
                return False
        if not (
            os.path.exists(_sidecar(wav, ".hw2v.npy"))
            or os.path.exists(_sidecar(wav, ".hw2v.pt"))
        ):
            return False
        try:
            ids, _, _ = text_frontend.process_text(entry[2])
        except KeyError:
            return False
        if not 0 < len(ids) <= self.cfg.max_text_len:
            return False
        dur_sec = np.load(_sidecar(wav, ".dur.npy")).reshape(-1)
        if len(dur_sec) != len(ids):
            log.warning("%s: %d phone durations vs %d text symbols — dropped",
                        wav, len(dur_sec), len(ids))
            return False
        dur_frames = int(np.round(dur_sec / 0.010).sum())
        w2v_frames = self._w2v_frames(wav)
        if abs(2 * w2v_frames - dur_frames) > 2 * self.cfg.dur_tolerance:
            log.warning("%s: dur %d vs 2*w2v %d frames not aligned — dropped",
                        wav, dur_frames, 2 * w2v_frames)
            return False
        return True

    @staticmethod
    def _w2v_frames(wav: str) -> int:
        npy = _sidecar(wav, ".hw2v.npy")
        if os.path.exists(npy):
            arr = np.load(npy, mmap_mode="r")
        else:
            import torch

            arr = torch.load(_sidecar(wav, ".hw2v.pt"), map_location="cpu",
                             weights_only=True).numpy()
        shape = [s for s in arr.shape if s != 1]
        if len(shape) == 1:
            return shape[0]
        return shape[1] if shape[0] == 1024 else shape[0]

    def __len__(self):
        return len(self.items)

    def lengths(self) -> List[int]:
        """Approximate per-item w2v frame counts for bucketing (mel rows)."""
        out = []
        for e in self.items:
            mel = np.load(_sidecar(e[0], ".hmel.npy"), mmap_mode="r")
            out.append(int(mel.shape[-1] if mel.shape[0] == 80 else mel.shape[0]))
        return out

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        wav, _spk, text = self.items[idx][:3]
        mrte_ref = self.items[idx][3]

        ids, tones, langs = text_frontend.process_text(text)

        w2v = _load_feature(_sidecar(wav, ".hw2v.npy")).astype(np.float32)
        if w2v.ndim == 3:
            w2v = w2v[0]
        if w2v.shape[0] == 1024:  # stored (C, T) -> (T, C)
            w2v = w2v.T
        mel = np.load(_sidecar(wav, ".hmel.npy")).astype(np.float32)
        if mel.ndim == 3:
            mel = mel[0]
        if mel.shape[0] == 80:
            mel = mel.T  # (T, 80)
        f0 = np.load(_sidecar(wav, ".hf0.npy")).astype(np.float32).reshape(-1)

        # pad w2v to a multiple of 8; align mel and f0 to it
        t = w2v.shape[0]
        t8 = ((t + 7) // 8) * 8
        if t8 > t:
            w2v = np.pad(w2v, ((0, t8 - t), (0, 0)))
        mel = mel[:t8]
        if mel.shape[0] < t8:
            mel = np.pad(mel, ((0, t8 - mel.shape[0]), (0, 0)))
        f0 = f0[: 4 * t8]
        if f0.shape[0] < 4 * t8:
            f0 = np.pad(f0, (0, 4 * t8 - f0.shape[0]))

        dur_sec = np.load(_sidecar(wav, ".dur.npy")).reshape(-1)
        dur = durations_to_frames(dur_sec, 2 * t8)
        # length mismatch is filtered in _valid (reference drops, we drop)
        assert len(dur) == len(ids), (wav, len(dur), len(ids))

        mrte_mel = self._mrte_mel(mrte_ref)

        return {
            "x_ids": np.asarray(ids, np.int32),
            "tone": np.asarray(tones, np.int32),
            "language": np.asarray(langs, np.int32),
            "w2v": w2v,
            "mel": mel,
            "pitch": f0,
            "dur": dur.astype(np.float32),
            "mrte_mel": mrte_mel,
        }

    def _mrte_mel(self, ref: str) -> np.ndarray:
        """Concat neighbor-mel prompt, random half-slice, cap at 1200 frames
        (data_utils.py get_w2v mrte construction)."""
        parts = []
        for wav in ref.split("+"):
            m = np.load(_sidecar(wav, ".hmel.npy")).astype(np.float32)
            if m.ndim == 3:
                m = m[0]
            if m.shape[0] == 80:
                m = m.T
            parts.append(m)
        mel = np.concatenate(parts, axis=0)
        t = mel.shape[0]
        half = t // 2
        if half > 4:
            start = self.rng.randint(0, t - half)
            mel = mel[start : start + half]
        return mel[: self.cfg.mrte_max_frames]


def _round_up(v: int, multiple: int) -> int:
    return (v + multiple - 1) // multiple * multiple


def collate(batch: Sequence[Dict[str, np.ndarray]], pad_multiple: int = 8,
            text_pad_multiple: int = 8) -> Dict[str, np.ndarray]:
    """Zero-pad items into dense numpy arrays, sorted by w2v length
    (longest first); the frame axes padded to a multiple of pad_multiple,
    the phone axis to one of text_pad_multiple. Keys: x_ids, tone,
    language, x_lengths, w2v, w2v_lengths, mel, mel_lengths, pitch,
    pitch_lengths (4x the frames), dur, mrte_mel, mrte_mel_lengths."""
    batch = sorted(batch, key=lambda d: d["w2v"].shape[0], reverse=True)
    b = len(batch)
    t_max = _round_up(max(d["w2v"].shape[0] for d in batch), pad_multiple)
    n_max = _round_up(max(len(d["x_ids"]) for d in batch), text_pad_multiple)
    m_max = _round_up(max(d["mrte_mel"].shape[0] for d in batch), pad_multiple)
    i32, f32 = np.int32, np.float32
    out = {
        "x_ids": np.zeros((b, n_max), i32), "tone": np.zeros((b, n_max), i32),
        "language": np.zeros((b, n_max), i32), "x_lengths": np.zeros((b,), i32),
        "w2v": np.zeros((b, t_max, 1024), f32), "w2v_lengths": np.zeros((b,), i32),
        "mel": np.zeros((b, t_max, 80), f32), "mel_lengths": np.zeros((b,), i32),
        "pitch": np.zeros((b, 4 * t_max), f32), "pitch_lengths": np.zeros((b,), i32),
        "dur": np.zeros((b, n_max), f32),
        "mrte_mel": np.zeros((b, m_max, 80), f32),
        "mrte_mel_lengths": np.zeros((b,), i32),
    }
    for i, d in enumerate(batch):
        n, t, m = len(d["x_ids"]), d["w2v"].shape[0], d["mrte_mel"].shape[0]
        for k in ("x_ids", "tone", "language"):
            out[k][i, :n] = d[k]
        out["x_lengths"][i] = n
        out["w2v"][i, :t] = d["w2v"]
        out["mel"][i, :t] = d["mel"]
        out["w2v_lengths"][i] = out["mel_lengths"][i] = t
        out["pitch"][i, :4 * t] = d["pitch"][:4 * t]
        out["pitch_lengths"][i] = 4 * t
        out["dur"][i, :n] = d["dur"][:n]
        out["mrte_mel"][i, :m] = d["mrte_mel"]
        out["mrte_mel_lengths"][i] = m
    return out


class DistributedBucketSampler:
    """Deterministic length-bucketed batch sampler with per-host sharding.

    VITS-style (data_utils.py:533-633): items grouped into length buckets,
    shuffled per-epoch with a seeded generator, padded to a world-divisible
    count, then round-robin subsampled per host.
    """

    def __init__(self, lengths: Sequence[int], batch_size: int,
                 boundaries: Sequence[int], num_replicas: int = 1, rank: int = 0,
                 seed: int = 1234):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.boundaries = list(boundaries)
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.buckets = self._bucketize()

    def _bucketize(self):
        buckets = [[] for _ in range(len(self.boundaries) - 1)]
        for idx, l in enumerate(self.lengths):
            for bi in range(len(self.boundaries) - 1):
                if self.boundaries[bi] < l <= self.boundaries[bi + 1]:
                    buckets[bi].append(idx)
                    break
        return [b for b in buckets if b]

    def epoch_batches(self, epoch: int) -> List[List[int]]:
        rng = np.random.default_rng(self.seed + epoch)
        all_batches = []
        for bucket in self.buckets:
            ids = list(bucket)
            rng.shuffle(ids)
            world = self.num_replicas * self.batch_size
            # cycle-pad up to a world-divisible count (data_utils.py:599-600);
            # small buckets repeat rather than starve
            rem = (-len(ids)) % world
            if rem:
                ids = ids + ids * (rem // len(ids)) + ids[: rem % len(ids)]
            shard = ids[self.rank :: self.num_replicas]
            for i in range(0, len(shard) - self.batch_size + 1, self.batch_size):
                all_batches.append(shard[i : i + self.batch_size])
        order = rng.permutation(len(all_batches))
        return [all_batches[i] for i in order]
