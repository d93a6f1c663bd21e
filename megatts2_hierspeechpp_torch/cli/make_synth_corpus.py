"""Synthesize a structured sidecar corpus for training validation.

Generates N utterances whose features are *learnable functions of the text*
(unlike pure noise, losses genuinely converge), in the exact sidecar contract
of data/dataset.py (reference data_utils.py:186-320):

  - text: random phone strings over the in-repo symbol table, Mandarin tone
    digits + CMU stress digits included so every tone path is exercised;
  - audio: per-phone harmonic stacks — phone identity fixes the harmonic
    amplitude profile, tone fixes the f0 contour — concatenated and
    cross-faded, written as 16 kHz int16 wav;
  - .hmel.npy: real log-mel of that audio (ops/stft.py
    mel_spectrogram_fixed on the CPU, 80 x T);
  - .hf0.npy: the *known* synthesis f0 contour at 200 Hz (4T,);
  - .hw2v.npy: deterministic per-phone embeddings + a mel-derived component
    (1024 x T) so the TTV text->w2v task has signal;
  - .dur.npy: per-phone durations in seconds summing to the frame budget.

The port's copy of `megatts2_hierspeechpp_tpu/cli/make_synth_corpus.py`:
the same seed writes the same corpus (the mels, and the w2v features made
from them, to float rounding).

Usage:
  python -m megatts2_hierspeechpp_torch.cli.make_synth_corpus \
      --out_dir <dir> --n 300
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy.io import wavfile

SR = 16000
HOP = 320  # 50 Hz frames; durations counted at 100 Hz (2x), f0 at 200 Hz (4x)

ZH_PHONES = ["b", "d", "g", "zh", "sh", "x", "l", "m", "n", "h",
             "a", "ai", "an", "ang", "e", "i", "ong", "ou", "u", "uo"]
ZH_FINALS = {"a", "ai", "an", "ang", "e", "i", "ong", "ou", "u", "uo"}
EN_PHONES = ["AA", "AE", "AH", "EH", "IY", "OW", "UW", "K", "S", "T", "N", "L"]
EN_VOWELS = {"AA", "AE", "AH", "EH", "IY", "OW", "UW"}
PUNCT = "。"

# tone -> f0 contour (start_hz, end_hz); tone 0/pause unvoiced
TONE_F0 = {1: (240, 240), 2: (180, 260), 3: (170, 140), 4: (280, 180),
           5: (200, 200), 6: (200, 200), 7: (250, 250), 8: (220, 220),
           9: (190, 190)}


def _phone_profile(rng: np.random.Generator, n_harm: int = 6) -> np.ndarray:
    amps = rng.uniform(0.1, 1.0, n_harm)
    return amps / amps.sum()


def synth_utterance(rng, profiles, w2v_emb, mel_fn):
    n_ph = int(rng.integers(8, 20))
    phones, tones = ["sil"], [0]
    for _ in range(n_ph):
        if rng.uniform() < 0.7:
            ph = ZH_PHONES[int(rng.integers(len(ZH_PHONES)))]
            tone = int(rng.integers(1, 6)) if ph in ZH_FINALS else 0
        else:
            ph = EN_PHONES[int(rng.integers(len(EN_PHONES)))]
            tone = int(rng.integers(7, 10)) if ph in EN_VOWELS else 6
        phones.append(ph)
        tones.append(tone)
    phones.append(PUNCT)
    tones.append(0)

    # durations at 100 Hz; total must be even (= 2 * w2v frames)
    dur100 = rng.integers(6, 20, len(phones))
    if dur100.sum() % 2:
        dur100[-1] += 1
    t50 = int(dur100.sum()) // 2

    # waveform + 200 Hz f0 track
    wav = np.zeros(t50 * HOP, np.float64)
    f0 = np.zeros(t50 * 4, np.float64)
    cursor100 = 0
    for ph, tone, d in zip(phones, tones, dur100):
        n = int(d) * (HOP // 2)  # samples per 100 Hz frame
        s0 = cursor100 * (HOP // 2)
        t = np.arange(n) / SR
        if tone in TONE_F0 and ph not in ("sil", PUNCT):
            lo, hi = TONE_F0[tone]
            track = np.linspace(lo, hi, n)
            phase = 2 * np.pi * np.cumsum(track) / SR
            seg = sum(a * np.sin((h + 1) * phase)
                      for h, a in enumerate(profiles[ph]))
            env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                             / (0.01 * SR + 1))
            wav[s0:s0 + n] = 0.3 * seg * env
            fr0 = cursor100 * 2
            f0[fr0:fr0 + int(d) * 2] = np.linspace(lo, hi, int(d) * 2)
        else:
            wav[s0:s0 + n] = 0.002 * rng.standard_normal(n)
        cursor100 += int(d)

    mel = mel_fn(wav.astype(np.float32))  # (T50, 80)
    assert mel.shape[0] == t50, (mel.shape, t50)

    # w2v: phone embedding per 50 Hz frame + mel-derived component
    frame_ph = np.repeat(np.arange(len(phones)), dur100)[::2]  # 100->50 Hz
    w2v = np.stack([w2v_emb[phones[i]] for i in frame_ph])
    w2v = w2v + 0.05 * np.tile(mel, (1, 13))[:, :1024]
    w2v = w2v + 0.01 * rng.standard_normal(w2v.shape)

    # text string with tone/stress digits (process_text strips them to the
    # tone stream); duration seconds at the 10 ms contract
    toks = []
    for ph, tone in zip(phones, tones):
        if 1 <= tone <= 5:
            toks.append(f"{ph}{tone}")
        elif 7 <= tone <= 9:
            toks.append(f"{ph}{tone - 7}")
        else:
            toks.append(ph)
    text = " ".join(toks) + " eos"
    return {
        "text": text,
        "wav": (np.clip(wav, -1, 1) * 32767).astype(np.int16),
        "mel": mel.T.astype(np.float32),  # sidecar layout (80, T)
        "f0": f0.astype(np.float32),
        "w2v": w2v.T.astype(np.float32),  # (1024, T)
        "dur": (dur100 / 100.0).astype(np.float32),
    }


def make_corpus(out_dir: str, n: int = 300, seed: int = 0,
                holdout: int = 0) -> str:
    """Write n utterances, their sidecars, the filelists and a config.json
    into out_dir; the last `holdout` utterances go to an eval split.
    Returns out_dir."""
    import torch

    from megatts2_hierspeechpp_torch.ops.stft import mel_spectrogram_fixed

    os.makedirs(out_dir, exist_ok=True)

    def mel_fn(wav):
        with torch.no_grad():
            return mel_spectrogram_fixed(torch.from_numpy(wav)[None])[0].numpy()

    rng = np.random.default_rng(seed)
    all_phones = ZH_PHONES + EN_PHONES + ["sil", PUNCT]
    profiles = {ph: _phone_profile(rng) for ph in all_phones}
    emb_rng = np.random.default_rng(seed + 1)
    w2v_emb = {ph: emb_rng.standard_normal(1024).astype(np.float32)
               for ph in all_phones}

    rows = []
    ar_rows = []
    for i in range(n):
        utt = synth_utterance(rng, profiles, w2v_emb, mel_fn)
        base = os.path.join(out_dir, f"utt{i:04d}")
        wavfile.write(base + ".wav", SR, utt["wav"])
        np.save(base + ".hmel.npy", utt["mel"])
        np.save(base + ".hf0.npy", utt["f0"])
        np.save(base + ".hw2v.npy", utt["w2v"])
        np.save(base + ".dur.npy", utt["dur"])
        rows.append(f"{base}.wav|spk{i % 8}|{utt['text']}")
        ar_rows.append((utt["text"], utt["dur"]))
        if (i + 1) % 50 == 0:
            print(f"{i + 1}/{n}")

    k = max(0, min(holdout, len(rows) - 1))
    train_rows, eval_rows = (rows[:-k], rows[-k:]) if k else (rows, [])
    trans = os.path.join(out_dir, "trans.txt")
    with open(trans, "w", encoding="utf-8") as f:
        f.write("\n".join(train_rows) + "\n")
    eval_list = None
    if eval_rows:
        trans_eval = os.path.join(out_dir, "trans_eval.txt")
        with open(trans_eval, "w", encoding="utf-8") as f:
            f.write("\n".join(eval_rows) + "\n")
        eval_list = os.path.join(out_dir, "eval_list.txt")
        with open(eval_list, "w") as f:
            f.write(trans_eval + "\n")
    # AR-stack sidecars (2-name2text.txt / 6-name2semantic.tsv): 25 Hz
    # semantic ids as a learnable function of phone identity (stable per-phone
    # base id + within-phone position), ~ceil(dur/4) tokens per phone so the
    # 3..25 tokens-per-phone ratio filter passes
    sem_base = {ph: 37 * i % 1000 for i, ph in enumerate(all_phones)}
    with open(os.path.join(out_dir, "2-name2text.txt"), "w",
              encoding="utf-8") as ft, \
         open(os.path.join(out_dir, "6-name2semantic.tsv"), "w",
              encoding="utf-8") as fs:
        for i, (text, dur) in enumerate(ar_rows):
            name = f"utt{i:04d}"
            # bare phones: the AR dataset maps tokens through SYMBOL_TO_ID,
            # which has no tone-digit variants
            phones = [t.rstrip("0123456789") for t in text.split()[:-1]]
            sem = []
            for ph, d in zip(phones, dur):
                n_tok = max(1, -(-int(round(d * 100)) // 3))  # ~4 tok/phone
                base = sem_base.get(ph, 0)
                sem.extend((base + min(j, 23)) % 1024 for j in range(n_tok))
            ft.write(f"{name}\t{' '.join(phones)}\n")
            fs.write(f"{name}\t{' '.join(map(str, sem))}\n")
    with open(os.path.join(out_dir, "train_list.txt"), "w") as f:
        f.write(trans + "\n")
    data_cfg = {"training_files": os.path.join(out_dir, "train_list.txt"),
                "sampling_rate": 16000, "filter_length": 1280,
                "hop_length": 320, "win_length": 1280,
                "n_mel_channels": 80, "mel_fmin": 0, "mel_fmax": 8000}
    if eval_list:
        data_cfg["validation_files"] = eval_list
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump({
            "train": {"log_interval": 10, "eval_interval": 100,
                      "save_interval": 200, "seed": 1234, "epochs": 100,
                      "learning_rate": 1e-4, "betas": [0.8, 0.99],
                      "eps": 1e-9, "batch_size": 8, "lr_decay": 0.95,
                      "segment_size": 163840, "c_mel": 1.0, "c_commit": 100},
            "data": data_cfg,
            # only cli/train_vocoder.py reads the model section, so it
            # carries the vocoder's widths (configs/hierspeechpp.json)
            "model": {"inter_channels": 192, "hidden_channels": 192,
                      "filter_channels": 768,
                      "spec_channels": 641,
                      "upsample_rates": [4, 5, 4, 2, 2],
                      "upsample_initial_channel": 512,
                      "upsample_kernel_sizes": [8, 11, 8, 4, 4]},
        }, f, indent=2)
    print("corpus:", out_dir)
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", required=True)
    p.add_argument("--n", type=int, default=300)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--holdout", type=int, default=0,
                   help="keep the LAST K utterances out of trans.txt as a "
                        "held-out eval split (trans_eval.txt + eval_list.txt;"
                        " config gains data.validation_files)")
    args = p.parse_args(argv)
    make_corpus(args.out_dir, args.n, args.seed, args.holdout)


if __name__ == "__main__":
    main()
