"""Semantic-code extraction CLI (3-get-semantic-s.py equivalent).

The port's counterpart of `megatts2_hierspeechpp_tpu/cli/prepare_semantic.py`:
walks a directory tree and for every `.hmel.npy` sidecar ((T, 80), or
(80, T), which is transposed) writes a `.semantic.npy` of RVQ prosody-code
ids from a trained s2 acoustic model (TTVModel.pooled_prosody_codes: mel[:20]
-> plm convs -> pool 8 -> RVQ encode) on the mel cropped to a multiple of 8
frames, and the AR-stack `6-name2semantic.tsv` if --tsv_out is given, a row
per sidecar named by its stem (`utt0000` for `utt0000.hmel.npy`). The model
comes from a reference TTV `.pth` (infer/pipeline.load_torch_checkpoint and
load_reference); any other path exits, as in JAX. On the card unless
`--device cpu` (a deliberate addition, with `main(argv)`).

Usage: python -m megatts2_hierspeechpp_torch.cli.prepare_semantic \
    --mel_dir corpus/ --s2_ckpt ttv.pth [--tsv_out 6-name2semantic.tsv]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from megatts2_hierspeechpp_torch.data import text as tf
from megatts2_hierspeechpp_torch.device import resolve_device
from megatts2_hierspeechpp_torch.infer.pipeline import (
    load_reference,
    load_torch_checkpoint,
)
from megatts2_hierspeechpp_torch.models.ttv import TTVModel


def load_ttv(path: str, device) -> TTVModel:
    if not path.endswith(".pth"):
        raise SystemExit("pass a reference ttv .pth (dir restore: use train_s1)")
    ttv = TTVModel(n_vocab=tf.N_VOCAB, n_tone=tf.N_TONE,
                   n_language=tf.N_LANGUAGE, device="cpu")
    return load_reference(ttv, load_torch_checkpoint(path)).to(device)


@torch.inference_mode()
def codes_of(ttv: TTVModel, mel: np.ndarray, device) -> np.ndarray:
    """mel (T, 80) -> pooled-rate code ids (T // 8,) int32."""
    t8 = (mel.shape[0] // 8) * 8
    x = torch.from_numpy(np.ascontiguousarray(mel[None, :t8])).to(device)
    lengths = torch.full((1,), t8, dtype=torch.int32, device=device)
    return ttv.pooled_prosody_codes(x, lengths)[0].cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mel_dir", required=True)
    p.add_argument("--s2_ckpt", required=True,
                   help="reference ttv .pth or an s2 checkpoint dir")
    p.add_argument("--tsv_out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ttv = load_ttv(args.s2_ckpt, dev)

    rows = []
    for base, _dirs, files in os.walk(args.mel_dir):
        for f in files:
            if not f.endswith(".hmel.npy"):
                continue
            path = os.path.join(base, f)
            out_path = path.replace(".hmel.npy", ".semantic.npy")
            mel = np.load(path).astype(np.float32)
            if mel.shape[0] == 80:
                mel = mel.T
            codes = codes_of(ttv, mel, dev)
            np.save(out_path, codes.astype(np.int32))
            rows.append((os.path.splitext(f)[0].replace(".hmel", ""),
                         " ".join(map(str, codes.tolist()))))
            print(out_path)

    if args.tsv_out:
        with open(args.tsv_out, "w", encoding="utf-8") as fh:
            for name, seq in rows:
                fh.write(f"{name}\t{seq}\n")
    return rows


if __name__ == "__main__":
    main()
