"""GPT-SoVITS dataset stage 1: the phoneme table and optional BERT
sidecars (prepare_datasets/1-get-text.py equivalent).

The port's own copy of `megatts2_hierspeechpp_tpu/cli/prepare_text.py`
(it imports nothing of the JAX package; `main(argv)` is the port's
addition). It reads a pre-phonemized `wav|spk|lang|phonemes[|raw_text]`
filelist (lines of fewer than 4 columns are skipped), cleans each phoneme
string as data/text.py does (prosody tags, eos and stress digits stripped)
and writes `{opt_dir}/2-name2text-{i}.txt`, rows
name\\tphones\\tword2ph\\tnorm_text, the name being the wav's basename with
its extension (JAX prepare_text.py:87; cli/prepare_semantic names a row by
the stem, so the two tables do not join: a fault of the JAX package that
the port keeps).

With --bert_ckpt (a chinese-roberta-wwm-ext-large-style HF dir; the
`transformers` package is imported only then) and a 5th raw-text column on
zh lines, per-phone BERT features: hidden_states[-3] without CLS/SEP,
spread over the phones evenly per character, saved as
{opt_dir}/3-bert/{name}.npy (n_phones, hidden). The BERT forward runs on
the card unless `--device cpu` (a deliberate addition, as in the port's
other entry points); without --bert_ckpt nothing is computed on a device.
"""
from __future__ import annotations

import argparse
import os
import re

import numpy as np


def clean_phonemes(text: str) -> list[str]:
    """data/text.py process_text's normalization, returning symbols."""
    text = re.sub(r"#0|#1|#3|#4", "", text)
    text = re.sub(r"eos", "", text)
    text = re.sub(r"([a-zA-Z])\d", r"\1", text)
    return [t for t in text.split() if t]


def even_word2ph(n_chars: int, n_phones: int) -> list[int]:
    """Distribute n_phones over n_chars as evenly as possible."""
    base, extra = divmod(n_phones, n_chars)
    return [base + (1 if i < extra else 0) for i in range(n_chars)]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--filelist", required=True,
                   help="lines: wav|spk|lang|phonemes[|raw_text]")
    p.add_argument("--opt_dir", required=True)
    p.add_argument("--bert_ckpt", default=None,
                   help="HF masked-LM dir (chinese-roberta family); BERT "
                        "sidecars are skipped if absent")
    p.add_argument("--shard", default="0/1", help="i/n fan-out")
    p.add_argument("--device", default="cuda",
                   help="where the BERT forward runs (with --bert_ckpt)")
    args = p.parse_args(argv)
    shard_i, shard_n = (int(v) for v in args.shard.split("/"))

    os.makedirs(args.opt_dir, exist_ok=True)
    bert = None
    if args.bert_ckpt:
        import torch

        from megatts2_hierspeechpp_torch.device import resolve_device

        dev = resolve_device(args.device)   # raises before anything loads
        from transformers import AutoModelForMaskedLM, AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.bert_ckpt)
        model = AutoModelForMaskedLM.from_pretrained(args.bert_ckpt).eval().to(dev)
        bert_dir = os.path.join(args.opt_dir, "3-bert")
        os.makedirs(bert_dir, exist_ok=True)

        def bert(norm_text: str) -> np.ndarray:
            with torch.no_grad():
                inputs = tokenizer(norm_text, return_tensors="pt")
                res = model(**{k: v.to(dev) for k, v in inputs.items()},
                            output_hidden_states=True)
            # hidden_states[-3:-2] cat == hidden_states[-3]; drop CLS/SEP
            return res["hidden_states"][-3][0, 1:-1].cpu().numpy()

    rows = []
    with open(args.filelist, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    for idx, line in enumerate(lines):
        if idx % shard_n != shard_i:
            continue
        parts = line.split("|")
        if len(parts) < 4:
            print("skip (need wav|spk|lang|phonemes):", line[:60])
            continue
        wav_path, _spk, lang, phon_text = parts[:4]
        raw_text = parts[4] if len(parts) > 4 else ""
        name = os.path.basename(wav_path)
        phones = clean_phonemes(phon_text)
        if not phones:
            continue
        word2ph: list[int] = [1] * len(phones)
        if bert is not None and raw_text and lang.lower() in ("zh", "1"):
            feats_char = bert(raw_text)
            if feats_char.shape[0] > 0:
                word2ph = even_word2ph(feats_char.shape[0], len(phones))
                feats_ph = np.repeat(feats_char, word2ph, axis=0)
                assert feats_ph.shape[0] == len(phones)
                np.save(os.path.join(args.opt_dir, "3-bert", name + ".npy"),
                        feats_ph.astype(np.float32))
        rows.append("%s\t%s\t%s\t%s" % (name, " ".join(phones), word2ph,
                                        raw_text or phon_text))

    out_path = os.path.join(args.opt_dir, "2-name2text-%d.txt" % shard_i)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    print("wrote %d rows -> %s" % (len(rows), out_path))
    return out_path


if __name__ == "__main__":
    main()
