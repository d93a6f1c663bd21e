"""AR-stack data pipeline: phoneme / semantic-token pairs.

The port's own copy of `megatts2_hierspeechpp_tpu/ar/dataset.py` (reference
AR/data/dataset.py Text2SemanticDataset): reads `2-name2text.txt`
(name\\tphonemes) and `6-name2semantic.tsv` (name\\tids), filters by seconds
(25 Hz semantic rate) and phoneme/semantic ratio, drops items with unknown
symbols, pads phoneme + semantic ids and zero-fills absent BERT features.
Bucketing is data/dataset.DistributedBucketSampler. Numpy only; the trainer
moves the batches to the device.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


class Text2SemanticDataset:
    def __init__(
        self,
        phoneme_path: str,
        semantic_path: str,
        phoneme_to_id: Dict[str, int],
        hz: int = 25,
        max_sec: int = 54,
        min_ps_ratio: float = 3.0,
        max_ps_ratio: float = 25.0,
        pad_id: int = 0,
        bert_dir: str | None = None,
    ):
        """bert_dir: optional `3-bert/` sidecar dir (cli/prepare_text.py);
        per-item (n_phones, 1024) features are loaded lazily in __getitem__
        and zero-filled by collate when absent — the reference's default
        (AR/data/dataset.py:249)."""
        self.pad_id = pad_id
        self.bert_dir = bert_dir
        name2text = {}
        with open(phoneme_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) >= 2:
                    name2text[parts[0]] = parts[1]
        self.items: List[Dict] = []
        with open(semantic_path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2 or parts[0] not in name2text:
                    continue
                semantic = [int(t) for t in parts[1].split() if t.strip()]
                phones = name2text[parts[0]].split()
                try:
                    ph_ids = [phoneme_to_id[p] for p in phones]
                except KeyError:
                    continue
                sec = len(semantic) / hz
                if sec > max_sec or len(ph_ids) == 0:
                    continue
                ratio = len(semantic) / len(ph_ids)
                if not (min_ps_ratio <= ratio <= max_ps_ratio):
                    continue
                self.items.append({"name": parts[0], "phones": ph_ids,
                                   "semantic": semantic})

    def __len__(self):
        return len(self.items)

    def lengths(self) -> List[int]:
        return [len(it["semantic"]) for it in self.items]

    def __getitem__(self, idx: int) -> Dict:
        item = self.items[idx]
        if self.bert_dir is not None and "bert" not in item:
            path = f"{self.bert_dir}/{item['name']}.npy"
            try:
                feats = np.load(path).astype(np.float32)
                if feats.shape[0] == len(item["phones"]):
                    item["bert"] = feats
            except FileNotFoundError:
                pass
        return item


def collate(batch: Sequence[Dict], bert_dim: int = 1024,
            pad_multiple: int = 8) -> Dict[str, np.ndarray]:
    b = len(batch)
    nx = max(len(d["phones"]) for d in batch)
    ny = max(len(d["semantic"]) for d in batch)
    nx = ((nx + pad_multiple - 1) // pad_multiple) * pad_multiple
    ny = ((ny + pad_multiple - 1) // pad_multiple) * pad_multiple
    out = {
        "x_ids": np.zeros((b, nx), np.int32),
        "x_lens": np.zeros((b,), np.int32),
        "y_ids": np.zeros((b, ny), np.int32),
        "y_lens": np.zeros((b,), np.int32),
        # reference zero-fills BERT features when absent (AR/data/dataset.py)
        "bert_feature": np.zeros((b, nx, bert_dim), np.float32),
    }
    for i, d in enumerate(batch):
        out["x_ids"][i, : len(d["phones"])] = d["phones"]
        out["x_lens"][i] = len(d["phones"])
        out["y_ids"][i, : len(d["semantic"])] = d["semantic"]
        out["y_lens"][i] = len(d["semantic"])
        if "bert" in d:
            out["bert_feature"][i, : d["bert"].shape[0]] = d["bert"]
    return out
