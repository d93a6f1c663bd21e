"""PNG plots for the training CLIs' eval hooks.

The port's own copy of `megatts2_hierspeechpp_tpu/utils/plotting.py`
(reference utils.py:79-154 sent matplotlib images to TensorBoard; these
write PNG files beside the JSONL scalars). matplotlib is imported when a
plot is drawn, so the hooks run without it when plotting is off.
"""
from __future__ import annotations

import os

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def save_spectrogram_plot(spec: np.ndarray, path: str, title: str = ""):
    """spec: (T, n_mels) or (n_mels, T)."""
    plt = _pyplot()
    if spec.shape[0] > spec.shape[1]:
        spec = spec.T
    fig, ax = plt.subplots(figsize=(10, 3))
    im = ax.imshow(spec, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    ax.set_title(title)
    ax.set_xlabel("frames")
    ax.set_ylabel("channels")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def save_f0_plot(f0_target: np.ndarray, f0_pred: np.ndarray, path: str):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(f0_target, label="target", alpha=0.8)
    ax.plot(f0_pred, label="pred", alpha=0.8)
    ax.legend()
    ax.set_xlabel("frames (200 Hz)")
    ax.set_ylabel("f0 (Hz)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
