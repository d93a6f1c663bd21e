"""k-means initialisation of the RVQ codebooks, on the host.

The port's own copy of `megatts2_hierspeechpp_tpu/ops/kmeans.py` (reference
core_vq.py:71-93,140-151): on the first training batch, k-means (at most 500
samples, 50 iterations) fits each residual stage's codebook, and the
centroids become `embed` / `embed_avg`, the final bin counts
`cluster_size`. It runs once before training (cli/train_s2.py), not inside
the first forward.
"""
from __future__ import annotations

import numpy as np
import torch


def kmeans(samples: np.ndarray, num_clusters: int, num_iters: int = 50,
           max_samples: int = 500, seed: int = 0):
    """samples: (N, D) -> (centroids (C, D), bin_counts (C,)), float32."""
    rng = np.random.default_rng(seed)
    samples = np.asarray(samples, np.float32)[:max_samples]
    n = samples.shape[0]
    if n >= num_clusters:
        idx = rng.permutation(n)[:num_clusters]
    else:
        idx = rng.integers(0, n, (num_clusters,))
    means = samples[idx]

    bins = np.zeros(num_clusters, np.int64)
    for _ in range(num_iters):
        d2 = ((samples[:, None, :] - means[None, :, :]) ** 2).sum(-1)
        buckets = np.argmin(d2, axis=1)
        bins = np.bincount(buckets, minlength=num_clusters)
        zero = bins == 0
        denom = np.maximum(bins, 1)
        new_means = np.zeros_like(means)
        np.add.at(new_means, buckets, samples)
        new_means = new_means / denom[:, None]
        means = np.where(zero[:, None], means, new_means)
    return means.astype(np.float32), bins.astype(np.float32)


@torch.no_grad()
def init_rvq_state(quantizer, samples: np.ndarray, seed: int = 0) -> None:
    """Fit every stage of `quantizer` (nn/quantize.ResidualVectorQuantizer)
    by k-means, in place: stage i on what stages < i left unexplained of
    `samples` (N, D), as the reference's loop."""
    residual = np.asarray(samples, np.float32)
    for layer in quantizer.vq.layers:
        cb = layer._codebook
        centroids, counts = kmeans(residual, cb.embed.shape[0], seed=seed)
        cb.embed.copy_(torch.from_numpy(centroids))
        cb.embed_avg.copy_(torch.from_numpy(centroids))
        cb.cluster_size.copy_(torch.from_numpy(counts))
        cb.inited.fill_(1.0)
        d2 = ((residual[:, None, :] - centroids[None, :, :]) ** 2).sum(-1)
        residual = residual - centroids[np.argmin(d2, axis=1)]
