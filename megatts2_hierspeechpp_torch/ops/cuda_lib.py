"""Build, load and call the port's hand-written CUDA kernels.

All sources under `csrc/` compile with nvcc for sm_90a (one process per
source, started together) and link into one shared library with a plain C
interface, loaded with ctypes. The library is built on first use into
`build/kernels/` at the repository root, named by a hash of the sources and
flags, so an unchanged tree reuses it.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `call` raises when that is not 0.

`LAUNCHES` counts, per kernel wrapper and configuration, the calls that
ran CUDA kernels (one per wrapper call, however many launches it takes):
the vocoder kernels' bf16 configuration counts under its own `_bf16` key
(the AA-snake's runs `aa_snake_bf16.cu`, the triple's tail
`triple_post_bf16.cu`), as the decode's bf16 weights and
cache do (`plm_decode_bf16.cu`; the mixed pairs run `plm_decode.cu` and
count as `plm_decode`). CPU calls, which take the plain versions, do not
count. `ROWS` counts the rows those `plm_decode_bf16` launches decoded (up
to ops/plm_decode.MAX_ROWS a launch); `reset_launches` clears both.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from megatts2_hierspeechpp_torch.utils.profiling import annotate

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-O3", "-std=c++17", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

LAUNCHES = {"aa_snakebeta": 0, "ampblock": 0, "amp_triple": 0,
            "plm_decode": 0, "plm_decode_bf16": 0, "aa_snakebeta_bf16": 0,
            "ampblock_bf16": 0, "amp_triple_bf16": 0}
ROWS = {"plm_decode_bf16": 0}
# activation dtypes of the vocoder kernels: float32, or the bf16
# configuration (bf16 in and out, float32 inside)
ACT_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, alpha, inv_beta, y, B, T, C, rows, blocks, stream
    "aa_snakebeta_fwd": [_P] * 4 + [_I] * 5 + [_P],
    # x, alpha, inv_beta, y, B, T, C, seg, pack, blocks, stream
    "aa_snakebeta_bf16_fwd": [_P] * 4 + [_I] * 6 + [_P],
    # x, alpha, inv_beta, w, bias, res, y, B, T, Cin, Cout, K, dil, stream
    "snake_conv_fwd": [_P] * 7 + [_I] * 6 + [_P],
    # B, T, Cout, K, dil, &tm, &tn
    "snake_conv_tile": [_I] * 5 + [_P, _P],
    # x, alpha, inv_beta, packed w, bias, res, y, B, T, Cin, Cout, K, dil,
    # io, stamps, stream
    "snake_conv_bf16_fwd": [_P] * 7 + [_I] * 7 + [_P, _P],
    # B, T, Cin, Cout, K, dil, out[9]
    "snake_conv_bf16_plan": [_I] * 6 + [_P],
    # r0, r1, r2, y, n, y_bytes, stream
    "triple_avg_fwd": [_P, _P, _P, _P, _I, _I, _P],
    # r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, tile, smem_bytes, stamps,
    # stream
    "triple_post_fwd": [_P] * 7 + [_I] * 5 + [_P, _P],
    # r0, r1, r2, alpha, inv_beta, w7, y, B, T, C, seg, pack, blocks,
    # smem_bytes, stream
    "triple_post_bf16_fwd": [_P] * 7 + [_I] * 7 + [_P],
    # tc, pe, emb, wqkv, bqkv, wo, bo, ln, ff0, ff0b, ff1, ff1b, pred, cache,
    # xch, codes, stamps, T, L, D, TC, H, F, BINS, go_id, grid, smem_bytes,
    # xch_pairs, wbytes, cbytes, stream
    "plm_decode_fwd": [_P] * 17 + [_I] * 13 + [_P],
    # tc, pe, emb, wqkv, bqkv, wo, bo, ln, ff0, ff0b, ff1, ff1b, pred, cache,
    # xch, codes, stamps, T, L, D, TC, H, F, BINS, go_id, cluster, rows,
    # smem_bytes, xch_pairs, stream
    "plm_decode_bf16_fwd": [_P] * 17 + [_I] * 12 + [_P],
    # cluster, rows, smem_bytes, &max_active_clusters
    "plm_decode_bf16_clusters": [_I, _I, _I, _P],
    # iscratch, n, stream
    "plm_barrier_probe": [_P, _I, _P],
}

_lib = None


def reset_launches() -> None:
    for counts in (LAUNCHES, ROWS):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmegatts_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every csrc/*.cu in parallel and link one shared library.

    The compiler's resource report (-Xptxas -v) goes to build.log beside the
    library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = so.stem.rsplit("_", 1)[-1]
    srcs = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{s.stem}_{tag}.o" for s in srcs]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for s, o in zip(srcs, objs)
    ]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    (BUILD_DIR / "build.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        dll = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = dll
    return _lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def call(name: str, *args) -> None:
    err = getattr(lib(), name)(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {err}")


def check(t: torch.Tensor, name: str, device: torch.device,
          shape: tuple | None = None,
          dtypes: tuple = (torch.float32,)) -> None:
    """Raise unless `t` is a contiguous tensor of one of `dtypes` on
    `device` of `shape`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def act_bytes(t: torch.Tensor) -> int:
    """4 for a float32 activation, 2 for bf16: the kernels' type flag."""
    return t.element_size()


def plain_vjp(fn, saved, needs_grad, ct, *static):
    """Backward of a kernel through autograd of its plain version at the
    saved primals, which recomputes in the primals' dtypes (a bf16 x runs
    the bf16 twin). The cotangent is cast to the primal output's dtype (as
    the JAX custom_vjp does): a bf16 discriminator may hand a bf16
    cotangent to a float32 output, and the reverse. Runs in the "plain_vjp"
    span (utils/profiling.annotate), so a trace can tell its recompute and
    backward from the rest of a step."""
    with torch.enable_grad(), annotate("plain_vjp"):
        xs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs_grad)]
        out = fn(*xs, *static)
        wrt = [x for x, n in zip(xs, needs_grad) if n]
        grads = iter(torch.autograd.grad(out, wrt, ct.to(out.dtype))
                     if wrt else ())
    return tuple(next(grads) if n else None for n in needs_grad)
