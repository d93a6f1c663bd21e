"""Plain versions of the port's kernels (megatts2_hierspeechpp_torch.ops)
against the JAX composed math and the JAX Pallas kernels in interpret mode,
on the CPU: AA-SnakeBeta and AMPBlock here, the AMPBlock triple in
test_torch_triple.py. The CUDA kernels themselves are held against the plain versions
on the card by chip_smoke.py and by tests/test_torch_cuda.py.

Tolerance: atol 1e-5, rtol 1e-4 in float32 (accumulation order differs)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import megatts2_hierspeechpp_tpu.ops.pallas_amp_triple as pat
import megatts2_hierspeechpp_tpu.ops.pallas_ampblock as pab
import megatts2_hierspeechpp_tpu.ops.pallas_snake as psn
from megatts2_hierspeechpp_torch.models import plm
from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, cuda_lib, plm_decode, snake

ATOL, RTOL = 1e-5, 1e-4
KS = (3, 7, 11)
DIL = (1, 3, 5)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """The suite runs in several worker processes at once: cap torch's
    intra-op threads while these tests run, so the workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def _snake_inputs(rng, shape):
    b, t, c = shape
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    a = np.exp(rng.standard_normal(c) * 0.3).astype(np.float32)
    be = np.exp(rng.standard_normal(c) * 0.3).astype(np.float32)
    return x, a, be


def _block_ws(rng, k, c):
    """Unit-gain weights (a, ib ~ exp(0.2 N); w ~ N / sqrt(C k))."""
    pos = lambda *s: np.exp(rng.standard_normal(s) * 0.2).astype(np.float32)
    w = lambda: (rng.standard_normal((3, k, c, c)) / np.sqrt(c * k)).astype(np.float32)
    b = lambda: (rng.standard_normal((3, c)) * 0.05).astype(np.float32)
    return (pos(3, c), pos(3, c), w(), b(), pos(3, c), pos(3, c), w(), b())


def _post(rng, c):
    return (np.exp(rng.standard_normal(c) * 0.2).astype(np.float32),
            np.exp(rng.standard_normal(c) * 0.2).astype(np.float32),
            (rng.standard_normal((7, c)) * 0.1 / np.sqrt(7 * c)).astype(np.float32))


# shapes of tests/test_pallas_*.py, plus T below the JAX short-T cutoffs
@pytest.mark.parametrize("shape", [(1, 512, 16), (2, 640, 32), (1, 1024, 64),
                                   (1, 24, 64)])
def test_snake_plain_matches_jax(shape, interpret_pallas):
    x, a, be = _snake_inputs(np.random.default_rng(0), shape)
    got = snake.fused_aa_snakebeta(_t(x), _t(a), _t(be))  # CPU: plain version
    xj, aj, bj = jnp.asarray(x), jnp.asarray(a), jnp.asarray(be)
    _close(got, jax.jit(psn._composed_math)(xj, aj, bj))
    _close(got, jax.jit(psn.fused_aa_snakebeta)(xj, aj, bj))


@pytest.mark.parametrize("shape,k", [((1, 512, 16), 11), ((2, 640, 32), 7),
                                     ((1, 1024, 64), 3), ((1, 100, 16), 3)])
def test_ampblock_plain_matches_jax(shape, k, interpret_pallas):
    rng = np.random.default_rng(1)
    b, t, c = shape
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    ws = _block_ws(rng, k, c)
    got = ampblock.fused_ampblock(_t(x), *map(_t, ws), k, DIL)
    xj, wj = jnp.asarray(x), [jnp.asarray(w) for w in ws]
    composed = jax.jit(pab.composed_ampblock, static_argnums=(9, 10))
    fused = jax.jit(pab.fused_ampblock, static_argnums=(9, 10))
    _close(got, composed(xj, *wj, k, DIL))
    _close(got, fused(xj, *wj, k, DIL))


def test_snake_gradient_matches_jax():
    """The kernels' backward (plain_vjp of the plain version) against the
    JAX gradient (its custom_vjp backward is the composed math), for x and
    the learned alpha/beta."""
    rng = np.random.default_rng(3)
    x, a, be = _snake_inputs(rng, (1, 64, 16))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    got = cuda_lib.plain_vjp(snake.composed_snakebeta, (_t(x), _t(a), _t(be)),
                             (True, True, True), _t(cot))
    want = jax.jit(jax.grad(lambda *p: jnp.sum(cot * psn._composed_math(*p)),
                            argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(be))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_launch_counts_stay_zero_on_cpu():
    rng = np.random.default_rng(5)
    cuda_lib.reset_launches()
    x, a, be = _snake_inputs(rng, (1, 64, 16))
    snake.fused_aa_snakebeta(_t(x), _t(a), _t(be))
    ws = tuple(map(_t, _block_ws(rng, 3, 16)))
    ampblock.fused_ampblock(_t(x), *ws, 3, DIL)
    amp_triple.fused_amp_triple(_t(x), [ws] * 3, (3, 3, 3), (DIL,) * 3)
    lm = plm.ProsodyLM(n_layers=1, tc_latent_dim=12, device="cpu")
    plm_decode.plm_decode_greedy(lm.packed(), torch.zeros(1, 5, 12), lm.go_id)
    assert cuda_lib.LAUNCHES == {"aa_snakebeta": 0, "ampblock": 0,
                                 "amp_triple": 0, "plm_decode": 0,
                                 "plm_decode_bf16": 0, "aa_snakebeta_bf16": 0,
                                 "ampblock_bf16": 0, "amp_triple_bf16": 0}


def test_taps_header_matches_polyphase_taps():
    """csrc/taps.cuh literals == the port's _polyphase_taps == the JAX
    kernel's taps (exact float32)."""
    src = (Path(snake.__file__).parents[1] / "csrc" / "taps.cuh").read_text()

    def arr(name):
        body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src).group(1)
        return np.array([np.float32(v.rstrip("f")) for v in body.split(",")])

    e, o, ge, go = snake._polyphase_taps()
    for mine, jax_taps in zip((e, o, ge, go), psn._polyphase_taps()):
        np.testing.assert_array_equal(mine, jax_taps)
    np.testing.assert_array_equal(arr("kUpEven"), e)
    np.testing.assert_array_equal(arr("kUpOdd"), o)
    down = arr("kDown")
    np.testing.assert_array_equal(down[[1, 3, 5, 7, 9, 11]], ge)
    np.testing.assert_array_equal(down[[0, 2, 4, 6, 8, 10]], go)
