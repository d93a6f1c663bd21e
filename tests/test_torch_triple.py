"""Plain version of the port's AMPBlock-triple kernel
(megatts2_hierspeechpp_torch.ops.amp_triple) against the JAX composed math
and the JAX Pallas kernel in interpret mode, on the CPU, with and without
the tail; and the kernel's backward against jax.grad.

Tolerance: atol 1e-5, rtol 1e-4 in float32 (accumulation order differs);
gradients 2e-3, as the JAX package's own triple tests."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import megatts2_hierspeechpp_tpu.ops.pallas_amp_triple as pat
from megatts2_hierspeechpp_torch.ops import amp_triple, cuda_lib
from tests.test_torch_kernels import (  # noqa: F401  (fixture)
    DIL,
    KS,
    _block_ws,
    _close,
    _post,
    _t,
    few_torch_threads,
    interpret_pallas,
)


@pytest.mark.parametrize("shape,tail", [((1, 512, 16), True),
                                        ((2, 640, 32), True),
                                        ((1, 1024, 64), False),
                                        ((1, 128, 16), False)])
def test_triple_plain_matches_jax(shape, tail, interpret_pallas):
    rng = np.random.default_rng(2)
    b, t, c = shape
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    bws = [_block_ws(rng, k, c) for k in KS]
    post = _post(rng, c) if tail else None
    got = amp_triple.fused_amp_triple(
        _t(x), [tuple(map(_t, bw)) for bw in bws], KS, (DIL,) * 3,
        tuple(map(_t, post)) if tail else None)
    xj = jnp.asarray(x)
    bj = [tuple(jnp.asarray(w) for w in bw) for bw in bws]
    pj = tuple(jnp.asarray(p) for p in post) if tail else None
    assert got.shape == ((b, t, 1) if tail else (b, t, c))
    composed = jax.jit(pat.composed_triple, static_argnums=(2, 3))
    fused = jax.jit(pat.fused_amp_triple, static_argnums=(2, 3))
    _close(got, composed(xj, bj, KS, (DIL,) * 3, pj))
    _close(got, fused(xj, bj, KS, (DIL,) * 3, pj))


def test_triple_gradient_matches_jax():
    """Backward of the triple with tail, through the flattened argument list
    the autograd.Function uses, against jax.grad of composed_triple; a bf16
    cotangent is cast to the f32 primal's dtype."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 48, 8)).astype(np.float32)
    bws = [_block_ws(rng, k, 8) for k in KS]
    post = _post(rng, 8)
    cot = rng.standard_normal((1, 48, 1)).astype(np.float32)
    flat = [_t(w) for bw in bws for w in bw] + [_t(p) for p in post]
    needs = (True,) * (1 + len(flat))
    got = cuda_lib.plain_vjp(amp_triple._composed_flat, [_t(x)] + flat, needs,
                             _t(cot), KS, (DIL,) * 3, True)
    want_x, want_bws, want_post = jax.jit(jax.grad(
        lambda x_, b_, p_: jnp.sum(cot * pat.composed_triple(
            x_, b_, KS, (DIL,) * 3, p_)),
        argnums=(0, 1, 2)))(jnp.asarray(x),
                           [tuple(map(jnp.asarray, bw)) for bw in bws],
                           tuple(map(jnp.asarray, post)))
    want = [want_x] + [w for bw in want_bws for w in bw] + list(want_post)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)
    bf16 = cuda_lib.plain_vjp(amp_triple._composed_flat, [_t(x)] + flat, needs,
                              _t(cot).bfloat16(), KS, (DIL,) * 3, True)
    assert bf16[0].dtype == torch.float32 and torch.isfinite(bf16[0]).all()
