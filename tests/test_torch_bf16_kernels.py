"""The bf16 configuration of the port's three vocoder kernels on the CPU:
their plain twins (bf16 x, float32 inside, each conv's operands rounded to
bf16, a bf16 output) against the JAX Pallas kernels in interpret mode on
the same bf16 x, the cotangent's dtype in both directions through the
kernels' backward, and the wrappers' dtype rules.

Interpret mode runs the kernels' default-precision dots in float32 while
the twins round the conv operands, so the AMPBlock and the triple are held
to the JAX tests' own bf16 bound, relative 2e-2 of max|ref|
(tests/test_pallas_ampblock.py); the measured value, printed on failure,
sits near 2^-8. Their weights are unit-gain (tests/test_torch_kernels.py
_block_ws): at the JAX tests' 0.1-scale weights a triple with the tail
amplifies one bf16 step into 0.06-0.37 of max|ref| in either
implementation. The AA-snake rounds once: outside the 8-sample edge strips
that the JAX wrapper recomputes with its bf16 composed math, its bf16
output is within half a bf16 step, 2^-8 x max|ref|, of the twin before its
final rounding; the rounded twin everywhere within 2e-2.

Backward (cuda_lib.plain_vjp over the twin): a bf16 cotangent on a float32
output, and a float32 cotangent on a bf16 output, each cast to the
output's dtype, give the gradients of the cast cotangent (within 1e-6
relative, the same arithmetic)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import megatts2_hierspeechpp_tpu.ops.pallas_amp_triple as pat
import megatts2_hierspeechpp_tpu.ops.pallas_ampblock as pab
import megatts2_hierspeechpp_tpu.ops.pallas_snake as psn
from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, cuda_lib, snake
from tests.test_torch_kernels import (  # noqa: F401  (fixtures)
    DIL,
    KS,
    _block_ws,
    _post,
    _snake_inputs,
    _t,
    few_torch_threads,
    interpret_pallas,
)

BF16_STEP = 2.0 ** -8   # half a bf16 step, relative
JAX_BF16_TOL = 2e-2     # tests/test_pallas_ampblock.py's bf16 bound
EDGE = 8                # samples the JAX snake wrapper takes from its composed math


def _bf16(a):
    """A float32 array rounded to bf16, as the JAX and the torch input."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# the shapes of tests/test_pallas_snake.py
@pytest.mark.parametrize("shape", [(1, 512, 16), (2, 1000, 32), (1, 700, 64),
                                   (1, 512, 256)])
def test_bf16_snake_twin_matches_jax_interpret(shape, interpret_pallas):
    x, a, be = _snake_inputs(np.random.default_rng(0), shape)
    x = _bf16(x)
    want = np.asarray(psn.fused_aa_snakebeta(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(a), jnp.asarray(be)), np.float32)
    got = snake.fused_aa_snakebeta(_t(x).bfloat16(), _t(a), _t(be))  # CPU: twin
    assert got.dtype == torch.bfloat16
    twin32 = snake.composed_snakebeta(_t(x), _t(a), _t(be)).numpy()
    inner = np.abs(want - twin32)[:, EDGE:-EDGE].max() / np.abs(twin32).max()
    assert inner <= BF16_STEP, inner
    rel = _rel(got.float().numpy(), want)
    assert rel < JAX_BF16_TOL, rel


# the shapes of tests/test_pallas_ampblock.py
@pytest.mark.parametrize("shape,k", [((1, 512, 16), 11), ((2, 640, 32), 7),
                                     ((1, 512, 64), 3), ((1, 1024, 128), 11)])
def test_bf16_ampblock_twin_matches_jax_interpret(shape, k, interpret_pallas):
    rng = np.random.default_rng(1)
    x = _bf16(rng.standard_normal(shape).astype(np.float32))
    ws = _block_ws(rng, k, shape[-1])
    want = np.asarray(pab.fused_ampblock(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, ws), kernel_size=k,
        dilations=DIL), np.float32)
    got = ampblock.fused_ampblock(_t(x).bfloat16(), *map(_t, ws), k, DIL)
    assert got.dtype == torch.bfloat16
    rel = _rel(got.float().numpy(), want)
    assert rel < JAX_BF16_TOL, rel


# the shapes of tests/test_pallas_amp_triple.py, the tail included
@pytest.mark.parametrize("shape,tail", [((1, 512, 16), True),
                                        ((2, 640, 32), True),
                                        ((1, 1024, 64), False)])
def test_bf16_triple_twin_matches_jax_interpret(shape, tail, interpret_pallas):
    rng = np.random.default_rng(2)
    c = shape[-1]
    x = _bf16(rng.standard_normal(shape).astype(np.float32))
    bws = [_block_ws(rng, k, c) for k in KS]
    post = _post(rng, c) if tail else None
    want = np.asarray(pat.fused_amp_triple(
        jnp.asarray(x, jnp.bfloat16), [tuple(map(jnp.asarray, bw)) for bw in bws],
        KS, (DIL,) * 3,
        post=tuple(map(jnp.asarray, post)) if tail else None), np.float32)
    got = amp_triple.fused_amp_triple(
        _t(x).bfloat16(), [tuple(map(_t, bw)) for bw in bws], KS, (DIL,) * 3,
        tuple(map(_t, post)) if tail else None)
    assert got.dtype == torch.bfloat16
    assert got.shape == ((shape[0], shape[1], 1) if tail else shape)
    rel = _rel(got.float().numpy(), want)
    assert rel < JAX_BF16_TOL, rel


def _vjp_case(which, rng):
    """(plain version, primals with a bf16 x, static arguments)."""
    if which == "snake":
        x, a, be = _snake_inputs(rng, (1, 40, 24))
        return snake.composed_snakebeta, [_t(x), _t(a), _t(be)], ()
    if which == "ampblock":
        x = rng.standard_normal((1, 40, 16)).astype(np.float32)
        return (ampblock.composed_ampblock,
                [_t(x)] + [_t(w) for w in _block_ws(rng, 3, 16)], (3, DIL))
    x = rng.standard_normal((1, 48, 8)).astype(np.float32)
    flat = [_t(w) for k in KS for w in _block_ws(rng, k, 8)] + list(map(_t, _post(rng, 8)))
    return amp_triple._composed_flat, [_t(x)] + flat, (KS, (DIL,) * 3, True)


@pytest.mark.parametrize("which", ["snake", "ampblock", "triple"])
@pytest.mark.parametrize("primal", [torch.float32, torch.bfloat16])
def test_cotangent_is_cast_to_the_output_dtype(which, primal):
    """plain_vjp (the kernels' backward on the card) with the cotangent in
    the other dtype than the primal output: a bf16 discriminator hands a
    bf16 cotangent to a float32 stage, a float32 loss a float32 one to a
    bf16 stage. The recompute runs the twin in the primal's dtype: a bf16
    x gives a bf16 gradient of x, the weights' gradients stay float32."""
    rng = np.random.default_rng(22)
    fn, primals, static = _vjp_case(which, rng)
    primals[0] = primals[0].to(primal)
    needs = (True,) * len(primals)
    with torch.no_grad():
        out = fn(*primals, *static)
    assert out.dtype == primal
    other = torch.bfloat16 if primal == torch.float32 else torch.float32
    ct = _t(rng.standard_normal(tuple(out.shape))).to(other)
    got = cuda_lib.plain_vjp(fn, primals, needs, ct, *static)
    want = cuda_lib.plain_vjp(fn, primals, needs, ct.to(primal), *static)
    assert got[0].dtype == primal
    assert all(g.dtype == torch.float32 for g in got[1:])
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=1e-6, atol=1e-6 * w.abs().max().item())


def test_bf16_functions_count_their_own_keys(monkeypatch):
    """The autograd Functions on a bf16 x, each launch replaced by its plain
    version: the bf16 output and gradients flow, and the calls count under
    the `_bf16` keys, none under the float32 ones."""
    rng = np.random.default_rng(23)
    c = 8
    ws = [_t(w).requires_grad_() for w in _block_ws(rng, 3, c)]
    x = _t(rng.standard_normal((1, 40, c))).bfloat16().requires_grad_()
    monkeypatch.setattr(ampblock, "run_block",
                        lambda x_, ws_, d, out_dtype=None, packed=None:
                        ampblock.composed_ampblock(x_, *ws_, 3, d))
    monkeypatch.setattr(amp_triple, "_launch", lambda x_, bws, d, post, packed=None:
                        amp_triple.composed_triple(x_, bws, (3, 3, 3), d, post))
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict.fromkeys(cuda_lib.LAUNCHES, 0))
    y = ampblock._AMPBlock.apply(x, 3, DIL, None, *ws)
    y = amp_triple._AMPTriple.apply(y, (3, 3, 3), (DIL,) * 3, False, None, *ws * 3)
    assert y.dtype == torch.bfloat16
    y.float().square().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()
    assert all(w.grad.dtype == torch.float32 for w in ws)
    assert cuda_lib.LAUNCHES == dict.fromkeys(cuda_lib.LAUNCHES, 0) | {
        "ampblock_bf16": 1, "amp_triple_bf16": 1}


def test_wrappers_refuse_other_dtypes():
    """cuda_lib.check takes the dtypes a kernel accepts; snake_conv's bf16
    I/O only with the bf16 products; float16 nowhere. (These checks run
    before any launch, so the CPU reaches them.)"""
    x = torch.zeros(1, 8, 4)
    with pytest.raises(TypeError):
        cuda_lib.check(x.half(), "x", x.device, dtypes=cuda_lib.ACT_DTYPES)
    cuda_lib.check(x.bfloat16(), "x", x.device, dtypes=cuda_lib.ACT_DTYPES)
    with pytest.raises(TypeError):
        cuda_lib.check(x.bfloat16(), "x", x.device)
    w = (torch.ones(4), torch.ones(4), torch.zeros(3, 4, 4), torch.zeros(4), 1)
    with pytest.raises(TypeError):
        ampblock.snake_conv(x.bfloat16(), *w)
    with pytest.raises(TypeError):
        ampblock.snake_conv(x, *w, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        ampblock.snake_conv(x.half(), *w, bf16_mma=True)
    with pytest.raises(TypeError):
        amp_triple._epilogue(x, x, x, None, out_dtype=torch.float16)
