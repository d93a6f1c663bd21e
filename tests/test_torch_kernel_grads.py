"""The backward of the port's vocoder kernels, which the trainer runs
(cuda_lib.plain_vjp: autograd of the plain version at the saved inputs),
against jax.grad of the JAX kernels on the CPU (their custom_vjp backward is
the composed math; the Pallas forward runs in interpret mode): the whole
AMPBlock for x and all eight weights, and the AA-snake at C = 192 (enc_q's
widest stage). A bf16 cotangent is cast to the float32 primal's dtype, as the
JAX backward casts it. And the autograd.Functions' plumbing, run on the CPU
with each launch replaced by its plain version: gradients reach the module
parameters through fused_weights / fused_params (weight norm, exp,
1/(beta + eps), stack) as they do through the plain module path.

Tolerances: gradients rtol 1e-4, atol 1e-4 x the largest gradient of that
tensor (float32 sums in another order); the bf16 cotangent's gradients
within 1e-6 relative of the float32 ones computed from the same rounded
cotangent; the plumbing within rtol 1e-5, both sides being the same plain
math."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import megatts2_hierspeechpp_tpu.ops.pallas_ampblock as pab
import megatts2_hierspeechpp_tpu.ops.pallas_snake as psn
from megatts2_hierspeechpp_torch.nn.activations import AASnakeBeta
from megatts2_hierspeechpp_torch.nn.init import init_weights
from megatts2_hierspeechpp_torch.nn.resblocks import AMPBlock
from megatts2_hierspeechpp_torch.ops import amp_triple, ampblock, cuda_lib, snake
from tests.test_torch_kernels import (  # noqa: F401  (fixtures)
    DIL,
    _block_ws,
    _snake_inputs,
    _t,
    few_torch_threads,
    interpret_pallas,
)


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape,k", [((2, 96, 32), 3), ((1, 160, 64), 7),
                                     ((1, 128, 16), 11)])
def test_ampblock_gradient_matches_jax(shape, k, interpret_pallas):
    """x and the eight weights (a1, ib1, w1, b1, a2, ib2, w2, b2), through
    the CPU wrapper's autograd and through plain_vjp (the kernel's
    backward), against jax.grad of the JAX fused_ampblock."""
    rng = np.random.default_rng(20)
    b, t, c = shape
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    ws = _block_ws(rng, k, c)
    cot = rng.standard_normal((b, t, c)).astype(np.float32)
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(cot * pab.fused_ampblock(*a, k, DIL)),
        argnums=tuple(range(9))))(jnp.asarray(x), *map(jnp.asarray, ws))
    leaves = [_t(x).requires_grad_()] + [_t(w).requires_grad_() for w in ws]
    y = ampblock.fused_ampblock(*leaves, kernel_size=k, dilations=DIL)
    y.backward(_t(cot))
    vjp = cuda_lib.plain_vjp(ampblock.composed_ampblock,
                             [_t(x)] + [_t(w) for w in ws], (True,) * 9,
                             _t(cot), k, DIL)
    for leaf, g, w in zip(leaves, vjp, want):
        _grad_close(leaf.grad, w)
        _grad_close(g, w)


def test_snake_gradient_matches_jax_c192(interpret_pallas):
    """enc_q's activation_post width: x, alpha and beta."""
    rng = np.random.default_rng(21)
    x, a, be = _snake_inputs(rng, (2, 48, 192))
    cot = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.jit(jax.grad(
        lambda *p: jnp.sum(cot * psn.fused_aa_snakebeta(*p)),
        argnums=(0, 1, 2)))(jnp.asarray(x), jnp.asarray(a), jnp.asarray(be))
    got = cuda_lib.plain_vjp(snake.composed_snakebeta, (_t(x), _t(a), _t(be)),
                             (True, True, True), _t(cot))
    for g, w in zip(got, want):
        _grad_close(g, w)


@pytest.mark.parametrize("which", ["snake", "ampblock"])
def test_bf16_cotangent_is_cast_to_the_primal_dtype(which):
    rng = np.random.default_rng(22)
    if which == "snake":
        fn, static = snake.composed_snakebeta, ()
        x, a, be = _snake_inputs(rng, (1, 40, 24))
        primals = [_t(x), _t(a), _t(be)]
    else:
        fn, static = ampblock.composed_ampblock, (3, DIL)
        x = rng.standard_normal((1, 40, 16)).astype(np.float32)
        primals = [_t(x)] + [_t(w) for w in _block_ws(rng, 3, 16)]
    ct = _t(rng.standard_normal(x.shape)).bfloat16()
    needs = (True,) * len(primals)
    got = cuda_lib.plain_vjp(fn, primals, needs, ct, *static)
    want = cuda_lib.plain_vjp(fn, primals, needs, ct.float(), *static)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * w.abs().max().item())


def _module_grads(module, x, cot):
    module.zero_grad(set_to_none=True)
    xl = x.clone().requires_grad_()
    module(xl).backward(cot)
    return [xl.grad] + [p.grad for p in module.parameters()]


def test_autograd_functions_route_gradients_to_module_parameters(monkeypatch):
    """_AASnakeBeta, _AMPBlock and _AMPTriple on the CPU, each launch
    replaced by its plain version: the gradients of x and of every module
    parameter equal those of the plain module path."""
    rng = np.random.default_rng(23)
    c = 16
    blocks = torch.nn.ModuleList(AMPBlock(c, k, DIL) for k in (3, 7, 11))
    act = AASnakeBeta(c)
    init_weights(torch.nn.ModuleList([blocks, act]), 5)
    with torch.no_grad():
        for p in act.parameters():
            p.normal_(0, 0.2)
    x = _t(rng.standard_normal((2, 40, c)))
    cot = _t(rng.standard_normal((2, 40, c)))

    class Stage(torch.nn.Module):
        def __init__(self, use_fn):
            super().__init__()
            self.blocks, self.act, self.use_fn = blocks, act, use_fn

        def forward(self, x_):
            if self.use_fn:
                y = snake._AASnakeBeta.apply(x_, *self.act.act.params(), None)
                y = ampblock._AMPBlock.apply(y, 3, DIL, None,
                                             *self.blocks[0].fused_weights())
                return amp_triple._AMPTriple.apply(
                    y, (3, 7, 11), (DIL,) * 3, False, None,
                    *[w for b in self.blocks for w in b.fused_weights()])
            y = self.act(x_)
            y = self.blocks[0](y)
            return amp_triple.fused_amp_triple(
                y, [b.fused_weights() for b in self.blocks], (3, 7, 11),
                (DIL,) * 3)

    monkeypatch.setattr(snake, "_launch",
                        lambda x_, a, b, ib=None, rows=None:
                        snake.composed_snakebeta(x_, a, b))
    monkeypatch.setattr(ampblock, "run_block", lambda x_, ws, d, packed=None:
                        ampblock.composed_ampblock(x_, *ws, 3, d))
    monkeypatch.setattr(amp_triple, "_launch", lambda x_, bws, d, post, packed=None:
                        amp_triple.composed_triple(x_, bws, (3, 7, 11), d, post))
    monkeypatch.setattr(cuda_lib, "LAUNCHES", dict.fromkeys(cuda_lib.LAUNCHES, 0))
    want = _module_grads(Stage(False), x, cot)
    got = _module_grads(Stage(True), x, cot)
    assert len(got) == len(want) > 30
    for g, w in zip(got, want):
        assert g is not None and w is not None
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # the Functions count their calls (the snake counts in _launch, replaced
    # here); the plain module path counts nothing
    assert cuda_lib.LAUNCHES["ampblock"] == cuda_lib.LAUNCHES["amp_triple"] == 1
