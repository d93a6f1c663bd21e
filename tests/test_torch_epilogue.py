"""The AMPBlock-triple epilogue (average, and the tail AA-snake -> conv_post
-> tanh) and the launch plans of the port's two redesigned kernels, on the
CPU:

- `amp_triple.composed_epilogue` on three `composed_ampblock` outputs
  against the JAX `pallas_amp_triple.composed_triple`, with and without the
  tail. Tolerance: atol 1e-5, rtol 1e-4 in float32 (accumulation order).
- `snake.snake_plan` (csrc/aa_snake.cu) and `amp_triple.epilogue_plan`
  (csrc/triple_epilogue.cu): every output sample has exactly one owner at
  the serving path's launch shapes and at T = 1, 7; the shared memory fits
  a Hopper block; the constants equal the CUDA sources'.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_epilogue.py -q
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import megatts2_hierspeechpp_tpu.ops.pallas_amp_triple as pat
from megatts2_hierspeechpp_torch.ops import amp_triple, snake
from megatts2_hierspeechpp_torch.ops.ampblock import composed_ampblock
from tests.test_torch_kernels import (  # noqa: F401  (fixture)
    DIL,
    KS,
    _block_ws,
    _close,
    _post,
    _t,
    few_torch_threads,
)

CSRC = Path(snake.__file__).parents[1] / "csrc"
SMEM_LIMIT = 232_448
FRAMES = 500
# (B, T, C) of the serving path's launches for a 500-frame request
SNAKE_SHAPES = [(1, 4 * FRAMES, 256), (1, 4 * FRAMES, 64)]
EPILOGUE_SHAPES = [(1, 4 * FRAMES, 64), (1, 80 * FRAMES, 64),
                   (1, 160 * FRAMES, 32), (1, 320 * FRAMES, 16),
                   (1, 960 * FRAMES, 32)]


@pytest.mark.parametrize("shape,tail", [((1, 256, 16), True),
                                        ((2, 300, 32), True),
                                        ((1, 200, 64), False),
                                        ((2, 64, 7), False),
                                        ((1, 7, 16), True)])
def test_epilogue_plain_matches_jax(shape, tail):
    rng = np.random.default_rng(6)
    b, t, c = shape
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    bws = [_block_ws(rng, k, c) for k in KS]
    post = _post(rng, c) if tail else None
    rs = [composed_ampblock(_t(x), *map(_t, bw), k, DIL) for bw, k in zip(bws, KS)]
    tpost = tuple(map(_t, post)) if tail else None
    got = amp_triple.composed_epilogue(*rs, post=tpost)
    assert got.shape == ((b, t, 1) if tail else (b, t, c))
    # the CPU dispatch of the kernel wrapper is the plain version
    np.testing.assert_array_equal(
        amp_triple.fused_epilogue(*rs, tpost).numpy(), got.numpy())
    want = jax.jit(pat.composed_triple, static_argnums=(2, 3))(
        jnp.asarray(x), [tuple(map(jnp.asarray, bw)) for bw in bws], KS,
        (DIL,) * 3, tuple(map(jnp.asarray, post)) if tail else None)
    _close(got, want)


def _snake_owners(b, t, c, plan):
    """Times each output (b, t, c) is written under `plan`, thread by
    thread as csrc/aa_snake.cu maps them."""
    rows = plan["rows"]
    chunks, segs = -(-c // 32), -(-t // rows)
    groups = -(-segs // 4)
    blk, tid = np.divmod(np.arange(plan["blocks"] * snake.THREADS), snake.THREADS)
    ch = (blk % chunks) * 32 + tid % 32
    rest = blk // chunks
    seg = (rest % groups) * 4 + tid // 32
    bb = rest // groups
    live = (ch < c) & (seg < segs) & (bb < b)
    count = np.zeros((b, segs * rows, c), np.int64)
    for r in range(rows):
        np.add.at(count, (bb[live], seg[live] * rows + r, ch[live]), 1)
    return count[:, :t], count[:, t:]


@pytest.mark.parametrize("rows", snake.ROWS)
@pytest.mark.parametrize("shape", SNAKE_SHAPES + [(2, 1, 7), (2, 7, 200),
                                                  (1, 7, 16)])
def test_snake_plan_owns_every_output_once(shape, rows):
    b, t, c = shape
    owned, beyond = _snake_owners(b, t, c, snake.snake_plan(b, t, c, rows))
    assert (owned == 1).all()
    # a thread's outputs past T are never stored (the kernel's t < T)
    assert (beyond == 1).all()
    with pytest.raises(ValueError):
        snake.snake_plan(b, t, c, rows + 1)


@pytest.mark.parametrize("shape,rows", [
    (SNAKE_SHAPES[0], 8), (SNAKE_SHAPES[1], 4),
    ((4, 20000, 256), 8), ((1, 2000, 65), 8), ((2, 1, 64), 4)])
def test_snake_default_rows_by_width(shape, rows):
    """8 rows per thread at C > 64 and 4 otherwise, whatever B and T: the
    measured best of chip_smoke's sweep at the Generator's C = 256 and the
    SourceNetwork's C = 64."""
    assert snake.snake_plan(*shape)["rows"] == rows


@pytest.mark.parametrize("shape", EPILOGUE_SHAPES + [(2, 1, 16), (2, 7, 32),
                                                     (2, 7, 7)])
def test_epilogue_plan_owns_every_output_once(shape):
    b, t, c = shape
    plan = amp_triple.epilogue_plan(b, t, c)
    tile, rows = plan["tile"], plan["rows"]
    assert plan["grid"] == (-(-t // tile), b)
    owned = np.zeros(t, np.int64)
    for x in range(plan["grid"][0]):
        owned[x * tile: min(x * tile + tile, t)] += 1
    assert (owned == 1).all()
    # a block's AA-snake rows t0 - 3 .. t0 + rows - 4 hold every conv_post
    # input of its outputs, t0 - 3 .. t0 + tile + 2, in tasks of 16 rows
    assert rows - 4 >= tile + 2
    assert plan["tasks"] * amp_triple.EPILOGUE_ROWS_PER_TASK == rows * c
    # the shared-memory layout: conv_post weights C x 8, average (rows +
    # 10) x C, AA-snake C x (rows + 1)
    assert plan["smem"] == 4 * (8 * c + (rows + 10) * c + c * (rows + 1))
    assert plan["smem"] <= SMEM_LIMIT
    if c <= 64:  # the serving path's widths: the longest tile
        assert tile == 248


def test_epilogue_plan_shrinks_the_tile_then_raises():
    assert amp_triple.epilogue_plan(1, 1000, 128)["tile"] == 120
    assert amp_triple.epilogue_plan(1, 1000, 400)["tile"] == 24
    with pytest.raises(ValueError, match="shared memory"):
        amp_triple.epilogue_plan(1, 1000, 800)
    with pytest.raises(ValueError, match="shared memory"):
        amp_triple.epilogue_plan(1, 1000, 16, tile=100)


def _constant(src, name):
    return re.search(rf"constexpr int {name}(?:\[\])? = \{{?([^;}}]*)\}}?;", src).group(1)


def test_plans_match_the_cuda_sources():
    snake_src = (CSRC / "aa_snake.cu").read_text()
    assert int(_constant(snake_src, "kThreads")) == snake.THREADS
    # the rows the kernel is built for (float32; a bf16 x runs
    # aa_snake_bf16.cu, tests/test_torch_snake_bf16.py)
    cases = re.findall(r"case (\d+): return launch<(\d+)>", snake_src)
    assert sorted(int(a) for a, b in cases if a == b) == list(snake.ROWS)
    assert len(cases) == len(snake.ROWS)
    epi = (CSRC / "triple_epilogue.cu").read_text()
    assert int(_constant(epi, "kThreads")) == amp_triple.EPILOGUE_THREADS
    assert int(_constant(epi, "kR")) == amp_triple.EPILOGUE_ROWS_PER_TASK
    assert int(_constant(epi, "kSmemLimit")) == amp_triple.SMEM_LIMIT
    tiles = tuple(int(v) for v in _constant(epi, "kTiles").split(","))
    assert tiles == amp_triple.EPILOGUE_TILES
    assert "4 * C * (2 * rows + 19)" in epi
