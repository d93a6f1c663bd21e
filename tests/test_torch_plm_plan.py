"""The PLM decode kernel's shared-memory plan (ops/plm_decode.py
`smem_plan`, mirrored by `make_plan` in csrc/plm_decode.cu), checked on the
CPU: every output row of every matrix has exactly one owner, the shipped
ProsodyLM (d 276, 4 layers, F 1104, 1024 bins, 4 heads) fits a block's
232,448 bytes at the grids of an H100 SXM (132 SMs) and PCIe (114), and the
wrapper's check raises for a grid whose share does not fit; the same for
the bf16 configuration (2-byte weights, rows padded to 16 bytes), whose
matrices take half the shared memory."""
import re
from pathlib import Path

import pytest

from megatts2_hierspeechpp_torch.ops import plm_decode as dec

D, F, L, BINS, H = 276, 1104, 4, 1024, 4
ROWS = {"wqkv": 3 * D, "wo": D, "ff0": F, "ff1": D, "pred": BINS}


@pytest.mark.parametrize("grid", [132, 114])
@pytest.mark.parametrize("matrix", sorted(ROWS))
def test_every_row_is_owned_once(grid, matrix):
    rows = ROWS[matrix]
    slots = dec.plan(D, F, L, BINS, grid, H)["slots"][matrix]
    owners = {}
    for b in range(grid):
        held = [s * grid + b for s in range(slots) if s * grid + b < rows]
        assert len(held) == dec.owned(rows, b, grid)
        for j in held:
            assert j not in owners
            owners[j] = b
    assert sorted(owners) == list(range(rows))


@pytest.mark.parametrize("grid", [132, 114])
def test_shipped_config_fits_shared_memory(grid):
    need = dec.smem_plan(D, F, L, BINS, grid, H)
    assert need <= 232_448
    # the float32 matrices alone: this block's share of 15.8 MB
    s = dec.plan(D, F, L, BINS, grid, H)["slots"]
    weights = 4 * (L * ((s["wqkv"] + s["wo"] + s["ff0"]) * D + s["ff1"] * F)
                   + s["pred"] * D)
    assert weights == {132: 145_728, 114: 155_664}[grid]
    assert dec.check_plan(D, F, L, BINS, grid, H)["bytes"] + dec.STATIC_SMEM == need


@pytest.mark.parametrize("grid", [60, 33])
def test_plan_that_does_not_fit_raises(grid):
    assert dec.smem_plan(D, F, L, BINS, grid, H) > dec.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        dec.check_plan(D, F, L, BINS, grid, H)


@pytest.mark.parametrize("grid", [132, 114])
@pytest.mark.parametrize("matrix", sorted(ROWS))
def test_bf16_plan_owns_every_row_once(grid, matrix):
    """bf16 takes the same row slots as float32; each row is owned once."""
    rows = ROWS[matrix]
    slots = dec.plan(D, F, L, BINS, grid, H, 2)["slots"][matrix]
    assert slots == dec.plan(D, F, L, BINS, grid, H)["slots"][matrix]
    held = sorted(s * grid + b for b in range(grid) for s in range(slots)
                  if s * grid + b < rows)
    assert held == list(range(rows))
    assert all(sum(1 for s in range(slots) if s * grid + b < rows)
               == dec.owned(rows, b, grid) for b in range(grid))


@pytest.mark.parametrize("grid", [132, 114])
def test_bf16_plan_fits_and_halves_the_matrices(grid):
    """The shipped ProsodyLM in bf16: rows of 280 (D inputs) and 1104 (F
    inputs) weights, whole 16-byte units; the matrices take 73,536 B of a
    block at 132 SMs and 78,576 B at 114 (float32: 145,728 / 155,664), and
    the block's plan is 132,000 / 132,464 B with its static arrays."""
    lay = dec.plan(D, F, L, BINS, grid, H, 2)
    assert (lay["rd"], lay["rf"]) == (280, 1104)
    assert dec.plan(D, F, L, BINS, grid, H)["rd"] == D
    s = lay["slots"]
    weights = 2 * (L * ((s["wqkv"] + s["wo"] + s["ff0"]) * 280 + s["ff1"] * 1104)
                   + s["pred"] * 280)
    assert weights == {132: 73_536, 114: 78_576}[grid]
    need = dec.smem_plan(D, F, L, BINS, grid, H, 2)
    assert need == {132: 132_000, 114: 132_464}[grid]
    assert need <= dec.SMEM_LIMIT
    assert dec.check_plan(D, F, L, BINS, grid, H, 2)["bytes"] + dec.STATIC_SMEM == need


def test_plan_constants_match_the_cuda_source():
    """The constants the Python plan mirrors are the CUDA source's, and
    make_plan's row strides round to 16 bytes of the weight type."""
    src = (Path(dec.__file__).parents[1] / "csrc" / "plm_decode.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kMaxGrid") == dec.MAX_GRID
    assert const("kMaxParts") == dec.MAX_PARTS
    assert const("kKeyChunk") == dec.KEY_CHUNK
    assert "p.rd = upn(D, 16 / WB);" in src and "p.rf = upn(F, 16 / WB);" in src
    assert dec.WEIGHT_BYTES == {dec.torch.float32: 4, dec.torch.bfloat16: 2}
