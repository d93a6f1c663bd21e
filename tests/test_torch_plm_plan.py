"""The PLM decode kernel's shared-memory plan (ops/plm_decode.py
`smem_plan`, mirrored by `make_plan` in csrc/plm_decode.cu), checked on the
CPU: every output row of every matrix has exactly one owner, the shipped
ProsodyLM (d 276, 4 layers, F 1104, 1024 bins, 4 heads) fits a block's
232,448 bytes at the grids of an H100 SXM (132 SMs) and PCIe (114), and the
wrapper's check raises for a grid whose share does not fit."""
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
