"""The bf16 decode kernel's cluster plan (ops/plm_decode.py `cluster_plan`,
mirrored by `make_plan` in csrc/plm_decode_bf16.cu), checked on the CPU at
the shipped ProsodyLM (d 276, 4 layers, F 1104, 1024 bins, 4 heads) and
every cluster size the plan may choose: every output row of every matrix
has exactly one owner CTA, every row copy is a whole number of 16-byte
units, a CTA's shared memory fits the H100's 232,448 bytes, the KV cache
layout addresses every (layer, token, k/v, head, dim) once; a width that
does not fit raises, float32 weights are refused, the cluster size is the
largest that fits and runs L clusters at once, and the constants are the
CUDA source's. The multi-row layout (`columns` > 1): one column is the
one-row layout, every column count up to MAX_ROWS fits at 16 CTAs and one
more does not, each row's cache addresses every entry once, and the
multi-row kernel runs only where its rows keep their one-row launches'
sums (`pick_rows`)."""
import re
from pathlib import Path

import numpy as np
import pytest

from megatts2_hierspeechpp_torch.ops import plm_decode as dec

D, F, L, BINS, H = 276, 1104, 4, 1024, 4
ROWS = {"wqkv": 3 * D, "wo": D, "ff0": F, "ff1": D, "pred": BINS}
FITS = (16, 15, 14, 13)  # the sizes whose plan fits at the shipped width


def test_shipped_width_fits_at_13_to_16_only():
    fits = []
    for n in dec.CLUSTER_SIZES:
        try:
            dec.cluster_plan(D, F, L, BINS, H, n)
            fits.append(n)
        except ValueError:
            pass
    assert tuple(fits) == FITS


@pytest.mark.parametrize("cluster", FITS)
@pytest.mark.parametrize("matrix", sorted(ROWS))
def test_every_row_is_owned_once(cluster, matrix):
    """CTA r owns rows [r * blk, r * blk + blk) clipped to the matrix; the
    blocks cover every row once, each a whole number of 4-row (16-byte)
    handoff units."""
    rows, blk = ROWS[matrix], dec.cluster_plan(D, F, L, BINS, H, cluster)["blocks"][matrix]
    assert blk % 4 == 0
    owner = np.full(rows, -1)
    for r in range(cluster):
        lo, hi = r * blk, min(rows, r * blk + blk)
        assert (owner[lo:hi] == -1).all()
        owner[lo:hi] = r
        assert max(0, hi - lo) % 4 == 0
    assert (owner >= 0).all()


@pytest.mark.parametrize("cluster", FITS)
def test_row_copies_are_whole_16_byte_units(cluster):
    """Rows of rd (D inputs) and rf (F inputs) bf16 weights, each row one
    bulk copy; the LayerNorm weights' copy (4 D floats) too."""
    lay = dec.cluster_plan(D, F, L, BINS, H, cluster)
    assert (lay["rd"], lay["rf"]) == (280, 1104)
    assert 2 * lay["rd"] % 16 == 0 and 2 * lay["rf"] % 16 == 0
    assert 4 * 4 * D % 16 == 0
    assert 2 * lay["hdp"] % 16 == 0 and lay["hdp"] == 72


@pytest.mark.parametrize("cluster", FITS)
def test_cta_fits_shared_memory(cluster):
    lay = dec.cluster_plan(D, F, L, BINS, H, cluster)
    assert lay["bytes"] + dec.STATIC_SMEM <= dec.SMEM_LIMIT
    kc = lay["key_chunk"]
    assert kc >= dec.KEY_CHUNK_STEP and kc % dec.KEY_CHUNK_STEP == 0
    assert kc <= dec.MAX_KEY_CHUNK
    assert lay["nsplit"] == cluster // H
    # the matrices alone: the layer's share (and pred's, on the last layer)
    b = lay["blocks"]
    weights = 2 * ((b["wqkv"] + b["wo"] + b["ff0"] + b["pred"]) * 280
                   + b["ff1"] * 1104)
    assert weights < lay["bytes"]
    assert {16: 160_640, 14: 176_320}.get(cluster, weights) == weights
    assert lay["pairs"] == 2 * ((L - 1) * D + 2 * cluster)


@pytest.mark.parametrize("cluster", FITS)
@pytest.mark.parametrize("t", [1, 37, 500, 1100])
def test_cache_addresses_every_entry_once(cluster, t):
    """(L, H, nsplit, cdiv(T, nsplit), 2, hdp): every (layer, token, k/v,
    head, dim < hd) its own element inside the cache; a split's keys at
    consecutive slots, so its cached keys are one contiguous range."""
    lay = dec.cluster_plan(D, F, L, BINS, H, cluster)
    shape = dec.cache_shape(L, H, lay["nsplit"], t, lay["hdp"])
    layer, token, kv, head, dim = np.meshgrid(
        np.arange(L), np.arange(t), np.arange(2), np.arange(H),
        np.arange(D // H), indexing="ij")
    idx = dec.cache_index(layer, token, kv, head, dim, shape).ravel()
    assert idx.min() >= 0 and idx.max() < np.prod(shape)
    assert np.unique(idx).size == idx.size
    ns = lay["nsplit"]
    for s in range(min(ns, t)):
        keys = np.arange(s, t, ns)
        base = dec.cache_index(0, keys, 0, 0, 0, shape)
        assert (np.diff(base) == 2 * lay["hdp"]).all()


@pytest.mark.parametrize("cluster", [12, 11, 10])
def test_shipped_width_does_not_fit_below_13(cluster):
    with pytest.raises(ValueError, match="shared memory"):
        dec.cluster_plan(D, F, L, BINS, H, cluster)


@pytest.mark.parametrize("d,f,h", [(512, 2048, 8), (276, 4096, 4)])
def test_wider_model_raises(d, f, h):
    for n in dec.CLUSTER_SIZES:
        with pytest.raises(ValueError):
            dec.cluster_plan(d, f, L, BINS, h, n)
    with pytest.raises(ValueError, match="no cluster size"):
        dec.pick_cluster(d, f, L, BINS, h, lambda n, nbytes: 7)


@pytest.mark.parametrize("d,h,n", [(276, 2, 16), (280, 20, 16), (276, 4, 17),
                                   (276, 4, 9)])
def test_shape_the_kernel_does_not_take_raises(d, h, n):
    """A head wider than 96 dims, more heads than CTAs, a size out of
    10-16."""
    with pytest.raises(ValueError):
        dec.cluster_plan(d, F, L, BINS, h, n)


@pytest.mark.parametrize("dtype", [dec.torch.float32, dec.torch.float16])
def test_float32_weights_are_refused(dtype):
    with pytest.raises(ValueError, match="bf16 weights only"):
        dec.cluster_plan(D, F, L, BINS, H, 16, dtype)


@pytest.mark.parametrize("active,want", [
    ({n: 7 for n in range(10, 17)}, 16),   # the H100's 7 at every size
    ({16: 3, 15: 4}, 15),
    ({16: 0, 15: 2, 14: 4}, 14),
    ({16: 0, 15: 0, 14: 0, 13: 4}, 13),
])
def test_pick_cluster_takes_the_largest_that_runs(active, want):
    asked = []

    def max_active(n, nbytes):
        asked.append(n)
        assert nbytes == dec.cluster_plan(D, F, L, BINS, H, n)["bytes"]
        return active.get(n, 0)

    n, lay = dec.pick_cluster(D, F, L, BINS, H, max_active)
    assert n == want and lay == dec.cluster_plan(D, F, L, BINS, H, n)
    assert asked == list(range(16, want - 1, -1))


def test_pick_cluster_raises_when_too_few_clusters_are_resident():
    with pytest.raises(ValueError, match="3 clusters resident at once"):
        dec.pick_cluster(D, F, L, BINS, H, lambda n, nbytes: 3)


def test_cluster_constants_match_the_cuda_source():
    src = (Path(dec.__file__).parents[1] / "csrc" / "plm_decode_bf16.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kMaxCluster"), const("kMinCluster")) == (
        dec.CLUSTER_SIZES[0], dec.CLUSTER_SIZES[-1])
    assert const("kMaxHeadDim") == dec.MAX_HEAD_DIM
    assert const("kMaxKeyChunk") == dec.MAX_KEY_CHUNK
    assert const("kKeyChunkStep") == dec.KEY_CHUNK_STEP
    assert const("kSmemLimit") == dec.SMEM_LIMIT
    assert const("kStaticSmem") == dec.STATIC_SMEM
    assert const("kStampCols") == dec.STAMP_COLS
    # the stamp columns' order: enum kReady = 0, kQkvOut, ... as named
    enum = re.search(r"enum : int \{\s*(kReady = 0,[^}]*)\}", src).group(1)
    names = [re.sub(r"(?<!^)([A-Z])", r"_\1", n.strip().split()[0][1:]).lower()
             for n in enum.split(",") if n.strip()]
    assert tuple(names) == dec.STAMP_COLUMNS
    assert const("kThreads") // 32 == dec.WARPS
    for line in ("p.bq = up4(cdiv(3 * D, N));", "p.rd = upn(D, 8);",
                 "p.hdp = upn(p.hd, 8);", "p.nsplit = N / H;",
                 "p.x_parity = ((L - 1) * D + 2 * N) * C;"):
        assert line in src


def test_one_column_is_the_one_row_layout():
    lay = dec.cluster_plan(D, F, L, BINS, H, 16, columns=1)
    assert lay == dec.cluster_plan(D, F, L, BINS, H, 16)
    assert (lay["bytes"], lay["key_chunk"], lay["columns"]) == (226_112, 128, 1)


@pytest.mark.parametrize("columns", range(1, dec.MAX_ROWS + 1))
def test_every_column_count_fits_at_16(columns):
    lay = dec.cluster_plan(D, F, L, BINS, H, 16, columns=columns)
    assert lay["bytes"] + dec.STATIC_SMEM <= dec.SMEM_LIMIT
    assert lay["pairs"] == 2 * columns * ((L - 1) * D + 2 * 16)
    if columns > 1:
        # a chunk is one four-key step of every warp; pred's block fits the
        # ring of stages it passes through
        assert lay["key_chunk"] == dec.GROUP_KEYS == 4 * dec.WARPS
        stage = 4 * dec.RING_SLOTS * dec.GROUP_KEYS * lay["hdp"]
        assert 2 * lay["blocks"]["pred"] * lay["rd"] <= stage
    assert {1: 226_112, 4: 231_184}.get(columns, lay["bytes"]) == lay["bytes"]


def test_one_column_more_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        dec.cluster_plan(D, F, L, BINS, H, 16, columns=dec.MAX_ROWS + 1)


@pytest.mark.parametrize("t", [1, 37, 500, 1100])
def test_each_rows_cache_addresses_every_entry_once(t):
    """A launch of MAX_ROWS rows takes (rows, *cache_shape): every (row,
    layer, token, k/v, head, dim < hd) its own element, row r's inside its
    own region."""
    lay = dec.cluster_plan(D, F, L, BINS, H, 16, columns=dec.MAX_ROWS)
    shape = dec.cache_shape(L, H, lay["nsplit"], t, lay["hdp"])
    size = int(np.prod(shape))
    row, layer, token, kv, head, dim = np.meshgrid(
        np.arange(dec.MAX_ROWS), np.arange(L), np.arange(t), np.arange(2),
        np.arange(H), np.arange(D // H), indexing="ij")
    idx = dec.cache_index(layer, token, kv, head, dim, shape, row).ravel()
    assert np.unique(idx).size == idx.size
    assert ((idx // size) == row.ravel()).all()
    assert idx.min() >= 0 and idx.max() < dec.MAX_ROWS * size


@pytest.mark.parametrize("cluster,active,runs", [
    (16, 7, True),    # the H100: 7 clusters of 16 at once
    (16, 3, False),   # fewer clusters resident than layers
    (15, 7, False),   # one-row key chunk 112: other four-key steps
    (14, 7, False),
    (13, 7, False),
])
def test_pick_rows_only_where_rows_keep_their_sums(cluster, active, runs):
    got = dec.pick_rows(D, F, L, BINS, H, cluster, lambda n, nbytes: active)
    if runs:
        assert got == dec.cluster_plan(D, F, L, BINS, H, cluster,
                                       columns=dec.MAX_ROWS)
    else:
        assert got is None


def test_column_limit_matches_the_cuda_source():
    src = (Path(dec.__file__).parents[1] / "csrc" / "plm_decode_bf16.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kMaxRows")) == dec.MAX_ROWS
    assert const("kGroupKeys") == "4 * kWarps" and dec.GROUP_KEYS == 4 * dec.WARPS
    assert int(const("kRingSlots")) == dec.RING_SLOTS
    assert "plm_decode_rows_kernel<kMaxRows>" in src
    for line in ("p.o_ln = p.o_pred / 2;", "p.so = up4(imax(p.bp, imax(p.bo, p.b1)));",
                 "p.sp = imax(H * p.nsplit * p.ps, p.rf);",
                 "p.o_stage = p.o_red + imax(kWarps * 16 * C, C * kWarps * p.ps);",
                 "const int stage = imax(kRingSlots * kGroupKeys * p.hdp, p.bp * p.rd / 2);"):
        assert line in src
