"""Launch plan of the parts bucketing and reduction (B1, B2), and the plain
version of parts_row_bucket, on the CPU.

The plan (hivemall_tpu_torch.ops.parts_scatter._scatter_plan) is plain
Python; kernels/parts_scatter_adagrad.cu takes its integers. ``_pieces``
below splits the sorted positions into tiles and parks the pieces of rows
that span tiles exactly as reduce_tile / finish_segment do, so these tests
hold what every launch relies on: the chunks cover each field's slots once,
shared memory and the grid stay within an H100's limits, every valid
position is reduced by one warp, and the parked pieces of each row are
written to distinct slots and read back, in tile order, by one warp.
"""
import itertools

import numpy as np
import pytest
import torch

from hivemall_tpu_torch.ops import parts_scatter as PS

SMEM_MAX = 227 * 1024
GRID_X = 2 ** 31 - 1

_SWEEP = list(itertools.product([1, 3, 10, 40, 248],            # F
                                [1024, 2048, 8192, 16384, 65536],  # MRF
                                [0, 1, 1000, 32768, 65536, 131072]))  # n


@pytest.mark.parametrize("F,MRF,n", _SWEEP,
                         ids=[f"F{f}-M{m}-n{n}" for f, m, n in _SWEEP])
def test_plan_covers_every_slot_within_the_cards_limits(F, MRF, n):
    p = PS._scatter_plan(F, n, MRF)
    tile = p.tile
    # bucketing: chunks of one field cover its n slots once
    assert p.chunks >= 1 and p.chunk >= 1
    assert p.chunks * p.chunk >= n
    assert n > (p.chunks - 1) * p.chunk or p.chunks == 1
    assert F * p.chunks <= GRID_X
    assert p.smem_keys == int(4 * (MRF + 1) <= 48 * 1024)
    assert p.count_smem == 4 * (MRF + 1) * p.smem_keys
    assert p.scatter_smem == p.count_smem + 4 * p.chunk <= SMEM_MAX
    counters = 4 * F * p.chunks * (MRF + 1)
    assert counters <= 64 << 20 or p.chunk * 2 > 16384 or p.chunks == 1 \
        or p.chunk >= n
    # reduction: tiles of `tile` positions cover every slot once
    assert tile % 32 == 0
    assert p.tiles * tile >= F * n > (p.tiles - 1) * tile
    assert -(-p.tiles // PS._WARPS) + p.zero_blocks <= GRID_X
    assert 1 <= p.zero_blocks <= PS._ZERO_BLOCKS
    assert p.zero_blocks * 32 * PS._WARPS >= min(F * MRF,
                                                 PS._ZERO_BLOCKS * 256)
    assert p.ints == 2 * F * n + F * MRF + 1 + F * p.chunks * (MRF + 2) \
        + p.tiles
    assert p.floats == 2 * p.tiles * 256


def test_plan_at_the_flagship_geometry():
    p = PS._scatter_plan(40, 32768, 8192)
    assert (p.chunk, p.chunks, p.smem_keys, p.tile, p.tiles) == \
        (4096, 8, 1, 128, 10240)
    assert p.scatter_smem == 4 * 8193 + 4 * 4096
    assert p.ints * 4 < 24 << 20 and p.floats * 4 == 20 << 20


def test_plan_refuses_what_the_kernels_cannot_take():
    for args in ((0, 10, 1024), (4, 10, 0), (4, -1, 1024)):
        with pytest.raises(ValueError):
            PS._scatter_plan(*args)
    with pytest.raises(ValueError, match="int32"):
        PS._scatter_plan(64, 2 ** 25, 1024)


def _pieces(offsets: np.ndarray, tile: int):
    """Per tile t: (row, slot) of each parked piece and the rows finished
    whole, as reduce_tile / finish_segment decide them."""
    V = int(offsets[-1])
    row_of = np.repeat(np.arange(len(offsets) - 1), np.diff(offsets))
    whole, parked = [], {}
    for t in range(-(-V // tile)):
        p0, p1 = t * tile, min((t + 1) * tile, V)
        segs = np.unique(row_of[p0:p1])
        for i, r in enumerate(segs):
            lo, hi = int(offsets[r]), int(offsets[r + 1])
            if i not in (0, len(segs) - 1) or (lo >= p0 and hi <= p0 + tile):
                whole.append((t, r))
                continue
            slot = 2 * t if lo < p0 else 2 * t + 1
            parked.setdefault(r, []).append((t, slot))
    return whole, parked


@pytest.mark.parametrize("seed,F,MRF,n,tile,skew", [
    (0, 3, 64, 500, 32, 1.2), (1, 5, 1024, 4000, 256, 1.15),
    (2, 2, 16, 3000, 64, None), (3, 1, 8, 999, 32, 3.0)])
def test_tiles_reduce_each_row_once_and_park_pieces_apart(seed, F, MRF, n,
                                                          tile, skew):
    rng = np.random.default_rng(seed)
    if skew is None:                       # one row holds every slot
        rows = np.full((F, n), 3, np.int32)
    else:
        rows = np.minimum(rng.zipf(skew, (F, n)) - 1, MRF + 5).astype(
            np.int32)                      # some outside [0, MRF): dropped
    _, offsets = PS.parts_row_bucket_reference(torch.from_numpy(rows), MRF)
    offsets = offsets.numpy()
    whole, parked = _pieces(offsets, tile)
    touched = set(np.flatnonzero(np.diff(offsets)))
    assert {r for _, r in whole}.isdisjoint(parked)
    assert len(whole) == len({r for _, r in whole})
    assert {r for _, r in whole} | set(parked) == touched
    slots = [s for ps in parked.values() for _, s in ps]
    assert len(slots) == len(set(slots)) and max(slots, default=0) < \
        2 * -(-F * n // tile)
    for r, ps in parked.items():
        lo, hi = int(offsets[r]), int(offsets[r + 1])
        t0, t1 = lo // tile, (hi - 1) // tile
        assert [t for t, _ in ps] == list(range(t0, t1 + 1))
        # the last ticket's warp reads 2*t0 + 1, then 2*t for t0 < t <= t1
        assert [s for _, s in ps] == [2 * t0 + 1] + [2 * t for t in range(
            t0 + 1, t1 + 1)]


@pytest.mark.parametrize("seed,F,MRF,n", [(0, 1, 8, 50), (1, 4, 64, 700),
                                          (2, 40, 1024, 300)])
def test_row_bucket_reference_is_a_stable_argsort(seed, F, MRF, n):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-2, MRF + 2, (F, n)).astype(np.int32)
    rows[:, ::7] = rows[:, :1]                 # repeated rows in each field
    order, offsets = PS.parts_row_bucket_reference(torch.from_numpy(rows),
                                                   MRF)
    assert order.dtype == offsets.dtype == torch.int32
    assert order.shape == (F * n,) and offsets.shape == (F * MRF + 1,)
    ok = (rows >= 0) & (rows < MRF)
    key = np.where(ok, np.arange(F)[:, None] * MRF + rows, F * MRF).ravel()
    assert np.array_equal(order.numpy(), np.argsort(key, kind="stable"))
    want = np.concatenate([[0], np.cumsum(np.bincount(
        key, minlength=F * MRF + 1)[:F * MRF])])
    assert np.array_equal(offsets.numpy(), want)
    assert int(offsets[-1]) == int(ok.sum())


def test_row_bucket_on_the_cpu_is_its_plain_version():
    rows = torch.from_numpy(np.random.default_rng(4).integers(
        0, 40, (3, 90)).astype(np.int32))
    before = PS.parts_row_bucket.launches
    got = PS.parts_row_bucket(rows, 32)
    assert PS.parts_row_bucket.launches == before
    want = PS.parts_row_bucket_reference(rows, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for bad in (rows.long(), rows[:, ::2], rows[0]):
        with pytest.raises(ValueError, match="int32 \\[F, n\\]"):
            PS.parts_row_bucket(bad, 32)
    with pytest.raises(ValueError, match="MRF"):
        PS.parts_row_bucket(rows, 0)
