"""Launch plans of the flat (B5) and sorted (B6) level-histogram kernels, and
the plain version of node_bucket, on the CPU.

The plans (hivemall_tpu_torch.ops.hist._flat_plan / _sorted_plan) are plain
Python; the kernels in kernels/tree_hist.cu take their integers and derive
each block's tile from blockIdx exactly as ``_flat_tiles`` /
``_sorted_groups`` below do, so these tests hold the geometry every launch
gets: tiles cover each (node, feature) cell once, B5's tiles hold whole
nodes, shared memory and the grid stay within an H100's limits, and a
shallow level runs about two blocks an SM.
"""
import itertools

import numpy as np
import pytest
import torch

from hivemall_tpu_torch.ops import hist as H

SMS = 132                        # an H100 SXM's streaming multiprocessors
SMEM_MAX = 227 * 1024
GRID_X, GRID_Y = 2 ** 31 - 1, 65535
N = 1_000_000

_SWEEP = list(itertools.product([1, 2, 7, 64, 256, 3000],   # M
                                [2, 32, 64, 100, 256],       # B
                                [1, 2, 3, 8],                # S
                                [1, 9, 28, 64]))             # d


def _flat_tiles(plan, M, d):
    """(node0, nn, f0, nf) of every blockIdx.x, as flat_hist_kernel derives
    them."""
    n_fg = -(-d // plan.features)
    for bx in range(plan.grid[0]):
        fg = bx % n_fg
        node0, f0 = (bx // n_fg) * plan.nodes, fg * plan.features
        yield node0, min(plan.nodes, M - node0), f0, min(plan.features,
                                                         d - f0)


def _sorted_groups(plan, d):
    """(f0, nf) of every blockIdx.y, as sorted_hist_kernel derives them."""
    for by in range(plan.grid[1]):
        f0 = by * plan.features
        yield f0, min(plan.features, d - f0)


@pytest.mark.parametrize("M,B,S,d", _SWEEP,
                         ids=[f"M{m}-B{b}-S{s}-d{d}" for m, b, s, d in _SWEEP])
def test_plans_tile_every_cell_once_within_the_cards_limits(M, B, S, d):
    Sk = min(S, 8)
    # B5: whole nodes x feature groups; every (node, feature) cell in one tile
    p = H._flat_plan(N, d, M, B, S, SMS)
    seen = np.zeros((M, d), np.int32)
    for node0, nn, f0, nf in _flat_tiles(p, M, d):
        assert nn >= 1 and nf >= 1
        seen[node0:node0 + nn, f0:f0 + nf] += 1
    assert (seen == 1).all()
    assert p.smem <= SMEM_MAX
    assert p.smem >= 4 * p.nodes * p.features * B * Sk     # the tile fits
    assert 1 <= p.grid[0] <= GRID_X and 1 <= p.grid[1] <= GRID_Y
    assert p.grid[1] * p.rows >= N > (p.grid[1] - 1) * p.rows  # rows once
    tiles = p.grid[0]
    if tiles == 1:                                  # a shallow level
        assert p.grid[1] <= 2 * SMS
    assert tiles * p.grid[1] <= max(2 * SMS + tiles, tiles)
    # B6: one node a block, feature groups covering d once
    q = H._sorted_plan(N, d, M, B, S, SMS)
    feats = np.zeros(d, np.int32)
    for f0, nf in _sorted_groups(q, d):
        assert nf >= 1
        feats[f0:f0 + nf] += 1
    assert (feats == 1).all() and q.nodes == 1
    assert q.smem <= SMEM_MAX
    assert q.smem >= 4 * q.features * B * Sk
    assert 1 <= q.grid[0] <= GRID_X and 1 <= q.grid[1] <= GRID_Y
    # gridDim.x bounds sum_k ceil(rows_k / L) for any split of N rows
    assert q.grid[0] >= -(-N // q.rows) + M
    # one node holding every row: about two blocks an SM in all
    assert -(-N // q.rows) * q.grid[1] <= 2 * SMS + q.grid[1]


@pytest.mark.parametrize("n", [0, 1, 100, 513])
def test_plans_at_few_rows(n):
    p = H._flat_plan(n, 28, 256, 64, 2, SMS)
    assert p.grid[1] >= 1 and p.rows >= 1 and p.grid[1] * p.rows >= n
    q = H._sorted_plan(n, 28, 256, 64, 2, SMS)
    assert q.rows >= 512 and q.grid[0] >= 256


def test_plans_refuse_a_tile_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        H._flat_plan(N, 4, 8, 7000, 8, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        H._sorted_plan(N, 4, 8, 7200, 8, SMS)
    assert H._sorted_plan(N, 4, 8, 6000, 8, SMS).smem <= SMEM_MAX


def _loc(seed, n, M, skew=False):
    rng = np.random.default_rng(seed)
    loc = rng.integers(-3, M + 3, n).astype(np.int32)    # some out of range
    if skew:
        loc[rng.random(n) < 0.9] = M // 2
    return torch.from_numpy(loc)


@pytest.mark.parametrize("M,skew", [(1, False), (7, False), (256, False),
                                    (3000, False), (64, True)])
def test_node_bucket_reference_against_sort_rows(M, skew):
    loc = _loc(M, 5000, M, skew)
    order, offsets = H.node_bucket_reference(loc, M)
    assert order.dtype == offsets.dtype == torch.int32
    assert offsets.shape == (M + 2,) and int(offsets[0]) == 0
    key = torch.where((loc >= 0) & (loc < M), loc, torch.full_like(loc, M))
    want = torch.cumsum(torch.bincount(key.long(), minlength=M + 1), 0)
    assert torch.equal(offsets[1:].long(), want)
    srt = H._sort_rows(loc, M)
    assert sorted(order.tolist()) == list(range(5000))
    for k in range(M + 1):                  # the same row set per node
        a, b = int(offsets[k]), int(offsets[k + 1])
        assert sorted(order[a:b].tolist()) == sorted(srt[a:b].tolist())
        if k < M:
            assert bool((loc[order[a:b].long()] == k).all())
    tail = loc[order[int(offsets[M]):].long()]
    assert bool(((tail < 0) | (tail >= M)).all())      # out of range last


def test_node_bucket_on_the_cpu_is_its_plain_version():
    loc = _loc(3, 900, 16)
    before = H.node_bucket.launches
    order, offsets = H.node_bucket(loc, 16)
    assert H.node_bucket.launches == before
    want = H.node_bucket_reference(loc, 16)
    assert torch.equal(order, want[0]) and torch.equal(offsets, want[1])
    for bad, err in ((loc.long(), "int32"), (loc[::2], "contiguous"),
                     (loc[None], "int32 \\[n\\]")):
        with pytest.raises(ValueError, match=err):
            H.node_bucket(bad, 16)
    with pytest.raises(ValueError, match="n_nodes"):
        H.node_bucket(loc, 0)
