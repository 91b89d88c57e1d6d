"""The port's CUDA kernels on the card, against their plain PyTorch versions.

These tests need an NVIDIA card and skip without one (a CUDA kernel has no
CPU mode). They import neither JAX nor this directory's conftest helpers,
so the card's machine runs them without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from hivemall_tpu_torch.catalog import lookup
from hivemall_tpu_torch.io.sparse import SparseDataset
from hivemall_tpu_torch.ops.fm_parts import parts_lane_patterns
from hivemall_tpu_torch.ops.parts_scatter import (
    parts_scatter_adagrad, parts_scatter_adagrad_reference)

F, K, MRF, N = 31, 8, 1 << 10, 1024
FK = F * K


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _operands(seed):
    """Gradients on a 1/256 grid (bf16-exact, so every f32 sum is exact in
    any order), Zipf-skewed rows so slots collide, the count lane set to
    each slot's presence; bf16 table, positive accumulators."""
    rng = np.random.default_rng(seed)
    rows = np.minimum(rng.zipf(1.3, (F, N)) - 1, MRF - 1).astype(np.int32)
    grad = (rng.integers(-64, 65, (F, N, 2, 128)) / 256.0).astype(np.float32)
    grad[:, :, 1, FK + 2 - 128:] = 0.0
    grad[:, :, 1, FK + 2 - 128] = rng.random((F, N)) < 0.9
    T2 = np.zeros((F * MRF, 256), np.float32)
    T2[:, :FK + 1] = rng.normal(0.0, 0.1, (F * MRF, FK + 1))
    S2 = rng.uniform(0.0, 1.0, (F * MRF * 2, 128)).astype(np.float32)
    return (torch.from_numpy(rows),
            torch.from_numpy(grad).to(torch.bfloat16),
            torch.from_numpy(T2).to(torch.bfloat16).view(-1, 128),
            torch.from_numpy(S2))


@pytest.mark.cuda
@pytest.mark.parametrize("lam_on", [False, True], ids=["no_l2", "l2"])
def test_kernel_matches_plain_version(lam_on):
    dev = _card()
    rows, grad, T2, S2 = (t.to(dev) for t in _operands(7))
    lam8, live8 = parts_lane_patterns(F, K, 0.02, 0.01, dev)
    kw = dict(F=F, MRF=MRF, FK=FK, lam_on=lam_on)
    Tk, Sk = T2.clone(), S2.clone()
    before = parts_scatter_adagrad.launches
    out = parts_scatter_adagrad(rows, grad, Tk, Sk, 0.1, lam8, live8, **kw)
    assert parts_scatter_adagrad.launches == before + 1
    assert out[0] is Tk and out[1] is Sk
    Tp, Sp = T2.clone(), S2.clone()
    parts_scatter_adagrad_reference(rows, grad, Tp, Sp, 0.1, lam8, live8,
                                    **kw)
    torch.cuda.synchronize()
    assert torch.equal(Sk, Sp)
    assert torch.equal(Tk, Tp)
    assert not torch.equal(Tk, T2)


@pytest.mark.cuda
def test_wrapper_refuses_mixed_devices():
    dev = _card()
    rows, grad, T2, S2 = _operands(8)
    lam8, live8 = parts_lane_patterns(F, K, 0.0, 0.0, dev)
    with pytest.raises(ValueError, match="is on"):
        parts_scatter_adagrad(rows, grad.to(dev), T2.to(dev), S2.to(dev),
                              0.1, lam8, live8, F=F, MRF=MRF, FK=FK,
                              lam_on=False)


@pytest.mark.cuda
def test_trainer_runs_on_the_card_by_default():
    _card()
    B = 256
    opts = (f"-dims 65536 -factors {K} -fields {F} -mini_batch {B} "
            "-opt adagrad -classification -halffloat -ffm_table parts")
    t = lookup("train_ffm").resolve()(opts)
    assert t.device.type == "cuda" and t._pack_input_on()
    rng = np.random.default_rng(9)
    n = 3 * B
    idx = rng.integers(1, 65536, (n, F)).astype(np.int32)
    lab = (idx[:, 0] % 2).astype(np.float32)
    ds = SparseDataset(idx.ravel(), np.arange(n + 1, dtype=np.int64) * F,
                       np.ones(n * F, np.float32), lab,
                       np.tile(np.arange(F, dtype=np.int32), n))
    before = parts_scatter_adagrad.launches
    t.fit(ds)
    assert parts_scatter_adagrad.launches - before == t._t == 3
    assert t.params["T2"].is_cuda and t.opt_state["T2"]["gg"].is_cuda
    p = t.predict(ds)
    assert p.shape == (n,) and np.isfinite(p).all()


# --- the level-histogram kernels (B3-B6) ------------------------------------

def _hist_operands(seed, n, d, M, B, S, E=None, exact=True, skew=False):
    """Bin codes with -1 padding, node ids with inactive rows, and channels
    on a 1/256 grid (sums exact in float32 in any order) or N(0,1)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, d)).astype(np.int32)
    shape = (n,) if E is None else (E, n)
    loc = rng.integers(-1, M, shape).astype(np.int32)
    if skew:
        loc[...] = M // 3
        loc[..., ::5] = -1
    ws = (rng.integers(-64, 65, shape + (S,)) / 256.0 if exact
          else rng.normal(size=shape + (S,))).astype(np.float32)
    return bins, loc, ws


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 256])
def test_dense_int_kernel_is_bit_exact(M):
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    n, d, B, S, E = 40_000, 28, 64, 2, 4
    rng = np.random.default_rng(M)
    bins = torch.from_numpy(rng.integers(0, B, (n, d)).astype(np.uint8))
    loc = torch.from_numpy(rng.integers(-1, M, (E, n)).astype(np.int32))
    ws = torch.from_numpy(
        (np.eye(S)[rng.integers(0, S, n)][None]
         * rng.poisson(1.0, (E, n, 1))).astype(np.float32))
    bt, loc, ws = H.transpose_bins(bins).to(dev), loc.to(dev), ws.to(dev)
    before = H.hist_dense_int.launches
    got = H.level_histogram_dense(bt, loc, ws, M, B, fast=True)
    assert H.hist_dense_int.launches == before + 1
    want = H.level_histogram_dense_reference(bt, loc, ws, M, B)
    torch.cuda.synchronize()
    assert got.shape == (E, M, 32, B, S)
    assert torch.equal(got, want)
    assert float(got[:, :, d:].abs().sum()) == 0.0    # padded features
    assert torch.equal(H.level_histogram_dense(bt, loc[1], ws[1], M, B,
                                               fast=True), want[1])


@pytest.mark.cuda
def test_dense_int_kernel_rounds_fractional_channels_as_the_cpu():
    """A fractional channel on the integer path is rounded half to even on
    the card and in the plain version the CPU takes: the same histogram."""
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, _ = _hist_operands(11, 20_000, 9, 16, 64, 2, E=2)
    rng = np.random.default_rng(11)
    ws = rng.choice(np.array([-2.5, -0.5, 0.25, 0.5, 0.75, 1.5, 2.5, 3.0],
                             np.float32), (2, 20_000, 2))
    bt = H.transpose_bins(torch.from_numpy(bins))
    loc, ws = torch.from_numpy(loc), torch.from_numpy(ws)
    cpu = H.level_histogram_dense(bt, loc, ws, 16, 64, fast=True)
    got = H.level_histogram_dense(bt.to(dev), loc.to(dev), ws.to(dev), 16,
                                  64, fast=True)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 64])
def test_dense_f32_kernel(M):
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    n, d, B, S = 30_000, 13, 64, 3
    for exact in (True, False):
        bins, loc, ws = _hist_operands(M, n, d, M, B, S, E=2, exact=exact)
        bt = H.transpose_bins(torch.from_numpy(bins)).to(dev)
        loc, ws = torch.from_numpy(loc).to(dev), torch.from_numpy(ws).to(dev)
        before = H.hist_dense_f32.launches
        got = H.level_histogram_dense(bt, loc, ws, M, B, fast=False)
        assert H.hist_dense_f32.launches == before + 1
        if exact:
            want = H.level_histogram_dense_reference(bt, loc, ws, M, B)
            assert torch.equal(got, want)
        else:
            # float32 sums in another order: within 64 eps of the sum of
            # magnitudes of each cell, against a float64 sum
            want = H.level_histogram_dense_reference(bt, loc, ws, M, B,
                                                     dtype=torch.float64)
            mag = H.level_histogram_dense_reference(bt, loc, ws.abs(), M, B,
                                                    dtype=torch.float64)
            err = (got.double() - want).abs()
            assert bool((err <= 64 * 2.0 ** -23 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,S", [(4, 64, 3), (256, 64, 2), (32, 100, 11)])
def test_flat_kernel_is_exact_on_exact_sums(M, B, S):
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(7, 20_000, 9, M, B, S)
    args = [torch.from_numpy(a).to(dev) for a in (bins, loc, ws)]
    before = H.level_histogram.launches
    got = H.level_histogram(*args, M, B)
    assert H.level_histogram.launches == before + -(-S // 8)
    assert torch.equal(got, H.level_histogram_reference(*args, M, B))
    u8 = H.level_histogram(args[0].to(torch.uint8), *args[1:], M, B)
    assert torch.equal(u8, got)


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,S,skew", [(256, 64, 2, False),
                                        (8, 64, 11, False),
                                        (128, 64, 1, True),
                                        (3000, 32, 2, False)])
def test_sorted_kernel_is_exact_on_exact_sums(M, B, S, skew):
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(9, 50_000, 28, M, B, S, skew=skew)
    loc[-3000:] = -1                          # trailing inactive chunks
    args = [torch.from_numpy(a).to(dev) for a in (bins, loc, ws)]
    before = H.level_histogram_sorted.launches
    got = H.level_histogram_sorted(*args, M, B)
    assert H.level_histogram_sorted.launches == before + 1
    assert torch.equal(got, H.level_histogram_sorted_reference(*args, M, B))


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["level_histogram", "level_histogram_sorted"])
def test_row_kernels_within_tolerance_on_float_channels(fn):
    """N(0,1) channels: float32 sums in another order, within 64 eps of
    each cell's sum of magnitudes against a float64 sum."""
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(5, 40_000, 28, 64, 64, 3, exact=False)
    args = [torch.from_numpy(a).to(dev) for a in (bins, loc, ws)]
    got = getattr(H, fn)(*args, 64, 64)
    ref = (H.level_histogram_reference if fn == "level_histogram"
           else H.level_histogram_sorted_reference)
    want = ref(*args, 64, 64, dtype=torch.float64)
    mag = ref(args[0], args[1], args[2].abs(), 64, 64, dtype=torch.float64)
    assert bool(((got.double() - want).abs() <= 64 * 2.0 ** -23 * mag).all())


@pytest.mark.cuda
def test_sorted_falls_back_to_flat_for_odd_bins():
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(3, 5000, 4, 16, 100, 2)
    args = [torch.from_numpy(a).to(dev) for a in (bins, loc, ws)]
    s0, f0 = H.level_histogram_sorted.launches, H.level_histogram.launches
    got = H.level_histogram_sorted(*args, 16, 100)
    assert H.level_histogram_sorted.launches == s0
    assert H.level_histogram.launches == f0 + 1
    assert torch.equal(got, H.level_histogram_reference(*args, 16, 100))


@pytest.mark.cuda
@pytest.mark.parametrize("M,skew", [(1, False), (256, False), (3000, False),
                                    (64, True), (20000, False)])
def test_node_bucket_matches_plain_version(M, skew):
    """Offsets equal exactly; each node's bucket holds the same rows (the
    order inside a bucket is unset on the card). M=20000 counts in global
    memory, the others in shared memory."""
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    n = 300_000
    rng = np.random.default_rng(M)
    loc = rng.integers(-3, M + 3, n).astype(np.int32)
    if skew:
        loc[rng.random(n) < 0.9] = M // 2
    loc = torch.from_numpy(loc).to(dev)
    before = H.node_bucket.launches
    order, offsets = H.node_bucket(loc, M)
    assert H.node_bucket.launches == before + 1
    want_order, want_offsets = H.node_bucket_reference(loc, M)
    torch.cuda.synchronize()
    assert order.dtype == torch.int32 and torch.equal(offsets, want_offsets)
    key = H._node_keys(loc, M).long()

    def by_key_then_row(o):
        o = o.long()
        return torch.sort(key[o] * n + o).values

    assert torch.equal(key[order.long()], key[want_order.long()])
    assert torch.equal(by_key_then_row(order), by_key_then_row(want_order))


@pytest.mark.cuda
@pytest.mark.parametrize("M,B,S", [(256, 64, 2), (8, 64, 11), (3000, 32, 2)])
@pytest.mark.parametrize("fn", ["level_histogram", "level_histogram_sorted"])
def test_row_kernels_read_uint8_and_int32_codes_alike(fn, M, B, S):
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(21, 60_000, 28, M, B, S)
    b32 = torch.from_numpy(bins).to(dev)
    loc, ws = torch.from_numpy(loc).to(dev), torch.from_numpy(ws).to(dev)
    got32 = getattr(H, fn)(b32, loc, ws, M, B)
    got8 = getattr(H, fn)(b32.to(torch.uint8), loc, ws, M, B)
    want = H.level_histogram_reference(b32, loc, ws, M, B)
    torch.cuda.synchronize()
    assert torch.equal(got32, want) and torch.equal(got8, want)


@pytest.mark.cuda
def test_sorted_kernel_splits_a_node_of_most_rows():
    """One node holds 90% of the rows: it spans many slices, each its own
    block, all flushing into one node's histogram."""
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    n, d, M, B, S = 200_000, 28, 64, 64, 2
    bins, loc, ws = _hist_operands(22, n, d, M, B, S)
    loc[np.random.default_rng(22).random(n) < 0.9] = 17
    plan = H._sorted_plan(n, d, M, B, S, H._sms(dev))
    assert int((loc == 17).sum()) > 20 * plan.rows
    args = [torch.from_numpy(a).to(dev) for a in (bins, loc, ws)]
    got = H.level_histogram_sorted(args[0].to(torch.uint8), *args[1:], M, B)
    assert torch.equal(got, H.level_histogram_reference(*args, M, B))


@pytest.mark.cuda
def test_row_kernels_sort_no_keys_and_copy_no_codes(monkeypatch):
    """On the card level_histogram_sorted buckets rows with node_bucket (no
    torch.argsort, sort or cumsum), and neither row kernel makes an int32
    copy of uint8 codes: the peak memory of both calls stays below half
    of such a copy."""
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    n, d, M, B = 400_000, 28, 256, 64
    bins, loc, ws = _hist_operands(23, n, d, M, B, 2)
    bins = torch.from_numpy(bins).to(dev).to(torch.uint8)
    loc, ws = torch.from_numpy(loc).to(dev), torch.from_numpy(ws).to(dev)
    fns = (H.level_histogram_sorted, H.level_histogram)
    for fn in fns:                                  # build and warm up
        fn(bins, loc, ws, M, B)

    def refuse(*a, **k):
        raise AssertionError("sorted or scanned on the card")

    for name in ("argsort", "sort", "cumsum"):
        monkeypatch.setattr(torch, name, refuse)
        monkeypatch.setattr(torch.Tensor, name, refuse)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    s0 = H.node_bucket.launches
    outs = [fn(bins, loc, ws, M, B) for fn in fns]
    torch.cuda.synchronize()
    assert H.node_bucket.launches == s0 + 1
    assert torch.cuda.max_memory_allocated() - base < 4 * n * d // 2
    monkeypatch.undo()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_hist_wrappers_refuse_mixed_devices():
    from hivemall_tpu_torch.ops import hist as H
    dev = _card()
    bins, loc, ws = _hist_operands(4, 100, 3, 2, 16, 1)
    bt = H.transpose_bins(torch.from_numpy(bins))
    with pytest.raises(ValueError, match="is on"):
        H.level_histogram_dense(bt.to(dev), torch.from_numpy(loc),
                                torch.from_numpy(ws).to(dev), 2, 16)
    with pytest.raises(ValueError, match="is on"):
        H.level_histogram(torch.from_numpy(bins).to(dev),
                          torch.from_numpy(loc), torch.from_numpy(ws), 2, 16)


@pytest.mark.cuda
def test_tree_trainers_run_on_the_card_by_default():
    from hivemall_tpu_torch.ops import hist as H
    _card()
    rng = np.random.default_rng(5)
    X = rng.normal(size=(3000, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(int)
    opts = "-trees 4 -depth 4 -bins 32 -seed 3 -vars 6"
    rf = lookup("train_randomforest_classifier").resolve()
    before = H.hist_dense_int.launches
    g = rf(opts).fit(X, y)
    assert g.device.type == "cuda"
    assert H.hist_dense_int.launches - before == 5       # one a level
    c = rf(opts, device="cpu").fit(X, y)
    for k in ("feat", "thr", "value"):
        np.testing.assert_array_equal(getattr(g.tree, k), getattr(c.tree, k))
    assert g.oob_errors == c.oob_errors
    gb = lookup("train_xgboost_classifier").resolve()
    before = H.hist_dense_f32.launches
    m = gb("-num_round 3 -max_depth 3 -bins 32").fit(X, y)
    assert H.hist_dense_f32.launches - before == 12      # 3 rounds x 4
    p = m.predict(X)
    assert p.shape == (3000,) and np.isfinite(p).all()


# --- the sharded step's kernels (B2 and the tail entry) and -mesh -------------

@pytest.mark.cuda
def test_accum_kernel_matches_plain_version():
    from hivemall_tpu_torch.ops.parts_scatter import (_accumulate_reference,
                                                      parts_scatter_accum)
    dev = _card()
    rows, grad, _, _ = (t.to(dev) for t in _operands(12))
    before = parts_scatter_accum.launches
    G = parts_scatter_accum(rows, grad, F=F, MRF=MRF)
    assert parts_scatter_accum.launches == before + 1
    want = _accumulate_reference(rows, grad, F, MRF)
    torch.cuda.synchronize()
    assert G.shape == (F * MRF, 256) and torch.equal(G, want)
    # a local row outside [0, MRF) is dropped on the card
    bad = rows.clone()
    bad[0, :7] = MRF + 3
    keep = rows.clone()
    keep[0, :7] = 0
    g2 = grad.clone()
    g2[0, :7] = 0
    G2 = parts_scatter_accum(bad, grad, F=F, MRF=MRF)
    assert torch.equal(G2, _accumulate_reference(keep, g2, F, MRF))


@pytest.mark.cuda
@pytest.mark.parametrize("lam_on", [False, True], ids=["no_l2", "l2"])
def test_tail_kernel_matches_plain_version(lam_on):
    from hivemall_tpu_torch.ops.parts_scatter import (
        _accumulate_reference, _adagrad_tail_reference, parts_adagrad_tail)
    dev = _card()
    rows, grad, T2, S2 = (t.to(dev) for t in _operands(13))
    G = _accumulate_reference(rows, grad, F, MRF)
    lam8, live8 = parts_lane_patterns(F, K, 0.02, 0.01, dev)
    Tk, Sk = T2.clone(), S2.clone()
    before = parts_adagrad_tail.launches
    out = parts_adagrad_tail(G, Tk, Sk, 0.1, lam8, live8, FK=FK,
                             lam_on=lam_on)
    assert parts_adagrad_tail.launches == before + 1
    assert out[0] is Tk and out[1] is Sk
    Tp, Sp = T2.clone(), S2.clone()
    _adagrad_tail_reference(G, Tp, Sp, 0.1, lam8, live8, FK=FK,
                            lam_on=lam_on)
    torch.cuda.synchronize()
    assert torch.equal(Tk, Tp) and torch.equal(Sk, Sp)


@pytest.mark.cuda
def test_mesh_trainer_in_a_one_rank_nccl_group():
    """-mesh dp=1,tp=1 inside the one-rank NCCL group init_distributed()
    makes: B2 and the tail once a step, B1 never, the same scores as the
    single-device trainer within 1e-3."""
    import torch.distributed as dist
    from hivemall_tpu_torch.ops.parts_scatter import (parts_adagrad_tail,
                                                      parts_scatter_accum)
    from hivemall_tpu_torch.parallel.mesh import init_distributed
    _card()
    B = 256
    opts = (f"-dims 65536 -factors {K} -fields {F} -mini_batch {B} "
            "-opt adagrad -classification -halffloat -ffm_table parts")
    rng = np.random.default_rng(10)
    n = 3 * B
    idx = rng.integers(1, 65536, (n, F)).astype(np.int32)
    ds = SparseDataset(idx.ravel(), np.arange(n + 1, dtype=np.int64) * F,
                       np.ones(n * F, np.float32),
                       (idx[:, 0] % 2).astype(np.float32),
                       np.tile(np.arange(F, dtype=np.int32), n))
    one = lookup("train_ffm").resolve()(opts).fit(ds)
    init_distributed("nccl")
    try:
        counts = [f.launches for f in (parts_scatter_accum,
                                       parts_adagrad_tail,
                                       parts_scatter_adagrad)]
        t = lookup("train_ffm").resolve()(opts + " -mesh dp=1,tp=1")
        t.fit(ds)
        assert [f.launches for f in (parts_scatter_accum, parts_adagrad_tail,
                                     parts_scatter_adagrad)] == \
            [counts[0] + 3, counts[1] + 3, counts[2]]
        assert t.params["T2"].is_cuda
        p = t.predict(ds)
    finally:
        dist.destroy_process_group()
    assert np.abs(p - one.predict(ds)).max() < 1e-3
