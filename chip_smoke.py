"""Chip smoke of the PyTorch/CUDA port (hivemall_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero:

  1. card identity (nvidia-smi name and power limit, torch and CUDA
     versions); TF32 off for matmuls and cuDNN;
  2. build every kernel from the sources in this checkout, one nvcc per
     source, all started together;
  3. each kernel against its plain PyTorch version on the card, timed with
     CUDA events beside its bound and a PyTorch library call: the FFM
     scatter + AdaGrad kernel B1 at the flagship geometry (F=40,
     MRF=8192, B=32768), with its row bucketing (``parts_row_bucket``)
     alone, its peak memory over one call, and its one sum order (the
     same on a second run; equal bit for bit to the tail entry applied
     to B2's G); the sharded step's accumulate kernel B2 at the per-rank
     shapes of a 1x1 mesh (Fl=40, Bd=32768) and of dp=2,tp=4 (Fl=10,
     Bd=16384), and its AdaGrad tail entry at the first; the four
     level-histogram kernels at the tree bench's width (1M HIGGS-shaped
     rows, 28 features, 64 bins) at level 0 and at the deepest level of
     their trainer (RF: 16 trees, M=256; GBT: M=64); B5 and B6 with
     int32 codes (the kernels line) and the staged uint8 codes
     (``ms_uint8``), B6's bucketing (``node_bucket``) timed alone
     (``sort_ms``) and held against its plain version;
  4. the port trainers on the card against the same trainers on the CPU
     (the plain versions): FFM from one initial state on a small input;
     one sharded (1x1 mesh) FFM step, in a one-rank NCCL group on the card
     and a one-rank gloo group on the CPU, from one state; RF (bit-equal
     trees) and GBT on 20k rows;
  5. the main paths, each with every launch count zeroed just before and
     read just after: ``train_ffm`` for one epoch at the flagship width
     (B=32768, F=40, K=4, dims=2^24) then ``predict`` (16 launches of
     B1 and of parts_row_bucket);
     ``train_randomforest_classifier`` (16 trees, depth 8) and
     ``train_xgboost_classifier`` (8 rounds, depth 6) on a StagedMatrix
     of 1M x 28 rows, then predict on 100k held-out rows; the public
     histogram functions ``level_histogram`` / ``level_histogram_sorted``,
     which no trainer calls, on one level of the fitted forest (staged
     uint8 codes; 3 launches of B5, 1 of B6, 1 of node_bucket); and, in a
     one-rank NCCL group (``init_distributed``), ``train_ffm ... -mesh
     dp=1,tp=1`` on the same 16 batches (B2, the tail and the bucketing
     once a step, B1 never; held-out logloss and AUC within 1e-3 of the
     single-device epoch) and ``train_randomforest_classifier ... -mesh
     dp=1`` (the same forest bit for bit, 9 launches of B3).

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Writes the full report to
``chiprun_out/chip_smoke.json``. Without a CUDA card, or without the port
beside it, it exits non-zero and prints no result. ``--profile`` adds, after
the FFM main path, the host stages of four more steps and a torch.profiler
table of two, a torch.profiler table of one RF fit and one GBT fit, and
tables of B1, its bucketing, B2 (both shapes), B5 and B6 calls at phase
3's shapes, to the output and the report.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))

# --- flagship geometry (the repo's bench: train_ffm -ffm_table parts) ---
B, F, K, DIMS = 32768, 40, 4, 1 << 24
MRF = 8192
FK = F * K
OPTS = (f"-dims {DIMS} -factors {K} -fields {F} -mini_batch {B} "
        "-opt adagrad -classification -halffloat -ffm_table parts")
TRAIN_BATCHES, HOLDOUT = 16, 65536
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 peak (NVIDIA data sheet)
F32_OPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
REPLACES = "hivemall_tpu/ops/fm_pallas.py:236"
ACCUM_REPLACES = "hivemall_tpu/ops/fm_pallas.py:301"
# B2 at the per-rank shapes (tag, Fl, Bd) of the 1x1 mesh the main path
# runs and of a dp=2,tp=4 mesh of the same flagship batch
ACCUM_SHAPES = (("dp1_tp1", F, B), ("dp2_tp4", F // 4, B // 2))
CARD_BACKEND = "nccl"            # the one-rank process group on the card
MESH_TOL = 1e-3                  # mesh vs single-device held-out metrics

# --- tree bench width (the repo's: bench.py:1396-1405, :1437) ---
TREE_N, TREE_D, TREE_BINS, TREE_HOLDOUT = 1_000_000, 28, 64, 100_000
RF_OPTS = "-trees 16 -depth 8 -bins 64 -seed 31 -bootstrap poisson"
GBT_OPTS = "-num_round 8 -max_depth 6 -seed 41"
RF_TREES, RF_DEPTH, GBT_ROUNDS, GBT_DEPTH = 16, 8, 8, 6
F32_EPS = 2.0 ** -23
# B4-B6 against a float64 sum: |err| <= TOL_EPS * eps * sum|w| per cell.
# A cell sums up to 1M terms in two stages (a block-private shared-memory
# sum, then the blocks' flush by atomics), both in an order that changes
# from run to run; the rounding errors of such a sum are of random sign
# and grow like sqrt(terms) * eps/2, far below the worst case
# (terms - 1) * eps/2. 64 leaves room above what the card shows.
TOL_EPS = 64
SRC_HIST = "hivemall_tpu_torch/kernels/tree_hist.cu"
HIST_REPLACES = {  # kernel -> the TPU kernel it replaces
    "hist_dense_int": "hivemall_tpu/ops/pallas_hist.py:344",
    "hist_dense_f32": "hivemall_tpu/ops/pallas_hist.py:384",
    "hist_flat": "hivemall_tpu/ops/pallas_hist.py:69",
    "hist_sorted": "hivemall_tpu/ops/pallas_hist.py:179",
}


def _fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        _fail(msg)


if not torch.cuda.is_available():
    _fail("torch.cuda.is_available() is false: this smoke needs a CUDA "
          "card", code=2)

sys.path.insert(0, HERE)
from hivemall_tpu_torch.catalog import lookup  # noqa: E402
from hivemall_tpu_torch.convert import ffm_parts_state_from_jax  # noqa: E402
from hivemall_tpu_torch.io.sparse import SparseDataset  # noqa: E402
from hivemall_tpu_torch.kernels.build import load_kernels  # noqa: E402
from hivemall_tpu_torch.models.trees import StagedMatrix  # noqa: E402
from hivemall_tpu_torch.ops import hist as H  # noqa: E402
from hivemall_tpu_torch.ops.fm_parts import (  # noqa: E402
    parts_lane_patterns, parts_row_hash)
from hivemall_tpu_torch.ops.fm_parts import (  # noqa: E402
    make_parts_step_sharded, parts_geometry)
from hivemall_tpu_torch.ops.losses import get_loss  # noqa: E402
from hivemall_tpu_torch.ops.parts_scatter import (  # noqa: E402
    _accumulate_reference, _adagrad_tail_reference, parts_adagrad_tail,
    parts_row_bucket, parts_row_bucket_reference, parts_scatter_accum,
    parts_scatter_adagrad, parts_scatter_adagrad_reference)
from hivemall_tpu_torch.ops.schedules import make_eta  # noqa: E402
from hivemall_tpu_torch.parallel.mesh import (  # noqa: E402
    init_distributed, make_mesh)

DEV = torch.device("cuda", 0)
REPORT: dict = {}
HIST_WRAPPERS = {"hist_dense_int": H.hist_dense_int,
                 "hist_dense_f32": H.hist_dense_f32,
                 "hist_flat": H.level_histogram,
                 "hist_sorted": H.level_histogram_sorted}


def _say(phase: str, **kv) -> None:
    REPORT.setdefault(phase, {}).update(kv)
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def _time_ms(fn, n: int = 20, warm: int = 3) -> float:
    """Median of ``n`` CUDA-event-timed calls after ``warm`` warm-ups."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


# --- phase 1: card identity ---------------------------------------------
def phase_identity() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    _check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say("identity", nvidia_smi=repr(line), torch=torch.__version__,
         cuda=torch.version.cuda, device=repr(torch.cuda.get_device_name(0)),
         count=torch.cuda.device_count())
    return line


# --- phase 2: build -------------------------------------------------------
def phase_build() -> None:
    t0 = time.perf_counter()
    names = ["parts_scatter_adagrad", "tree_hist"]
    load_kernels(names)
    _say("build", sources=names, seconds=round(time.perf_counter() - t0, 3))


FFM_WRAPPERS = {"parts_scatter_adagrad": parts_scatter_adagrad,
                "parts_scatter_accum": parts_scatter_accum,
                "parts_adagrad_tail": parts_adagrad_tail,
                "parts_row_bucket": parts_row_bucket}


# node_bucket: B6's bucketing, launched by level_histogram_sorted
ALL_WRAPPERS = {**HIST_WRAPPERS, "node_bucket": H.node_bucket,
                **FFM_WRAPPERS}


def _zero_counts() -> None:
    for fn in ALL_WRAPPERS.values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in ALL_WRAPPERS.items()}


@contextlib.contextmanager
def _one_rank_group(backend: str):
    """A one-rank process group from init_distributed(), ended after."""
    init_distributed(backend)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --- phase 3: kernel against its plain version ----------------------------
def _scatter_operands(rng, lam_on: bool):
    """Flagship-geometry operands: Zipf-skewed feature ids hashed into
    their field partitions (duplicate rows, so the atomics collide),
    random bf16 gradients with the count lane set as the step sets it."""
    n = B                                             # m = 1
    ids = (rng.zipf(1.2, (F, n)) % (DIMS - 1) + 1).astype(np.int32)
    field = np.arange(F, dtype=np.int64)[:, None]
    local = (parts_row_hash(torch.from_numpy(ids), torch.from_numpy(field),
                            MRF) - torch.from_numpy(field) * MRF)
    rows = local.to(torch.int32).to(DEV)
    g = rng.normal(0.0, 1e-2, (F, n, 2, 128)).astype(np.float32)
    g[:, :, 1, FK - 128 + 1:] = 0.0                   # pad lanes
    if lam_on:
        g[:, :, 1, FK + 2 - 128] = 1.0                # count lane: presence
    gpack = torch.from_numpy(g).to(DEV).to(torch.bfloat16)
    tl = np.zeros((F * MRF, 256), np.float32)
    tl[:, :FK + 1] = rng.normal(0.0, 0.1, (F * MRF, FK + 1))
    T2 = torch.from_numpy(tl).to(DEV).to(torch.bfloat16).view(-1, 128)
    S2 = torch.from_numpy(
        rng.uniform(0.0, 1e-3, (F * MRF * 2, 128)).astype(np.float32)).to(DEV)
    return rows, gpack, T2, S2


def _bucket_vs_plain(rows: torch.Tensor, Fl: int) -> dict:
    """parts_row_bucket against its plain version (bit for bit), timed
    beside its bound (rows in; order and offsets out) and one stable
    ``torch.sort`` of the same keys (the order alone)."""
    order, offsets = parts_row_bucket(rows, MRF)
    want = parts_row_bucket_reference(rows, MRF)
    torch.cuda.synchronize()
    _check(torch.equal(order, want[0]) and torch.equal(offsets, want[1]),
           f"parts_row_bucket differs from its plain version (Fl={Fl})")
    key = (rows.long() + torch.arange(Fl, device=DEV)[:, None]
           * MRF).reshape(-1)
    t = _time_kernel(lambda: parts_row_bucket(rows, MRF),
                     lambda: parts_row_bucket_reference(rows, MRF),
                     lambda: torch.sort(key, stable=True),
                     _nbytes(rows, order, offsets), rows.numel())
    return dict(t, max_abs_err=0.0, equal_to_plain=True)


def phase_kernel_vs_plain(profile: bool = False) -> dict:
    """B1 at the flagship geometry against its plain version (S2 within
    1e-4, T2 within one bf16 ulp on 1e-3 of cells, rows with no slot
    untouched), run to run bit for bit, and bit for bit equal to
    parts_adagrad_tail(parts_scatter_accum(...)); timed beside its bound,
    the plain version and the accumulate alone as ``index_add_`` (no
    zeroing, no tail: no single PyTorch call does B1's work); its peak
    memory over one call; and the bucketing against its plain version."""
    rng = np.random.default_rng(1234)
    out = {}
    for lam_on in (False, True):
        rows, gpack, T2, S2 = _scatter_operands(rng, lam_on)
        lam8, live8 = parts_lane_patterns(F, K, 0.01, 0.01, DEV)
        eta = 0.1
        kw = dict(F=F, MRF=MRF, FK=FK, lam_on=lam_on)
        Tk, Sk = T2.clone(), S2.clone()
        parts_scatter_adagrad(rows, gpack, Tk, Sk, eta, lam8, live8, **kw)
        Tp, Sp = T2.clone(), S2.clone()
        parts_scatter_adagrad_reference(rows, gpack, Tp, Sp, eta, lam8,
                                        live8, **kw)
        torch.cuda.synchronize()
        # S2: the kernel and index_add_ add each row's f32 contributions
        # in different orders. A Zipf-head row takes thousands of
        # random-sign terms, whose reordering error can reach n*eps of
        # the sum of magnitudes; 1e-4 leaves room above the 1e-5 seen on
        # an H100
        s_rel = float(((Sk - Sp).abs() / Sp.abs().clamp_min(1e-30)).max())
        ulps = _bf16_ulps(Tk, Tp)
        t_max_ulp = int(ulps.max())
        t_frac = float((ulps > 0).float().mean())
        max_abs = max(float((Sk - Sp).abs().max()),
                      float((Tk.float() - Tp.float()).abs().max()))
        del Tp, Sp
        touched = torch.zeros(F * MRF, dtype=torch.bool, device=DEV)
        touched[(rows.long() + torch.arange(F, device=DEV)[:, None]
                 * MRF).reshape(-1)] = True
        cold = ~touched.repeat_interleave(2)
        cold_same = bool(torch.equal(Tk[cold], T2[cold])
                         and torch.equal(Sk[cold], S2[cold]))
        _check(s_rel <= 1e-4, f"S2 rel err {s_rel} > 1e-4 (lam_on={lam_on})")
        _check(t_max_ulp <= 1 and t_frac <= 1e-3,
               f"T2 off by {t_max_ulp} ulp on {t_frac:.2e} of cells")
        _check(cold_same, "rows with no gradient changed")
        # one sum order: the same on a second run, and B1 = tail(B2)
        Tr, Sr = T2.clone(), S2.clone()
        parts_scatter_adagrad(rows, gpack, Tr, Sr, eta, lam8, live8, **kw)
        torch.cuda.synchronize()
        rerun_same = bool(torch.equal(Tk, Tr) and torch.equal(Sk, Sr))
        _check(rerun_same, f"B1 differs between two runs (lam_on={lam_on})")
        Tr.copy_(T2)
        Sr.copy_(S2)
        parts_adagrad_tail(parts_scatter_accum(rows, gpack, F=F, MRF=MRF),
                           Tr, Sr, eta, lam8, live8, FK=FK, lam_on=lam_on)
        torch.cuda.synchronize()
        split_same = bool(torch.equal(Tk, Tr) and torch.equal(Sk, Sr))
        _check(split_same, "B1 differs from parts_adagrad_tail(B2) "
                           f"(lam_on={lam_on})")
        del Tr, Sr
        tag = "l2" if lam_on else "no_l2"
        _say(f"kernel_{tag}", s2_max_rel_err=s_rel, t2_max_ulp=t_max_ulp,
             t2_ulp_frac=t_frac, max_abs_err=max_abs,
             untouched_rows_bit_identical=cold_same,
             rerun_bit_equal=rerun_same, equal_to_tail_of_accum=split_same,
             distinct_rows=int(touched.sum()), slots=F * B)
        out[tag] = dict(max_abs_err=max_abs)
        if not lam_on:
            continue
        # timing at the main path's shapes (with L2: the trainer's default)
        ms = _time_ms(lambda: parts_scatter_adagrad(
            rows, gpack, Tk, Sk, eta, lam8, live8, **kw))
        Tp, Sp = T2.clone(), S2.clone()
        plain_ms = _time_ms(lambda: parts_scatter_adagrad_reference(
            rows, gpack, Tp, Sp, eta, lam8, live8, **kw))
        del Tp, Sp
        glob = (rows.long() + torch.arange(F, device=DEV)[:, None]
                * MRF).reshape(-1)
        g32 = gpack.float().view(-1, 256)
        G = torch.zeros((F * MRF, 256), dtype=torch.float32, device=DEV)
        accum_only_ms = _time_ms(lambda: G.index_add_(0, glob, g32))
        del G, g32
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        parts_scatter_adagrad(rows, gpack, Tk, Sk, eta, lam8, live8, **kw)
        torch.cuda.synchronize()
        peak_mib = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
        # bound: each input read once, each output written once. A row
        # with no gradient comes out unchanged, so the function needs to
        # read and write T2/S2 only on the distinct rows this data touches
        cells = int(touched.sum()) * 2 * 128
        nbytes = (rows.numel() * 4 + gpack.numel() * 2
                  + 2 * cells * (2 + 4)
                  + lam8.numel() * 4 + live8.numel() * 4)
        nops = gpack.numel() + 10 * cells
        bound_ms, bound_by = _bound(nbytes, nops)
        _say("kernel_time", ms=ms, plain_ms=plain_ms, library_ms=None,
             accumulate_only_index_add_ms=accum_only_ms, bound_ms=bound_ms,
             bytes=nbytes, ops=nops, bound_by=bound_by,
             call_peak_mib=peak_mib)
        out.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by)
        b = out["bucket"] = _bucket_vs_plain(rows, F)
        _say("row_bucket", sort_ms=b["ms"],
             **{k_: v for k_, v in b.items() if k_ != "ms"})
        if profile:
            _profile_call("parts_scatter_adagrad", lambda: (
                parts_scatter_adagrad(rows, gpack, Tk, Sk, eta, lam8, live8,
                                      **kw)))
            _profile_call("parts_row_bucket",
                          lambda: parts_row_bucket(rows, MRF))
    return out


# --- phase 3 (mesh): B2 and the tail entry against their plain versions ----
def _accum_operands(Fl: int, n: int, exact: bool, seed: int):
    """Zipf-skewed feature ids hashed into Fl field partitions (rows
    collide, so the atomics do), one slot gradient row each: on a 1/256
    grid (every float32 sum exact in any order) or N(0, 0.01); pad lanes
    zero and the count lane set to 1, as the step sets them."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.2, (Fl, n)) % (DIMS - 1) + 1).astype(np.int32)
    field = torch.arange(Fl, dtype=torch.int64)[:, None]
    rows = (parts_row_hash(torch.from_numpy(ids), field, MRF)
            - field * MRF).to(torch.int32).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (Fl, n, 2, 128)
    if exact:
        g = torch.randint(-64, 65, shape, generator=gen, device=DEV) / 256.0
    else:
        g = torch.randn(shape, generator=gen, device=DEV) * 1e-2
    g[:, :, 1, FK - 128 + 1:] = 0.0
    g[:, :, 1, FK + 2 - 128] = 1.0
    return rows, g.to(torch.bfloat16)


def phase_accum_vs_plain(profile: bool = False) -> dict:
    """B2 (parts_scatter_accum) at the two per-rank shapes: bit-equal to
    its plain version on exactly summable gradients, and within TOL_EPS
    eps x sum|g| of a float64 sum per cell on N(0, 0.01) ones, the same
    bit for bit on a second run; timed
    beside its bound (gradient and rows in, the whole G written),
    ``index_add_`` into a zeroed G and the plain version. Then the tail
    entry (parts_adagrad_tail) at the first shape, bit-equal to its plain
    version on the exact G (both rounded without fused multiply-adds)."""
    out = {}
    for tag, Fl, n in ACCUM_SHAPES:
        rows, g = _accum_operands(Fl, n, True, 31 + Fl)
        got = parts_scatter_accum(rows, g, F=Fl, MRF=MRF)
        want = _accumulate_reference(rows, g, Fl, MRF)
        torch.cuda.synchronize()
        _check(torch.equal(got, want),
               f"B2 differs from its plain version on exact sums ({tag})")
        glob = (rows.long() + torch.arange(Fl, device=DEV)[:, None]
                * MRF).reshape(-1)
        gr = _accum_operands(Fl, n, False, 77 + Fl)[1]
        got_r = parts_scatter_accum(rows, gr, F=Fl, MRF=MRF)
        rerun_same = torch.equal(got_r,
                                 parts_scatter_accum(rows, gr, F=Fl, MRF=MRF))
        _check(rerun_same, f"B2 differs between two runs ({tag})")
        g64 = gr.double().view(-1, 256)
        want64 = torch.zeros((Fl * MRF, 256), dtype=torch.float64,
                             device=DEV).index_add_(0, glob, g64)
        mag = torch.zeros_like(want64).index_add_(0, glob, g64.abs())
        err = (got_r.double() - want64).abs()
        del g64
        _check(bool((err <= TOL_EPS * F32_EPS * mag).all()),
               f"B2 off a float64 sum by more than {TOL_EPS} eps x sum|g| "
               f"({tag})")
        ratio = float((err / (F32_EPS * mag).clamp_min(1e-300)).max())
        max_abs = float(err.max())
        del want64, mag, err, got_r, gr
        g32 = g.float().view(-1, 256)
        Gz = torch.empty((Fl * MRF, 256), dtype=torch.float32, device=DEV)

        def library():
            Gz.zero_()
            Gz.index_add_(0, glob, g32)

        nbytes = _nbytes(g, rows) + Fl * MRF * 256 * 4
        t = _time_kernel(lambda: parts_scatter_accum(rows, g, F=Fl, MRF=MRF),
                         lambda: _accumulate_reference(rows, g, Fl, MRF),
                         library, nbytes, g.numel())
        _say(f"accum_{tag}", Fl=Fl, Bd=n, exact_equal=True,
             rerun_bit_equal=rerun_same, err_over_eps_sum_abs=ratio,
             max_abs_err=max_abs, **t)
        if profile:
            _profile_call(f"parts_scatter_accum_{tag}",
                          lambda: parts_scatter_accum(rows, g, F=Fl, MRF=MRF))
        out[tag] = dict(t, max_abs_err=max_abs)
        if tag == "dp1_tp1":
            out["tail"] = _tail_vs_plain(want, rows, Fl)
        del got, want, g32, Gz, g
        torch.cuda.empty_cache()
    return out


def _tail_vs_plain(G: torch.Tensor, rows: torch.Tensor, Fl: int) -> dict:
    rng = np.random.default_rng(5)
    tl = np.zeros((Fl * MRF, 256), np.float32)
    tl[:, :FK + 1] = rng.normal(0.0, 0.1, (Fl * MRF, FK + 1))
    T2 = torch.from_numpy(tl).to(DEV).to(torch.bfloat16).view(-1, 128)
    S2 = torch.from_numpy(rng.uniform(0.0, 1e-3, (Fl * MRF * 2, 128)).astype(
        np.float32)).to(DEV)
    lam8, live8 = parts_lane_patterns(F, K, 0.01, 0.01, DEV)
    for lam_on in (False, True):
        kw = dict(FK=FK, lam_on=lam_on)
        Tk, Sk = T2.clone(), S2.clone()
        parts_adagrad_tail(G, Tk, Sk, 0.1, lam8, live8, **kw)
        Tp, Sp = T2.clone(), S2.clone()
        _adagrad_tail_reference(G, Tp, Sp, 0.1, lam8, live8, **kw)
        torch.cuda.synchronize()
        _check(torch.equal(Tk, Tp) and torch.equal(Sk, Sp),
               f"tail entry differs from its plain version (lam_on="
               f"{lam_on})")
    touched = torch.zeros(Fl * MRF, dtype=torch.bool, device=DEV)
    touched[(rows.long() + torch.arange(Fl, device=DEV)[:, None]
             * MRF).reshape(-1)] = True
    cells = int(touched.sum()) * 2 * 128
    # G read whole; T2/S2 read and written on the rows this G touches
    nbytes = _nbytes(G, lam8, live8) + 2 * cells * (2 + 4)
    ms = _time_ms(lambda: parts_adagrad_tail(G, Tk, Sk, 0.1, lam8, live8,
                                             FK=FK, lam_on=True))
    plain_ms = _time_ms(lambda: _adagrad_tail_reference(
        G, Tp, Sp, 0.1, lam8, live8, FK=FK, lam_on=True), n=5, warm=1)
    bound_ms, bound_by = _bound(nbytes, 10 * cells)
    t = dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
             bound_by=bound_by, bytes=nbytes, equal_to_plain=True)
    _say("tail_dp1_tp1", **t)
    return t


# --- phase 3 (trees): the level-histogram kernels against their plain ------
def _higgs_like(rng, n: int):
    """HIGGS-shaped rows (bench.py:1437-1440): 28 N(0,1) features, label
    = the sum of the first four + 0.5 * noise > 0."""
    X = rng.normal(0.0, 1.0, (n, TREE_D)).astype(np.float32)
    y = (X[:, :4].sum(1) + 0.5 * rng.normal(0.0, 1.0, n) > 0).astype(np.int32)
    return X, y


def _bound(nbytes: float, nops: float):
    """(bound ms, what bounds it) at the H100's HBM and float32 rates."""
    b = nbytes / HBM_BYTES_PER_S * 1e3
    o = nops / F32_OPS_PER_S * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _hist_bytes(n: int, d: int, loc, ws, M: int) -> int:
    """Bytes a level histogram must move: the n x d bin codes at one byte
    each (64 bins; the uint8 codes StagedMatrix keeps on the card), the
    node ids and channels of every tree, and the [E, M, d, B, S] float32
    output over the real d. The kernels read a wider layout (int32, padded
    features and rows), which the bound does not excuse."""
    E = loc.shape[0] if loc.dim() == 2 else 1
    return (n * d + _nbytes(loc, ws)
            + E * M * d * TREE_BINS * ws.shape[-1] * 4)


def _within_tol(got, ref_fn, ws) -> tuple:
    """(max |got - float64 sum|, max err / (eps * sum|w|)); fails past
    TOL_EPS."""
    want = ref_fn(ws, torch.float64)
    mag = ref_fn(ws.abs(), torch.float64)
    err = (got.double() - want).abs()
    _check(bool((err <= TOL_EPS * F32_EPS * mag).all()),
           f"f32 histogram off its float64 sum by more than {TOL_EPS} eps "
           "x sum|w|")
    ratio = float((err / (F32_EPS * mag).clamp_min(1e-300)).max())
    return float(err.max()), ratio


def _library_dense(bt, loc, ws, M: int, d: int):
    """One index_add_ over the flat (((tree*M + node)*dp + f)*B + bin)
    index of every active (tree, row, feature): the library call beside
    the dense kernels. Returns the timed callable."""
    dp = bt.shape[0]
    e_i, r_i = torch.nonzero((loc >= 0) & (loc < M), as_tuple=True)
    base = (e_i * M + loc[e_i, r_i].long()) * dp
    fb = bt[:d].t()[r_i].long()                       # [K, d] bin codes
    idx = ((base[:, None] + torch.arange(d, device=DEV)[None, :])
           * TREE_BINS + fb).reshape(-1)
    vals = ws[e_i, r_i].repeat_interleave(d, 0)
    out = torch.zeros((loc.shape[0] * M * dp * TREE_BINS, ws.shape[-1]),
                      dtype=torch.float32, device=DEV)
    return lambda: out.index_add_(0, idx, vals)


def _library_rows(bins, loc, ws, M: int):
    n, d = bins.shape
    r_i = torch.nonzero((loc >= 0) & (loc < M), as_tuple=True)[0]
    idx = ((loc[r_i].long()[:, None] * d
            + torch.arange(d, device=DEV)[None, :]) * TREE_BINS
           + bins[r_i].long()).reshape(-1)
    vals = ws[r_i].repeat_interleave(d, 0)
    out = torch.zeros((M * d * TREE_BINS, ws.shape[1]), dtype=torch.float32,
                      device=DEV)
    return lambda: out.index_add_(0, idx, vals)


def _time_kernel(fn, plain, lib, nbytes, nops) -> dict:
    ms = _time_ms(fn)
    plain_ms = _time_ms(plain, n=5, warm=1)
    library_ms = _time_ms(lib)
    bound_ms, bound_by = _bound(nbytes, nops)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=nops)


def _node_bucket_vs_plain(loc: torch.Tensor, M: int, ms: float) -> dict:
    """node_bucket (B6's counting sort; its order inside a node is unset):
    offsets equal to the plain version's, order sorted by node; beside its
    bound (loc in, order and offsets out), the plain version and one stable
    ``torch.sort`` of the keys (the order alone)."""
    order, offsets = H.node_bucket(loc, M)
    want = H.node_bucket_reference(loc, M)
    key = H._node_keys(loc, M)
    torch.cuda.synchronize()
    _check(torch.equal(offsets, want[1])
           and bool((torch.diff(key[order.long()]) >= 0).all()),
           f"node_bucket differs from its plain version at M={M}")
    bound_ms, bound_by = _bound(_nbytes(loc, order, offsets), loc.numel())
    return dict(ms=ms, plain_ms=_time_ms(
        lambda: H.node_bucket_reference(loc, M), n=5, warm=1),
        library_ms=_time_ms(lambda: torch.sort(key, stable=True)),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0)


def phase_tree_kernels_vs_plain(bins: torch.Tensor, y: np.ndarray,
                                profile: bool = False) -> dict:
    """Every histogram kernel at the tree main paths' shapes: 1M rows,
    28 features (32 padded), 64 bins; B3 with the forest's 16 trees of
    class-count channels (S=2), B4 with the booster's (g, h, 1) channels
    (S=3), B5 and B6 with one tree's; each at level 0 and at the deepest
    level of its trainer (M=256 for the forest, 64 for the booster)."""
    rng = np.random.default_rng(99)
    n, d = bins.shape
    M_RF, M_GBT = 2 ** RF_DEPTH, 2 ** GBT_DEPTH
    bt = H.transpose_bins(bins)
    bins32 = bins.to(torch.int32)
    yt = torch.from_numpy(y).to(DEV).long()
    onehot = torch.nn.functional.one_hot(yt, 2).float()
    counts = torch.from_numpy(rng.poisson(1.0, (RF_TREES, n)).astype(
        np.float32)).to(DEV)
    ws_rf = (onehot[None] * counts[..., None]).contiguous()      # [16, n, 2]
    p = torch.sigmoid(torch.from_numpy(rng.normal(0, 1, n).astype(
        np.float32)).to(DEV))
    ws_gbt = torch.stack([p - yt.float(), p * (1 - p), torch.ones_like(p)],
                         -1)[None].contiguous()                  # [1, n, 3]

    def level_loc(E: int, M: int) -> torch.Tensor:
        if M == 1:
            return torch.zeros((E, n), dtype=torch.int32, device=DEV)
        loc = rng.integers(0, M, (E, n)).astype(np.int32)
        loc[rng.random((E, n)) < 0.05] = -1        # rows of settled leaves
        return torch.from_numpy(loc).to(DEV)

    out = {}
    # B3: bit-exact; B4: against a float64 sum. The kernels line carries
    # the main path's deepest level (main_M); B4 at M=256 (the forest
    # regressor's deepest level) goes to the report only
    for name, ws, Ms, main_M in (
            ("hist_dense_int", ws_rf, (1, M_RF), M_RF),
            ("hist_dense_f32", ws_gbt, (1, M_GBT, M_RF), M_GBT)):
        wrapper = HIST_WRAPPERS[name]
        fast = name == "hist_dense_int"
        errs, ratios = [], []
        for M in Ms:
            loc = level_loc(ws.shape[0], M)
            got = wrapper(bt, loc, ws, M, TREE_BINS)
            if fast:
                want = H.level_histogram_dense_reference(bt, loc, ws, M,
                                                         TREE_BINS, fast=True)
                torch.cuda.synchronize()
                _check(torch.equal(got, want),
                       f"hist_dense_int differs from its plain version at "
                       f"M={M}")
                errs.append(float((got - want).abs().max()))
            else:
                e, r = _within_tol(got, lambda w, dt: H.
                                   level_histogram_dense_reference(
                                       bt, loc, w, M, TREE_BINS, dt), ws)
                errs.append(e)
                ratios.append(r)
            S = ws.shape[2]
            active = int(((loc >= 0) & (loc < M)).sum())
            t = _time_kernel(
                lambda: wrapper(bt, loc, ws, M, TREE_BINS),
                lambda: H.level_histogram_dense_reference(bt, loc, ws, M,
                                                          TREE_BINS,
                                                          fast=fast),
                _library_dense(bt, loc, ws, M, d),
                _hist_bytes(n, d, loc, ws, M), active * d * S)
            _say(f"{name}_M{M}", max_abs_err=errs[-1],
                 err_over_eps_sum_abs=ratios[-1] if ratios else 0.0, **t)
            if M == main_M:
                out[name] = t
            torch.cuda.empty_cache()
        out[name]["max_abs_err"] = max(errs)
    # B5 / B6: one tree's integer channels (exact sums: bit-equal to the
    # plain version), then 11 float channels against a float64 sum; each
    # with int32 codes (the times of the kernels line) and the
    # staged uint8 codes as they are
    for name in ("hist_flat", "hist_sorted"):
        wrapper = HIST_WRAPPERS[name]
        ref = (H.level_histogram_reference if name == "hist_flat"
               else H.level_histogram_sorted_reference)
        errs = []
        for M in (1, M_RF):
            loc = level_loc(1, M)[0]
            ws = ws_rf[0]
            want = ref(bins32, loc, ws, M, TREE_BINS)
            ws11 = torch.from_numpy(rng.normal(0, 1, (n, 11)).astype(
                np.float32)).to(DEV)
            ratios = []
            for codes in (bins32, bins):
                got = wrapper(codes, loc, ws, M, TREE_BINS)
                torch.cuda.synchronize()
                _check(torch.equal(got, want),
                       f"{name} differs from its plain version at M={M} "
                       f"({codes.dtype} codes)")
                errs.append(float((got - want).abs().max()))
                e, r = _within_tol(wrapper(codes, loc, ws11, M, TREE_BINS),
                                   lambda w, dt: ref(bins32, loc, w, M,
                                                     TREE_BINS, dt), ws11)
                errs.append(e)
                ratios.append(r)
            active = int(((loc >= 0) & (loc < M)).sum())
            t = _time_kernel(                   # hist_sorted: bucketing in
                lambda: wrapper(bins32, loc, ws, M, TREE_BINS),
                lambda: ref(bins32, loc, ws, M, TREE_BINS),
                _library_rows(bins32, loc, ws, M),
                _hist_bytes(n, d, loc, ws, M), active * d * 2)
            t["ms_uint8"] = _time_ms(lambda: wrapper(bins, loc, ws, M,
                                                     TREE_BINS))
            if name == "hist_sorted":
                t["sort_ms"] = _time_ms(lambda: H.node_bucket(loc, M))
                t["bucket"] = _node_bucket_vs_plain(loc, M, t["sort_ms"])
            _say(f"{name}_M{M}", max_abs_err=max(errs[-4:]),
                 s11_err_over_eps_sum_abs=max(ratios), **t)
            if profile:
                for tag, codes in (("int32", bins32), ("uint8", bins)):
                    _profile_call(f"{name}_M{M}_{tag}",
                                  lambda: wrapper(codes, loc, ws, M,
                                                  TREE_BINS))
            out[name] = t                       # the last: M = 256
            torch.cuda.empty_cache()
        out[name]["max_abs_err"] = max(errs)
    # n_bins = 100: level_histogram_sorted falls back to level_histogram
    b100 = torch.from_numpy(rng.integers(0, 100, (n, d)).astype(
        np.int32)).to(DEV)
    loc = level_loc(1, M_RF)[0]
    s0, f0 = H.level_histogram_sorted.launches, H.level_histogram.launches
    got = H.level_histogram_sorted(b100, loc, ws_rf[0], M_RF, 100)
    _check(H.level_histogram_sorted.launches == s0
           and H.level_histogram.launches == f0 + 1,
           "n_bins=100 did not fall back to level_histogram")
    _check(torch.equal(got, H.level_histogram_reference(
        b100, loc, ws_rf[0], M_RF, 100)), "n_bins=100 fallback differs")
    _say("hist_bins100", fallback="level_histogram", equal=True)
    return out


# --- data -----------------------------------------------------------------
def _criteo_like(rng, n: int, vocab: np.ndarray, effect: np.ndarray):
    """Criteo-shaped rows: one feature per field, Zipf-skewed ranks mapped
    to ids in [1, 2^24); labels drawn from a planted logistic model."""
    nf, V = vocab.shape
    rank = (rng.zipf(1.15, (n, nf)) - 1) % V
    idx = vocab[np.arange(nf)[None, :], rank]
    logit = effect[np.arange(nf)[None, :], rank].sum(1) - 0.5
    lab = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    fld = np.broadcast_to(np.arange(nf, dtype=np.int32), (n, nf))
    return SparseDataset(idx.ravel(), np.arange(n + 1, dtype=np.int64) * nf,
                         np.ones(n * nf, np.float32), lab,
                         np.ascontiguousarray(fld).ravel())


def _planted(rng, nf: int, V: int, dims: int):
    vocab = rng.integers(1, dims, (nf, V)).astype(np.int32)
    effect = np.zeros((nf, V), np.float32)
    effect[:8] = rng.normal(0.0, 0.8, (8, V))         # 8 informative fields
    return vocab, effect


def _logloss_auc(y: np.ndarray, p: np.ndarray):
    p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    ll = float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    order = np.argsort(p, kind="mergesort")
    _, inv, cnt = np.unique(p[order], return_inverse=True, return_counts=True)
    avg = np.cumsum(cnt) - (cnt - 1) / 2.0            # tie-averaged ranks
    r = np.empty(len(p))
    r[order] = avg[inv]
    n1 = float(y.sum())
    n0 = len(y) - n1
    auc = float((r[y == 1].sum() - n1 * (n1 + 1) / 2) / (n1 * n0))
    return ll, auc


# --- phase 4: the trainer on the card against the CPU ---------------------
def phase_small_reference() -> None:
    rng = np.random.default_rng(7)
    b, dims = 2048, 1 << 16
    vocab, effect = _planted(rng, F, 2000, dims)
    ds = _criteo_like(rng, 4 * b, vocab, effect)
    hold = _criteo_like(rng, 1000, vocab, effect)
    opts = OPTS.replace(f"-dims {DIMS}", f"-dims {dims}").replace(
        f"-mini_batch {B}", f"-mini_batch {b}")
    cls = lookup("train_ffm").resolve()
    tc = cls(opts, device="cpu")
    tg = cls(opts)
    _check(tg.device.type == "cuda", "default device is not cuda")
    params = {k: v.float().numpy() for k, v in tc.params.items()}
    opt_state = {k: {"gg": v["gg"].numpy()} for k, v in tc.opt_state.items()}
    tg.params, tg.opt_state = ffm_parts_state_from_jax(params, opt_state, DEV)
    tc._trace_losses, tg._trace_losses = [], []
    tc.fit(ds)
    tg.fit(ds)
    lc, lg = np.asarray(tc._trace_losses), np.asarray(tg._trace_losses)
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    pc, pg = tc.predict(hold), tg.predict(hold)
    dp = float(np.abs(pg - pc).max())
    _say("small_reference", steps=len(lg), loss_max_rel=rel,
         predict_max_abs=dp)
    _check(len(lg) == 4 and rel <= 1e-2,
           f"card vs CPU loss trajectory rel {rel} > 1e-2")
    _check(dp <= 1e-2, f"card vs CPU predictions differ by {dp} > 1e-2")


# --- phase 4 (mesh): one 1x1-mesh step on the card against the CPU --------
def phase_mesh_step_card_vs_cpu() -> None:
    """One sharded parts step (make_parts_step_sharded on a 1x1 mesh) from
    one state on a small input (B=2048, F=40, K=4, dims=2^16), in a
    one-rank gloo group on the CPU and a one-rank NCCL group on the card.
    Loss and w0 within 1e-5 relative; S2 within 1e-4 relative on all but
    1e-4 of the moved cells (a slot gradient's bf16 rounding can come out
    one ulp apart where the float32 sums differ in the last bits, and
    where a cell's slots cancel that ulp is no small part of its G: 9%
    on one cell of an H100 run); T2 within one bf16 ulp on 99% of touched
    cells and 2*eta on all (AdaGrad moves a cell by at most eta)."""
    rng = np.random.default_rng(11)
    b, dims, eta = 2048, 1 << 16, 0.1
    mrf = parts_geometry(dims, F, K)[0]
    idx = rng.integers(1, dims, (b, F)).astype(np.int32)
    lab = (rng.integers(0, 2, b) * 2 - 1).astype(np.float32)
    mask = np.ones(b, np.float32)
    mask[-100:] = 0.0
    tl = np.zeros((F * mrf, 256), np.float32)
    tl[:, :FK + 1] = rng.normal(0.0, 0.1, (F * mrf, FK + 1))
    T0 = torch.from_numpy(tl).to(torch.bfloat16).view(-1, 128)
    S0 = torch.from_numpy(rng.uniform(0.0, 1e-3, tuple(T0.shape)).astype(
        np.float32))
    res = {}
    for where, backend in (("cpu", "gloo"), ("cuda", CARD_BACKEND)):
        with _one_rank_group(backend):
            mesh = make_mesh(1, 1, device=DEV if where == "cuda" else "cpu")
            dev = mesh.device
            step = make_parts_step_sharded(get_loss("logloss"),
                                           make_eta("fixed", eta),
                                           (0.01, 0.01, 0.01), F, K, mrf,
                                           mesh)
            params = {"T2": T0.clone().to(dev),
                      "w0": torch.tensor(0.1, device=dev)}
            opt = {"T2": {"gg": S0.clone().to(dev)},
                   "w0": {"gg": torch.tensor(0.5, device=dev)}}
            before = parts_scatter_accum.launches

            def to(a):
                return torch.from_numpy(a).to(dev)

            p, o, loss = step(params, opt, 0.0, to(idx), None, to(lab),
                              to(mask))
            launched = parts_scatter_accum.launches - before
            _check(launched == (1 if where == "cuda" else 0),
                   f"B2 launched {launched} times in the {where} step")
            res[where] = {k: v.float().cpu() for k, v in (
                ("T2", p["T2"]), ("S2", o["T2"]["gg"]), ("w0", p["w0"]),
                ("loss", loss))}
    c, g = res["cpu"], res["cuda"]
    rel = {k: abs(float(g[k]) - float(c[k])) / max(abs(float(c[k])), 1e-12)
           for k in ("loss", "w0")}
    live = c["S2"] > 1e-12
    rel_s = ((g["S2"] - c["S2"]).abs()[live] / c["S2"][live])
    touched = c["T2"] != T0.float()
    ulps = _bf16_ulps(g["T2"].to(torch.bfloat16), c["T2"].to(torch.bfloat16))
    ulp_share = float((ulps[touched] <= 1).float().mean())
    t_abs = float((g["T2"] - c["T2"]).abs().max())
    _say("mesh_step_card_vs_cpu", loss_rel=rel["loss"], w0_rel=rel["w0"],
         s2_share_within_1e_4=float((rel_s <= 1e-4).float().mean()),
         s2_max_rel=float(rel_s.max()), t2_share_within_1ulp=ulp_share,
         t2_max_abs=t_abs, touched_cells=int(touched.sum()))
    _check(rel["loss"] <= 1e-5 and rel["w0"] <= 1e-5,
           f"mesh step card vs CPU: loss/w0 rel {rel}")
    _check(float((rel_s <= 1e-4).float().mean()) >= 1 - 1e-4
           and bool(torch.isfinite(g["S2"]).all()),
           "mesh step card vs CPU: S2")
    _check(ulp_share >= 0.99 and t_abs <= 2 * eta,
           "mesh step card vs CPU: T2")


# --- phase 5: the main path -----------------------------------------------
def _device_ms_per_step(t, ds, tag: str, k: int = 2) -> float:
    """Device kernel ms a step (torch.profiler) over ``k`` more steps of
    the trainer on the first batches of ``ds``, prepped first; the top
    rows by device time go to the report and the output."""
    it = ds.batches(B, shuffle=False)
    prepped = [t._preprocess_train_batch(next(it)) for _ in range(k)]
    rows, dev_ms = _device_table(lambda: [t._dispatch(b) for b in prepped],
                                 per=k)
    rows = [r for r in rows
            if not r[0].startswith(("aten::", "Activity Buffer"))]
    REPORT[f"device_ms_per_step_{tag}"] = rows[:30]
    for key, c, ms in rows[:8]:
        print(f"[device {tag}] {ms:8.3f} ms/step x{c:<4d} {key[:80]}",
              flush=True)
    return dev_ms


def phase_main_path(profile: bool) -> dict:
    rng = np.random.default_rng(2024)
    vocab, effect = _planted(rng, F, 50_000, DIMS)
    t0 = time.perf_counter()
    train = _criteo_like(rng, TRAIN_BATCHES * B, vocab, effect)
    hold = _criteo_like(rng, HOLDOUT, vocab, effect)
    _say("data", train_rows=len(train), holdout_rows=len(hold),
         seconds=round(time.perf_counter() - t0, 3),
         train_positive_rate=float(train.labels.mean()))

    _zero_counts()                               # counts of this run only
    t = lookup("train_ffm").resolve()(OPTS)
    _check(t.MRF == MRF and t._pack_input_on(), "unexpected geometry")
    marks = []
    dispatch = t._dispatch

    def timed_dispatch(batch):
        dispatch(batch)
        if not marks:                            # after the warm-up step
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    t._dispatch = timed_dispatch
    torch.cuda.reset_peak_memory_stats()
    t.fit(train)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = _counts()
    launches = counts["parts_scatter_adagrad"]
    _check(all(v == 0 for k, v in counts.items()
               if k not in ("parts_scatter_adagrad", "parts_row_bucket")),
           f"train_ffm launched other kernels: {counts}")
    steps = t._t
    eps = (t._examples - B) / (t_end - marks[0])
    train_ll = t.cumulative_loss
    _check(steps == TRAIN_BATCHES, f"{steps} steps, want {TRAIN_BATCHES}")
    _check(launches == steps and counts["parts_row_bucket"] == steps,
           f"kernel launches {counts} != steps {steps}")
    for name, x in (("T2", t.params["T2"]), ("S2", t.opt_state["T2"]["gg"])):
        _check(x.device.type == "cuda", f"{name} on {x.device}")
    _check(np.isfinite(train_ll), "training loss not finite")

    p = t.predict(hold)
    _check(p.shape == (HOLDOUT,) and np.isfinite(p).all(),
           "held-out scores not finite or misshapen")
    ll, auc = _logloss_auc(hold.labels, p)
    peak = torch.cuda.max_memory_allocated() / 2**30
    dev_ms = _device_ms_per_step(t, train, "main_path")
    _say("main_path", steps=steps, launches=launches,
         launches_bucket=counts["parts_row_bucket"], examples_per_sec=eps,
         train_logloss=train_ll, holdout_logloss=ll, holdout_auc=auc,
         peak_mem_gib=peak, device_ms_per_step=dev_ms)
    _check(auc > 0.6, f"held-out AUC {auc} <= 0.6")
    if profile:
        _profile_steps(t, train)
    return dict(launches=launches, bucket=counts["parts_row_bucket"],
                train=train, hold=hold, ll=ll, auc=auc, eps=eps,
                device_ms=dev_ms)


# --- phase 4 (trees): the trainers on the card against the CPU ------------
def phase_tree_small_reference(X, y, Xh) -> None:
    """20k rows, the main paths' options: the forest with exact bootstrap
    and every feature at every node (no random draw) must give the same
    trees bit for bit (integer histograms); the booster's float32 sums run
    in another order on the card, so its trees may part where two splits'
    gains tie to the last bits. The booster's limits, 1e-4 on predictions
    and 98% of splits equal, sit above what the H100 showed in two runs
    (1.8e-7, every split equal) and below what a wrong histogram moves."""
    x, yy = X[:20_000], y[:20_000]
    rf_opts = RF_OPTS.replace("poisson", "exact") + f" -vars {TREE_D}"
    cls = lookup("train_randomforest_classifier").resolve()
    g, c = cls(rf_opts).fit(x, yy), cls(rf_opts, device="cpu").fit(x, yy)
    same = all(np.array_equal(getattr(g.tree, k), getattr(c.tree, k))
               for k in ("feat", "thr", "value"))
    oob_same = g.oob_errors == c.oob_errors
    _check(same and oob_same,
           "forest on the card differs from the forest on the CPU")
    cls = lookup("train_xgboost_classifier").resolve()
    g, c = cls(GBT_OPTS).fit(x, yy), cls(GBT_OPTS, device="cpu").fit(x, yy)
    pg, pc = g.predict(Xh[:20_000]), c.predict(Xh[:20_000])
    dp = float(np.abs(pg - pc).max())
    fg = np.stack([t.feat for t in g.trees])
    fc = np.stack([t.feat for t in c.trees])
    tg = np.stack([t.thr for t in g.trees])
    tc = np.stack([t.thr for t in c.trees])
    split = fc >= 0
    share = float(((fg == fc) & (tg == tc))[split].mean())
    _say("tree_small_reference", rf_trees_equal=same,
         rf_oob_equal=oob_same, gbt_predict_max_abs=dp,
         gbt_equal_split_share=share,
         gbt_value_max_abs=float(np.abs(np.stack([t.value for t in g.trees])
                                        - np.stack([t.value for t in
                                                    c.trees])).max()))
    _check(dp <= 1e-4, f"booster card vs CPU predictions differ by {dp}")
    _check(share >= 0.98,
           f"booster card vs CPU share of equal splits {share}")


# --- phase 5 (trees): the main paths ----------------------------------------
def _device_table(work, per: int = 1) -> tuple:
    """torch.profiler over ``work()``: rows (name, count, device ms / per)
    by descending time, and the sum over kernels. aten:: rows repeat the
    time of the kernels they launched; the profiler's own buffer requests
    are no work of the path."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        work()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((e.key, e.count, dev_us / 1e3 / per))
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(ms for k, _, ms in rows
                    if not k.startswith(("aten::", "Activity Buffer")))
    return rows, device_ms


def phase_tree_main_paths(Xs, y, Xh, yh, profile: bool) -> dict:
    out = {}
    for name, opts, kernel, want in (
            ("train_randomforest_classifier", RF_OPTS, "hist_dense_int",
             RF_DEPTH + 1),
            ("train_xgboost_classifier", GBT_OPTS, "hist_dense_f32",
             GBT_ROUNDS * (GBT_DEPTH + 1))):
        cls = lookup(name).resolve()
        cls(opts).fit(Xs, y)                    # warm-up, the same shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()                          # counts of this run only
        t0 = time.perf_counter()
        m = cls(opts).fit(Xs, y)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        _check(m.device.type == "cuda", f"{name} ran on {m.device}")
        _check(counts[kernel] == want,
               f"{name}: {kernel} launched {counts[kernel]} times, want "
               f"{want}")
        _check(all(v == 0 for k, v in counts.items() if k != kernel),
               f"{name}: other kernels launched: {counts}")
        if name.startswith("train_random"):
            proba = m.predict_proba(Xh)
            _check(proba.shape == (len(yh), 2) and np.isfinite(proba).all(),
                   "forest probabilities not finite or misshapen")
            pred = m.classes_[proba.argmax(-1)]
            extra = dict(oob_error_mean=float(np.mean(m.oob_errors)),
                         oob_error_max=float(np.max(m.oob_errors)))
            _check(all(0.0 <= e <= 0.5 for e in m.oob_errors),
                   f"OOB errors out of range: {m.oob_errors}")
            out["forest"] = m
        else:
            p = m.predict(Xh)
            _check(p.shape == (len(yh),) and np.isfinite(p).all(),
                   "booster scores not finite or misshapen")
            pred = (p > 0.5).astype(np.int32)
            extra = dict(train_rounds=len(m.trees))
        acc = float((pred == yh).mean())
        _say(name, launches=counts[kernel], rows_per_sec=len(y) / sec,
             fit_seconds=sec, holdout_accuracy=acc, peak_mem_gib=peak,
             **extra)
        _check(acc > 0.75, f"{name}: held-out accuracy {acc} <= 0.75")
        out[kernel] = counts[kernel]
        if profile:
            rows, dev_ms = _device_table(lambda: cls(opts).fit(Xs, y))
            REPORT[f"profile_{name}"] = rows[:40]
            print(f"[profile] {name}: device kernels {dev_ms:.3f} ms/fit "
                  f"(wall {sec * 1e3:.1f} ms/fit)", flush=True)
            for k, c, ms in rows[:12]:
                print(f"[profile] {ms:9.3f} ms/fit  x{c:<5d} {k[:90]}",
                      flush=True)
    return out


# --- phase 5 (mesh): the -mesh paths in a one-rank NCCL group ---------------
def phase_mesh_main_paths(base: dict, Xs, y, forest) -> dict:
    """``train_ffm`` with the flagship options and ``-mesh dp=1,tp=1`` on
    the single-device epoch's 16 batches (the same table from -seed), then
    ``predict``; ``train_randomforest_classifier`` with ``-mesh dp=1`` on
    the staged 1M rows. Inside one one-rank NCCL group from
    init_distributed(); counts zeroed before each path and read after."""
    out = {}
    with _one_rank_group(CARD_BACKEND):
        _zero_counts()
        t = lookup("train_ffm").resolve()(OPTS + " -mesh dp=1,tp=1")
        _check(t.mesh is not None and not t._pack_input_on()
               and t.device.type == "cuda", "mesh trainer set-up")
        marks = []
        dispatch = t._dispatch

        def timed_dispatch(batch):
            dispatch(batch)
            if not marks:
                torch.cuda.synchronize()
                marks.append(time.perf_counter())

        t._dispatch = timed_dispatch
        torch.cuda.reset_peak_memory_stats()
        t.fit(base["train"])
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = _counts()
        steps = t._t
        eps = (t._examples - B) / (t_end - marks[0])
        _check(steps == TRAIN_BATCHES, f"mesh: {steps} steps")
        mesh_kernels = ("parts_scatter_accum", "parts_adagrad_tail",
                        "parts_row_bucket")
        _check(all(counts[k] == steps for k in mesh_kernels)
               and all(v == 0 for k, v in counts.items()
                       if k not in mesh_kernels),
               f"mesh train_ffm launches {counts}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        p = t.predict(base["hold"])
        _check(p.shape == (HOLDOUT,) and np.isfinite(p).all(),
               "mesh held-out scores not finite or misshapen")
        ll, auc = _logloss_auc(base["hold"].labels, p)
        t._dispatch = dispatch
        dev_ms = _device_ms_per_step(t, base["train"], "mesh_main_path")
        _say("mesh_main_path", steps=steps,
             launches_accum=counts["parts_scatter_accum"],
             launches_tail=counts["parts_adagrad_tail"],
             launches_fused=counts["parts_scatter_adagrad"],
             launches_bucket=counts["parts_row_bucket"],
             examples_per_sec=eps, holdout_logloss=ll, holdout_auc=auc,
             logloss_diff=ll - base["ll"], auc_diff=auc - base["auc"],
             peak_mem_gib=peak, device_ms_per_step=dev_ms,
             extra_device_ms_per_step=dev_ms - base["device_ms"],
             examples_per_sec_ratio=eps / base["eps"])
        _check(abs(ll - base["ll"]) <= MESH_TOL
               and abs(auc - base["auc"]) <= MESH_TOL,
               f"mesh epoch logloss/AUC {ll}/{auc} vs single device "
               f"{base['ll']}/{base['auc']}")
        out["parts_scatter_accum"] = counts["parts_scatter_accum"]
        out["parts_adagrad_tail"] = counts["parts_adagrad_tail"]
        out["parts_row_bucket_mesh"] = counts["parts_row_bucket"]
        del t

        cls = lookup("train_randomforest_classifier").resolve()
        _zero_counts()
        t0 = time.perf_counter()
        m = cls(RF_OPTS + " -mesh dp=1").fit(Xs, y)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = _counts()
        want = RF_DEPTH + 1
        _check(counts["hist_dense_int"] == want
               and all(v == 0 for k, v in counts.items()
                       if k != "hist_dense_int"),
               f"mesh forest launches {counts}")
        same = (all(np.array_equal(getattr(m.tree, k),
                                   getattr(forest.tree, k))
                    for k in ("feat", "thr", "value"))
                and m.oob_errors == forest.oob_errors)
        _say("mesh_train_randomforest_classifier",
             launches=counts["hist_dense_int"], rows_per_sec=len(y) / sec,
             fit_seconds=sec, forest_equal_to_single_device=same)
        _check(same, "-mesh dp=1 forest differs from the single-device "
                     "forest")
    return out


def _deepest_level(tree, e: int, bins: torch.Tensor, depth: int):
    """Node-local ids of the forest's deepest level for tree e: the rows
    that reach depth ``depth`` (others settled earlier: -1)."""
    feat = torch.from_numpy(tree.feat[e]).to(DEV).long()
    thr = torch.from_numpy(tree.thr[e]).to(DEV).long()
    rows = torch.arange(bins.shape[0], device=DEV)
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=DEV)
    for _ in range(depth):
        f = feat[node]
        right = bins[rows, f.clamp(min=0)].long() > thr[node]
        node = torch.where(f < 0, node, 2 * node + 1 + right.long())
    local = node - (2 ** depth - 1)
    return torch.where(local >= 0, local, -1).to(torch.int32)


def phase_hist_api_path(forest, bins, y) -> dict:
    """level_histogram_sorted and level_histogram, which no trainer calls,
    driven as a caller of the module would: the forest's deepest level
    (tree 0), class-count channels, n_bins 64 and 100 (the fallback) and 11
    channels (two slabs of 8)."""
    M = 2 ** RF_DEPTH
    loc = _deepest_level(forest.tree, 0, bins, RF_DEPTH)
    ws = torch.nn.functional.one_hot(torch.from_numpy(y).to(DEV).long(),
                                     2).float()
    ws11 = torch.cat([ws] * 5 + [ws[:, :1]], dim=1).contiguous()
    _zero_counts()
    h_sorted = H.level_histogram_sorted(bins, loc, ws, M, TREE_BINS)
    h_100 = H.level_histogram_sorted(bins, loc, ws, M, 100)
    h_11 = H.level_histogram(bins, loc, ws11, M, TREE_BINS)
    torch.cuda.synchronize()
    counts = _counts()
    _check(counts["hist_sorted"] == 1 and counts["hist_flat"] == 3
           and counts["node_bucket"] == 1,
           f"histogram API path launched {counts}")
    dense = H.level_histogram_dense(H.transpose_bins(bins), loc, ws, M,
                                    TREE_BINS, fast=True)[:, :TREE_D]
    same = (torch.equal(h_sorted, dense)
            and torch.equal(h_100[:, :, :TREE_BINS], dense)
            and torch.equal(h_11[..., 10:], dense[..., :1])
            and float(h_100[:, :, TREE_BINS:].abs().sum()) == 0.0)
    _check(same, "histogram API results differ from the dense kernel's")
    _say("hist_api_path", active_rows=int((loc >= 0).sum()),
         codes=str(bins.dtype), launches_sorted=counts["hist_sorted"],
         launches_flat=counts["hist_flat"],
         launches_bucket=counts["node_bucket"], equal_to_dense=same)
    return counts


def _profile_call(tag: str, fn, k: int = 5) -> None:
    """torch.profiler over ``k`` calls of ``fn``: device ms a call by kernel
    (the wrapper's launches, copies and memsets apart)."""
    rows, dev_ms = _device_table(lambda: [fn() for _ in range(k)], per=k)
    REPORT[f"profile_{tag}"] = rows[:20]
    print(f"[profile] {tag}: device {dev_ms:.4f} ms/call", flush=True)
    for key, c, ms in rows[:10]:
        print(f"[profile] {ms:9.4f} ms/call  x{c:<4d} {key[:90]}", flush=True)


def _profile_steps(t, ds) -> None:
    """Where a main-path step's time goes: the host stages of four more
    batches timed one by one (synced), then torch.profiler over two more
    steps for device time by kernel."""
    stages = {"batches": [], "prep": [], "h2d": [], "step": []}
    it = ds.batches(B, shuffle=False)
    prepped = []
    for _ in range(4):
        t0 = time.perf_counter()
        b = next(it)
        t1 = time.perf_counter()
        pb = t._preprocess_train_batch(b)
        t2 = time.perf_counter()
        torch.from_numpy(pb.buf).to(DEV)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        t._dispatch(pb)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(v * 1e3)
        prepped.append(pb)
    host = {k: float(np.mean(v)) for k, v in stages.items()}
    REPORT["host_ms_per_batch"] = host
    print("[profile] host ms/batch " + " ".join(
        f"{k}={v:.3f}" for k, v in host.items()), flush=True)
    rows, device_ms = _device_table(
        lambda: [t._dispatch(b) for b in prepped[:2]], per=2)
    REPORT["profile_ms_per_step"] = rows[:40]
    REPORT["device_ms_per_step"] = device_ms
    print(f"[profile] device kernels {device_ms:.3f} ms/step", flush=True)
    for k, c, ms in rows[:12]:
        print(f"[profile] {ms:9.3f} ms/step  x{c:<4d} {k[:90]}", flush=True)


def main() -> None:
    profile = "--profile" in sys.argv[1:]
    smi = phase_identity()
    phase_build()
    k = phase_kernel_vs_plain(profile)
    rng = np.random.default_rng(1437)
    t0 = time.perf_counter()
    X, y = _higgs_like(rng, TREE_N)
    Xh, yh = _higgs_like(rng, TREE_HOLDOUT)
    Xs = StagedMatrix.stage(X, TREE_BINS)
    _say("tree_data", rows=TREE_N, holdout_rows=TREE_HOLDOUT,
         seconds=round(time.perf_counter() - t0, 3),
         positive_rate=float(y.mean()))
    kt = phase_tree_kernels_vs_plain(Xs.bins, y, profile)
    ka = phase_accum_vs_plain(profile)
    phase_small_reference()
    phase_mesh_step_card_vs_cpu()
    phase_tree_small_reference(X, y, Xh)
    base = phase_main_path(profile)
    launches = {"parts_scatter_adagrad": base["launches"]}
    tm = phase_tree_main_paths(Xs, y, Xh, yh, profile)
    api = phase_hist_api_path(tm["forest"], Xs.bins, y)
    launches.update(hist_dense_int=tm["hist_dense_int"],
                    hist_dense_f32=tm["hist_dense_f32"],
                    hist_flat=api["hist_flat"],
                    hist_sorted=api["hist_sorted"],
                    node_bucket=api["node_bucket"],
                    parts_row_bucket=base["bucket"])
    launches.update(phase_mesh_main_paths(base, Xs, y, tm["forest"]))
    src = "hivemall_tpu_torch/kernels/parts_scatter_adagrad.cu"

    def row(name, source, replaces, r, max_abs_err):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_abs_err, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    a = ka["dp1_tp1"]                  # the shape the 1x1 mesh path runs
    kernels = [
        row("parts_scatter_adagrad", src, REPLACES, k,
            max(k["l2"]["max_abs_err"], k["no_l2"]["max_abs_err"])),
        row("parts_row_bucket", src, REPLACES, k["bucket"], 0.0),
        row("parts_scatter_accum", src, ACCUM_REPLACES, a,
            max(v["max_abs_err"] for k_, v in ka.items() if k_ != "tail")),
        row("parts_adagrad_tail", src, ACCUM_REPLACES, ka["tail"], 0.0)]
    for name, replaces in HIST_REPLACES.items():
        kernels.append(row(name, SRC_HIST, replaces, kt[name],
                           kt[name]["max_abs_err"]))
    kernels.append(row("node_bucket", SRC_HIST, HIST_REPLACES["hist_sorted"],
                       kt["hist_sorted"]["bucket"], 0.0))
    REPORT["kernels"] = kernels
    REPORT["nvidia_smi"] = smi
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(REPORT, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
