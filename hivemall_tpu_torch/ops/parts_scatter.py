"""Wrappers of the parts layout's gradient-scatter and AdaGrad kernels.

  parts_row_bucket       a stable bucketing of the slots by table row (the
                         first phase of B1 and B2, counted apart);
  parts_scatter_adagrad  B1, the port of the TPU kernel
                         hivemall_tpu/ops/fm_pallas.py::
                         _make_scatter_opt_kernel: each row's slot sum with
                         AdaGrad applied, fused (the single-device step);
  parts_scatter_accum    B2, the port of _make_scatter_accum_kernel: the
                         row sums alone, returned as G (the sharded step
                         sums it over dp first);
  parts_adagrad_tail     the AdaGrad tail alone on a given G (the sharded
                         step's optimizer), B1's own row update.

All four launch entry points of kernels/parts_scatter_adagrad.cu on CUDA
tensors, or raise; only CPU tensors go to the plain PyTorch versions beside
them (``parts_row_bucket_reference``, ``_accumulate_reference``,
``_adagrad_tail_reference`` and the composition
``parts_scatter_adagrad_reference``), which the CPU tests run and against
which the kernels are held on the card. Each wrapper counts its own
``launches``; B1 and B2 each launch the bucketing once, then their
reduction. The launch plan (``_scatter_plan``) is plain Python, tested on
the CPU.

Operands (n = m*B slots per field partition, HP = 2 half-rows of 128):
  rows   int32 [F, n]            local row of each slot in its partition
  gpack  bf16  [F, n, HP, 128]   each slot's slab gradient (count lane at
                                 column FK+2 when L2 is on)
  T2     bf16  [F*MRF*HP, 128]   table, updated in place
  S2     f32   [F*MRF*HP, 128]   AdaGrad accumulators, updated in place
  eta    float                   this step's learning rate (exact float32)
  lam8, live8  f32 [8, 128]      per-lane L2 strength and live mask of the
                                 (even, odd) half-rows, tiled 4x, as built by
                                 ops.fm_parts.parts_lane_patterns
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .optimizers import EPS

__all__ = ["parts_scatter_adagrad", "parts_scatter_adagrad_reference",
           "parts_scatter_accum", "parts_adagrad_tail", "parts_row_bucket",
           "parts_row_bucket_reference"]

_HP, _LANES = 2, 128
# Launch geometry; _WARPS is kWarps of parts_scatter_adagrad.cu
_WARPS = 8                   # warps a block of the bucketing and reduction
_TILE = 128                  # sorted positions a reducing warp takes
_CHUNK = 4096                # slots a bucketing block takes, at least
_MAX_CHUNK = 16384           # ... at most (its keys staged in shared memory)
_COUNTS_BYTES = 64 << 20     # the per-chunk counters kept below this
_KEYS_SMEM = 48 * 1024       # counters in shared memory up to this
_SMEM_MAX = 227 * 1024       # an H100 block's shared memory
_ZERO_BLOCKS = 1024          # B2's blocks writing the rows with no slot
_TAIL_BLOCKS = 4096          # the tail entry's blocks, at most
_INT_MAX = 2 ** 31 - 1


class _ScatterPlan(NamedTuple):
    chunk: int               # slots of one field a bucketing block takes
    chunks: int              # bucketing blocks a field
    smem_keys: int           # 1: a block's MRF + 1 counters in shared memory
    count_smem: int          # dynamic shared bytes of the count kernel
    scatter_smem: int        # ... of the scatter kernel (counters + keys)
    tile: int                # sorted positions a reducing warp takes
    tiles: int               # ceil(F*n / tile): the reduction's warps
    zero_blocks: int         # B2's blocks for the rows with no slot
    ints: int                # int32 scratch: order, offsets, row keys,
                             # counters, dropped counts, tickets
    floats: int              # f32 scratch: two partial rows a tile


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _scatter_plan(F: int, n: int, MRF: int) -> _ScatterPlan:
    """Geometry of parts_row_bucket and the reduction for F fields of n
    slots into F*MRF rows, from the shapes alone (no data). Chunks of at
    least _CHUNK slots, doubled (to _MAX_CHUNK) while the per-chunk
    counters [F*chunks, MRF + 1] would pass _COUNTS_BYTES; the counters go
    to shared memory when MRF + 1 of them fit _KEYS_SMEM."""
    if F < 1 or n < 0 or MRF < 1:
        raise ValueError(f"parts scatter plan: F={F}, n={n}, MRF={MRF}")
    if F * n + _TILE > _INT_MAX or F * MRF + 1 > _INT_MAX:
        raise ValueError(f"parts scatter plan: {F}x{n} slots or {F}x{MRF} "
                         "rows exceed the kernels' int32 positions")
    chunk = _CHUNK
    while (chunk < _MAX_CHUNK and chunk < n
           and 4 * F * _cdiv(n, chunk) * (MRF + 1) > _COUNTS_BYTES):
        chunk *= 2
    chunks = max(1, _cdiv(n, chunk))
    chunk = max(1, min(chunk, _cdiv(n, chunks)))        # even chunks
    smem_keys = int(4 * (MRF + 1) <= _KEYS_SMEM)
    count_smem = 4 * (MRF + 1) * smem_keys
    scatter_smem = count_smem + 4 * chunk
    if scatter_smem > _SMEM_MAX:
        raise ValueError("parts scatter plan: a chunk's keys do not fit "
                         "shared memory")
    tiles = _cdiv(F * n, _TILE)
    rows = F * MRF
    ints = 2 * F * n + rows + 1 + F * chunks * (MRF + 2) + tiles
    zero_blocks = min(_ZERO_BLOCKS, _cdiv(rows, 32 * _WARPS))
    return _ScatterPlan(chunk, chunks, smem_keys, count_smem, scatter_smem,
                        _TILE, tiles, zero_blocks, ints,
                        2 * tiles * _HP * _LANES)


def _check_operands(fn: str, dev, named):
    for name, t, dt in named:
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, the operands "
                             f"on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_fk(fn: str, FK: int):
    if not 128 <= FK <= 248:
        raise ValueError(f"{fn}: F*K={FK} outside the Wp=256 envelope "
                         "[128, 248]")


def _check_slots(fn: str, rows, gpack, F: int) -> int:
    if rows.dim() != 2 or rows.shape[0] != F:
        raise ValueError(f"{fn}: rows must be [F={F}, n], got "
                         f"{tuple(rows.shape)}")
    n = rows.shape[1]
    if tuple(gpack.shape) != (F, n, _HP, _LANES):
        raise ValueError(f"{fn}: gpack must be {(F, n, _HP, _LANES)}, got "
                         f"{tuple(gpack.shape)}")
    return n


def _check_table(fn: str, T2, S2, lam8, live8, table_rows: int):
    table = (table_rows * _HP, _LANES)
    for name, t in (("T2", T2), ("S2", S2)):
        if tuple(t.shape) != table:
            raise ValueError(f"{fn}: {name} must be {table}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("lam8", lam8), ("live8", live8)):
        if tuple(t.shape) != (8, _LANES):
            raise ValueError(f"{fn}: {name} must be (8, 128), got "
                             f"{tuple(t.shape)}")


def _check(rows, gpack, T2, S2, lam8, live8, F: int, MRF: int, FK: int):
    fn = "parts_scatter_adagrad"
    _check_operands(fn, T2.device, (("rows", rows, torch.int32),
                                    ("gpack", gpack, torch.bfloat16),
                                    ("T2", T2, torch.bfloat16),
                                    ("S2", S2, torch.float32),
                                    ("lam8", lam8, torch.float32),
                                    ("live8", live8, torch.float32)))
    _check_fk(fn, FK)
    n = _check_slots(fn, rows, gpack, F)
    _check_table(fn, T2, S2, lam8, live8, F * MRF)
    return n


def _accumulate_reference(rows: torch.Tensor, gpack: torch.Tensor, F: int,
                          MRF: int) -> torch.Tensor:
    """The accumulate phase alone, plain PyTorch: f32 G [F*MRF, HP*128]
    with every slot's widened gradient row added at field*MRF + local row."""
    n = rows.shape[1]
    base = torch.arange(F, device=rows.device, dtype=torch.int64)[:, None]
    glob = (rows.to(torch.int64) + base * MRF).reshape(-1)
    G = torch.zeros((F * MRF, _HP * _LANES), dtype=torch.float32,
                    device=gpack.device)
    G.index_add_(0, glob, gpack.reshape(F * n, _HP * _LANES).float())
    return G


def _adagrad_tail_reference(G, T2, S2, eta, lam8, live8, *, FK: int,
                            lam_on: bool):
    """The AdaGrad tail alone, plain PyTorch, in place on T2 and S2: per
    cell Geff = (G + lam*T*cnt)*live with L2 (cnt = the row's count lane,
    column FK+2), else G; S' = S + Geff^2; T' = bf16(T - eta*Geff /
    (sqrt(S') + 1e-6)). Returns (T2, S2)."""
    G8 = G.view(-1, 8, _LANES)
    S8 = S2.view(-1, 8, _LANES)
    w = T2.view(-1, 8, _LANES).float()
    if lam_on:
        cnt = G[:, FK + 2]                      # count lane, odd half-row
        cnt = cnt.repeat_interleave(_HP).view(-1, 8, 1)
        geff = (G8 + lam8 * w * cnt) * live8
    else:
        geff = G8
    gg = S8 + geff * geff
    wn = w - float(eta) * geff / (torch.sqrt(gg) + EPS)
    S8.copy_(gg)
    T2.view(-1, 8, _LANES).copy_(wn.to(torch.bfloat16))
    return T2, S2


def parts_scatter_adagrad_reference(rows, gpack, T2, S2, eta, lam8, live8,
                                    *, F: int, MRF: int, FK: int,
                                    lam_on: bool):
    """Plain PyTorch version of B1: ``index_add_`` into an f32 G, then the
    AdaGrad tail as tensor ops. Updates T2 and S2 in place and returns
    them."""
    G = _accumulate_reference(rows, gpack, F, MRF)
    return _adagrad_tail_reference(G, T2, S2, eta, lam8, live8, FK=FK,
                                   lam_on=lam_on)


def parts_row_bucket_reference(rows: torch.Tensor, MRF: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of parts_row_bucket: (order int32 [F*n], offsets int32
    [F*MRF + 1]). Slot f*n + j has the key f*MRF + rows[f, j]; table row r's
    slots are ``order[offsets[r]:offsets[r + 1]]`` in slot order (a stable
    sort), and the slots whose local row lies outside [0, MRF) follow, in
    slot order, at ``order[offsets[F*MRF]:]``."""
    F = rows.shape[0]
    r = rows.to(torch.int64)
    field = torch.arange(F, device=rows.device, dtype=torch.int64)[:, None]
    key = torch.where((r >= 0) & (r < MRF), field * MRF + r,
                      torch.full_like(r, F * MRF)).reshape(-1)
    counts = torch.bincount(key, minlength=F * MRF + 1)[:F * MRF]
    offsets = torch.zeros(F * MRF + 1, dtype=torch.int32, device=rows.device)
    offsets[1:] = counts.cumsum(0).to(torch.int32)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return order, offsets


_ENTRY = {}                     # entry point name -> ctypes function
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "parts_row_bucket": [_VP] + [_CI] * 8 + [_VP] * 6 + [_CI, _VP],
    "parts_scatter_adagrad": [_VP] * 10 + [ctypes.c_float] + [_CI] * 5
                             + [_VP],
    "parts_scatter_accum": [_VP] * 7 + [_CI] * 4 + [_VP],
    "parts_adagrad_tail": [_VP] * 5 + [ctypes.c_float] + [_CI] * 4 + [_VP],
}


def _kernel(name: str):
    """A C entry point of the built kernel library, with its ctypes
    signature."""
    fn = _ENTRY.get(name)
    if fn is None:
        from ..kernels.build import load_kernel
        fn = getattr(load_kernel("parts_scatter_adagrad"), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _CI
        _ENTRY[name] = fn
    return fn


def _launched(fn: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def _need_cuda(fn: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")


def parts_scatter_adagrad(rows, gpack, T2, S2, eta, lam8, live8, *,
                          F: int, MRF: int, FK: int, lam_on: bool):
    """Sum each table row's slot gradients and apply AdaGrad to the rows
    that have a slot, in place (see the module docstring for the operands);
    a row with no slot is neither read nor written. ``FK`` = F*K places the
    count lane (column FK+2). On the card the slots are bucketed by row
    (``parts_row_bucket``, counted apart) and each row's sum is taken in
    one fixed order, so the result is the same on every run. Returns
    (T2, S2)."""
    n = _check(rows, gpack, T2, S2, lam8, live8, F, MRF, FK)
    if T2.device.type == "cpu":
        return parts_scatter_adagrad_reference(
            rows, gpack, T2, S2, eta, lam8, live8, F=F, MRF=MRF, FK=FK,
            lam_on=lam_on)
    _need_cuda("parts_scatter_adagrad", T2.device)
    plan = _scatter_plan(F, n, MRF)
    b = _bucket(rows, F, n, MRF, plan)
    _launched("parts_scatter_adagrad", _kernel("parts_scatter_adagrad")(
        b.order, b.offsets, b.rowkey, gpack.data_ptr(), b.partial,
        b.tickets, T2.data_ptr(), S2.data_ptr(), lam8.data_ptr(),
        live8.data_ptr(), float(eta), F * MRF, plan.tile, plan.tiles,
        int(bool(lam_on)), FK + 2, b.stream))
    parts_scatter_adagrad.launches += 1
    return T2, S2


parts_scatter_adagrad.launches = 0


def parts_scatter_accum(rows, gpack, *, F: int, MRF: int) -> torch.Tensor:
    """B2: the f32 G [F*MRF, 256] whose row ``field*MRF + r`` is the sum of
    the gradient rows of the slots with ``rows[field, j] == r`` (+0.0 where
    there is none); ``F`` here is the rank's own partition count. A row
    outside [0, MRF) is dropped on the card; the plain version raises on it
    (the step never makes one). On the card each row's sum is the one B1
    applies, bit for bit."""
    fn_name = "parts_scatter_accum"
    dev = gpack.device
    _check_operands(fn_name, dev, (("rows", rows, torch.int32),
                                   ("gpack", gpack, torch.bfloat16)))
    n = _check_slots(fn_name, rows, gpack, F)
    if dev.type == "cpu":
        return _accumulate_reference(rows, gpack, F, MRF)
    _need_cuda(fn_name, dev)
    plan = _scatter_plan(F, n, MRF)
    b = _bucket(rows, F, n, MRF, plan)
    G = torch.empty((F * MRF, _HP * _LANES), dtype=torch.float32, device=dev)
    _launched(fn_name, _kernel(fn_name)(
        b.order, b.offsets, b.rowkey, gpack.data_ptr(), b.partial,
        b.tickets, G.data_ptr(), F * MRF, plan.tile, plan.tiles,
        plan.zero_blocks, b.stream))
    parts_scatter_accum.launches += 1
    return G


parts_scatter_accum.launches = 0


def parts_adagrad_tail(G, T2, S2, eta, lam8, live8, *, FK: int,
                       lam_on: bool):
    """The AdaGrad tail of B1 alone, on a given f32 G [R, 256] over a table
    of R logical rows (T2 bf16 / S2 f32 [2R, 128], in place). On the card a
    row whose G is +0.0 everywhere is not read or written (it would come
    out unchanged). Returns (T2, S2)."""
    fn_name = "parts_adagrad_tail"
    dev = T2.device
    _check_operands(fn_name, dev, (("G", G, torch.float32),
                                   ("T2", T2, torch.bfloat16),
                                   ("S2", S2, torch.float32),
                                   ("lam8", lam8, torch.float32),
                                   ("live8", live8, torch.float32)))
    _check_fk(fn_name, FK)
    if G.dim() != 2 or G.shape[1] != _HP * _LANES:
        raise ValueError(f"{fn_name}: G must be [R, 256], got "
                         f"{tuple(G.shape)}")
    R = G.shape[0]
    _check_table(fn_name, T2, S2, lam8, live8, R)
    if dev.type == "cpu":
        return _adagrad_tail_reference(G, T2, S2, eta, lam8, live8, FK=FK,
                                       lam_on=lam_on)
    _need_cuda(fn_name, dev)
    if R > _INT_MAX:
        raise ValueError(f"{fn_name}: {R} rows exceed the kernel's int32")
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched(fn_name, _kernel(fn_name)(
        G.data_ptr(), T2.data_ptr(), S2.data_ptr(), lam8.data_ptr(),
        live8.data_ptr(), float(eta), R, int(bool(lam_on)), FK + 2,
        min(_TAIL_BLOCKS, _cdiv(R, _WARPS)), stream))
    parts_adagrad_tail.launches += 1
    return T2, S2


parts_adagrad_tail.launches = 0


class _Bucketed(NamedTuple):
    """Addresses of one bucketing's outputs and of the reduction's scratch,
    inside ``ints``/``floats`` (kept alive by the caller's reference)."""
    ints: torch.Tensor
    floats: torch.Tensor
    order: int
    offsets: int
    rowkey: int
    tickets: int
    partial: int
    stream: int


def _bucket(rows, F: int, n: int, MRF: int, plan: _ScatterPlan
            ) -> _Bucketed:
    """parts_row_bucket on the card into new scratch: ints [plan.ints] =
    order [F*n], offsets [F*MRF + 1], row keys [F*n] (the table row of each
    sorted position), counters [F*chunks, MRF + 1], dropped counts
    [F*chunks], tickets [tiles] (zeroed by the launch); floats [plan.floats]
    the reduction's partial rows. The buffers are freed in stream order
    when the last reference goes."""
    dev = rows.device
    ints = torch.empty(plan.ints, dtype=torch.int32, device=dev)
    floats = torch.empty(plan.floats, dtype=torch.float32, device=dev)
    order = ints.data_ptr()
    offsets = order + 4 * F * n
    rowkey = offsets + 4 * (F * MRF + 1)
    counts = rowkey + 4 * F * n
    dropped = counts + 4 * F * plan.chunks * (MRF + 1)
    tickets = dropped + 4 * F * plan.chunks
    stream = torch.cuda.current_stream(dev).cuda_stream
    _launched("parts_row_bucket", _kernel("parts_row_bucket")(
        rows.data_ptr(), F, n, MRF, plan.chunk, plan.chunks, plan.smem_keys,
        plan.count_smem, plan.scatter_smem, order, offsets, rowkey, counts,
        dropped, tickets, plan.tiles, stream))
    parts_row_bucket.launches += 1
    return _Bucketed(ints, floats, order, offsets, rowkey, tickets,
                     floats.data_ptr(), stream)


def parts_row_bucket(rows: torch.Tensor, MRF: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The slots of rows int32 [F, n] bucketed by table row f*MRF + rows[f,
    j]: (order int32 [F*n], offsets int32 [F*MRF + 1]), as
    ``parts_row_bucket_reference`` defines them, bit for bit: a stable
    counting sort on the card (per-chunk counts, one scan, a scatter that
    keeps slot order within each row). CPU tensors take the plain
    version."""
    fn_name = "parts_row_bucket"
    if rows.dtype != torch.int32 or rows.dim() != 2 \
            or not rows.is_contiguous():
        raise ValueError(f"{fn_name}: rows must be contiguous int32 [F, n], "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if MRF < 1 or rows.shape[0] < 1:
        raise ValueError(f"{fn_name}: need F >= 1 and MRF >= 1")
    if rows.device.type == "cpu":
        return parts_row_bucket_reference(rows, MRF)
    _need_cuda(fn_name, rows.device)
    F, n = rows.shape
    b = _bucket(rows, F, n, MRF, _scatter_plan(F, n, MRF))
    ints = b.ints
    return ints[:F * n], ints[F * n:F * n + F * MRF + 1]


parts_row_bucket.launches = 0
