"""Level histograms of the tree builders: the port of
hivemall_tpu/ops/pallas_hist.py.

Each public function keeps the JAX contract and computes

    out[node, f, b, s] = sum_r [bins[r, f] == b] * [loc[r] == node] * ws[r, s]

with rows whose node id lies outside ``[0, n_nodes)`` (``-1`` = inactive) and
bin codes outside ``[0, n_bins)`` (the ``-1`` padding) adding nothing.

On CUDA tensors each wrapper launches its hand-written kernel
(kernels/tree_hist.cu) or raises; only CPU tensors go to the plain PyTorch
version beside it (``*_reference``), which the CPU tests run and against
which each kernel is held on the card. Every wrapper keeps a ``launches``
count, raised only where it launches its kernel.

  level_histogram_dense  (B3 ``hist_dense_int`` for ``fast=True``, B4
                         ``hist_dense_f32`` otherwise) — what the builder
                         calls; takes a leading tree axis on ``loc``/``ws``
                         so one launch covers every tree of a level
  level_histogram        (B5 ``hist_flat``) — channels in slabs of 8; no
                         sort: each block owns whole nodes and reads
                         only its rows' codes
  level_histogram_sorted (B6 ``hist_sorted``) — rows bucketed by node with
                         ``node_bucket`` (a counting sort on the card),
                         each block one slice of one node's rows; bin
                         counts that do not divide 128 go to
                         ``level_histogram``, as in the reference
  node_bucket            the counting sort, with a count of its own

B5 and B6 read uint8 or int32 bin codes as given (no int32 copy). Their
launches are planned here (``_flat_plan``, ``_sorted_plan``: node tile,
feature group, rows a block, grid, shared memory), so the plans are tested
on the CPU; the kernels take the plan's integers.

``fast`` means integer-valued channels (class indicator x bootstrap count):
B3 rounds each channel to the nearest integer (half to even) and accumulates
in int32, exactly; its plain version rounds the same way, so a fractional
channel gives the same histogram on the card and on the CPU. B5 and B6
accumulate in float32 for either value of ``fast``; the reference's
``fast`` only picked a one-pass bf16 matrix product there, and the two
functions keep the argument for its signature alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

__all__ = ["level_histogram_dense", "level_histogram", "level_histogram_sorted",
           "hist_dense_int", "hist_dense_f32", "node_bucket",
           "level_histogram_dense_reference", "level_histogram_reference",
           "level_histogram_sorted_reference", "node_bucket_reference",
           "transpose_bins"]

_SCH = 8            # channel slab of level_histogram (the reference's)
_TW = 128           # node-window width in columns of level_histogram_sorted
_MAX_CELLS = 227 * 1024 // 4   # one node x feature tile, n_bins * S, on the card

# Launch geometry of the flat and sorted kernels and node_bucket; _WARPS,
# _FLAT_LIST, _SORTED_BATCH, _LOC_AHEAD and _BUCKET_ROWS equal
# kernels/tree_hist.cu's kThreads/32, kFlatList, kSortedBatch, kLocAhead
# and kThreads*kBucketItems.
_WARPS = 16           # warps a block (512 threads)
_FLAT_LIST = 64       # rows of a warp's owned-row list (B5)
_SORTED_BATCH = 32    # rows a warp stages at a time (B6)
_LOC_AHEAD = 16       # node ids a lane loads ahead (B5): a warp step is 512
_SMEM_TARGET = 110 * 1024   # a block's shared memory: two blocks an SM
_SMEM_MAX = 227 * 1024      # the most one block may have (H100)
_MIN_SLICE = 512      # fewest rows a slice of a node (B6)
_BUCKET_ROWS = 512 * 8      # rows a block of node_bucket
_BUCKET_SMEM = 48 * 1024    # node_bucket counts in shared memory up to this
_GRID_Y = 65535


def transpose_bins(bins: torch.Tensor) -> torch.Tensor:
    """The dense functions' ``bins_t``: int32 [dp, np_] bin codes, features
    padded to a multiple of 8 and rows to a multiple of 1024 with -1, as the
    reference builder lays them out (ops/trees.py:182-186)."""
    n, d = bins.shape
    np_ = -(-n // 1024) * 1024
    dp = -(-d // 8) * 8
    out = torch.full((dp, np_), -1, dtype=torch.int32, device=bins.device)
    out[:d, :n] = bins.t().to(torch.int32)
    return out


# --- plain versions ----------------------------------------------------------

def _scatter(bins_fn, d: int, loc: torch.Tensor, ws: torch.Tensor,
             n_nodes: int, n_bins: int, dtype) -> torch.Tensor:
    """[n_nodes, d, n_bins, S] by index_add_ over the flat
    ((node*d + f)*n_bins + bin) index, one feature at a time. ``bins_fn(f)``
    gives feature f's codes for the n rows."""
    S = ws.shape[-1]
    out = torch.zeros((n_nodes * d * n_bins, S), dtype=dtype, device=ws.device)
    live = (loc >= 0) & (loc < n_nodes)
    w = ws.to(dtype)
    for f in range(d):
        b = bins_fn(f).to(torch.int64)
        ok = live & (b >= 0) & (b < n_bins)
        idx = (loc.to(torch.int64) * d + f) * n_bins + b
        out.index_add_(0, idx[ok], w[ok])
    return out.view(n_nodes, d, n_bins, S)


def level_histogram_dense_reference(bins_t: torch.Tensor, loc: torch.Tensor,
                                    ws: torch.Tensor, n_nodes: int,
                                    n_bins: int,
                                    dtype: torch.dtype = torch.float32,
                                    fast: bool = False) -> torch.Tensor:
    """Plain version of the dense functions, one tree at a time; ``dtype``
    float64 gives the sum the f32 kernel is held against. ``fast`` rounds
    the channels to the nearest integer (half to even) first, as B3 does."""
    if loc.dim() == 1:
        return level_histogram_dense_reference(
            bins_t, loc[None], ws[None], n_nodes, n_bins, dtype, fast)[0]
    if fast:
        ws = torch.round(ws)
    dp = bins_t.shape[0]
    n = loc.shape[1]
    return torch.stack([
        _scatter(lambda f: bins_t[f, :n], dp, loc[e], ws[e], n_nodes, n_bins,
                 dtype)
        for e in range(loc.shape[0])])


def level_histogram_reference(bins: torch.Tensor, loc: torch.Tensor,
                              ws: torch.Tensor, n_nodes: int, n_bins: int,
                              dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Plain version of level_histogram (the reference's _hist_scatter)."""
    return _scatter(lambda f: bins[:, f], bins.shape[1], loc, ws, n_nodes,
                    n_bins, dtype)


def _sort_rows(loc: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Row order by node id, rows outside [0, n_nodes) last."""
    return torch.argsort(_node_keys(loc, n_nodes))


def _node_keys(loc: torch.Tensor, n_nodes: int) -> torch.Tensor:
    return torch.where((loc >= 0) & (loc < n_nodes), loc,
                       torch.full_like(loc, n_nodes))


def node_bucket_reference(loc: torch.Tensor, n_nodes: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of node_bucket: (order, offsets), int32. The rows of
    node k are ``order[offsets[k]:offsets[k+1]]`` (here in row order; the
    card's order inside a node is unset), rows outside [0, n_nodes) last
    at ``order[offsets[n_nodes]:]``; ``offsets`` [n_nodes + 2] is the
    cumulative count of each key, 0 first."""
    key = _node_keys(loc, n_nodes).to(torch.int64)
    counts = torch.bincount(key, minlength=n_nodes + 1)
    offsets = torch.zeros(n_nodes + 2, dtype=torch.int32, device=loc.device)
    offsets[1:] = counts.cumsum(0).to(torch.int32)
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return order, offsets


def level_histogram_sorted_reference(bins: torch.Tensor, loc: torch.Tensor,
                                     ws: torch.Tensor, n_nodes: int,
                                     n_bins: int,
                                     dtype: torch.dtype = torch.float32
                                     ) -> torch.Tensor:
    """Plain version of level_histogram_sorted: the rows sorted by node,
    then scattered."""
    order = _sort_rows(loc, n_nodes)
    return level_histogram_reference(bins[order], loc[order], ws[order],
                                     n_nodes, n_bins, dtype)


# --- kernel entry points -----------------------------------------------------

_KERNELS: dict = {}


def _kernel(name: str):
    """The built kernel ``name`` of tree_hist.cu, with its ctypes signature."""
    fn = _KERNELS.get(name)
    if fn is None:
        from ..kernels.build import load_kernel
        fn = getattr(load_kernel("tree_hist"), name)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name in ("hist_dense_int", "hist_dense_f32"):
            fn.argtypes = [vp, vp, vp, vp, ci, ci, ctypes.c_longlong, ci, ci,
                           ci, ci, vp]
        elif name == "hist_flat":
            fn.argtypes = [vp, ci, vp, vp, vp] + [ci] * 13 + [vp]
        elif name == "hist_sorted":
            fn.argtypes = [vp, vp, vp, vp, ci, vp, vp] + [ci] * 9 + [vp]
        else:                                   # node_bucket
            fn.argtypes = [vp, ci, ci, vp, vp, vp, ci, ci, vp]
        fn.restype = ci
        _KERNELS[name] = fn
    return fn


def _run(name: str, *args) -> None:
    rc = _kernel(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_SMS: dict = {}


def _sms(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev``."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


# --- launch plans of B5 and B6 (plain Python, tested on the CPU) ------------

class _Plan(NamedTuple):
    nodes: int              # whole nodes a tile (B5); 1 (B6: one node)
    features: int           # features a group
    rows: int               # rows a block: B5 a chunk, B6 a node's slice
    grid: Tuple[int, int]   # (gridDim.x, gridDim.y)
    smem: int               # dynamic shared memory a block, bytes


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _tile_room(who: str, cell: int, staged: int) -> int:
    """Shared bytes left for the histogram tile beside ``staged`` bytes of
    staged rows: the two-blocks-an-SM target, or up to the block maximum
    where one node x one feature (``cell`` bytes) needs it."""
    room = _SMEM_TARGET - staged
    if cell > room:
        room = _SMEM_MAX - staged
    if cell > room:
        raise ValueError(f"{who}: one node x one feature of the histogram "
                         f"({cell} bytes) does not fit a block's shared "
                         f"memory beside its staged rows")
    return room


def _check_rows_fit(who: str, n: int) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{who}: {n} rows exceed the kernel's int32 row "
                         "ids")


def _flat_plan(n: int, d: int, M: int, B: int, S: int, sms: int) -> _Plan:
    """B5: tiles of whole nodes x feature groups, sized so that the tile and
    the warps' row lists fill about 110 KB (two blocks an SM); rows in
    chunks such that about two blocks an SM run over all tiles (a shallow
    level: one tile, 2 x sms blocks, each flushing once)."""
    _check_rows_fit("level_histogram", n)
    Sk = min(S, _SCH)
    staged = 4 * _WARPS * _FLAT_LIST * (2 + Sk)
    cell = 4 * B * Sk                          # one node x one feature
    room = _tile_room("level_histogram", cell, staged)
    if cell * d <= room:
        NT, FG = min(M, room // (cell * d)), d
    else:
        NT, FG = 1, room // cell
    n_nt, n_fg = _cdiv(M, NT), _cdiv(d, FG)
    NT, FG = _cdiv(M, n_nt), _cdiv(d, n_fg)    # even tiles
    tiles = n_nt * n_fg
    step = 32 * _LOC_AHEAD                     # rows of one warp step
    chunks = max(1, min(2 * sms // tiles, _cdiv(n, step), _GRID_Y))
    rows = max(1, _cdiv(n, chunks))
    return _Plan(NT, FG, rows, (tiles, max(1, _cdiv(n, rows))),
                 4 * NT * FG * B * Sk + staged)


def _sorted_plan(n: int, d: int, M: int, B: int, S: int, sms: int) -> _Plan:
    """B6: blocks of (slice of one node's rows, feature group); a group is
    the node's features that fit about 110 KB beside the staged rows; the
    slice is long enough that the blocks of a one-node level number about
    two an SM. gridDim.x bounds the slices, sum_k ceil(rows_k / L) <=
    ceil(n / L) + M; the blocks past the real count return at once."""
    _check_rows_fit("level_histogram_sorted", n)
    Sk = min(S, _SCH)
    staged = 4 * _WARPS * _SORTED_BATCH * (1 + Sk)
    cell = 4 * B * Sk
    room = _tile_room("level_histogram_sorted", cell, staged)
    FG = min(d, room // cell)
    n_fg = _cdiv(d, FG)
    FG = _cdiv(d, n_fg)
    L = max(_MIN_SLICE, _cdiv(n * n_fg, 2 * sms))
    return _Plan(1, FG, L, (_cdiv(n, L) + M, n_fg),
                 4 * FG * B * Sk + staged)


def _bucket_plan(n: int, M: int) -> Tuple[int, int]:
    """node_bucket: (blocks, counts in shared memory or not)."""
    return _cdiv(n, _BUCKET_ROWS), int(4 * (M + 1) <= _BUCKET_SMEM)


# --- operand checks ----------------------------------------------------------

def _check_common(who: str, tensors, n_nodes: int, n_bins: int, S: int):
    dev = tensors[0][1].device
    for name, t, dts in tensors:
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, "
                             f"{tensors[0][0]} on {dev}")
        if t.dtype not in dts:
            raise TypeError(f"{who}: {name} must be "
                            f"{' or '.join(map(str, dts))}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if n_nodes < 1 or n_bins < 2:
        raise ValueError(f"{who}: need n_nodes >= 1 and n_bins >= 2, got "
                         f"{n_nodes}, {n_bins}")
    if S < 1:
        raise ValueError(f"{who}: ws needs at least one channel")
    if dev.type == "cuda" and n_bins * S > _MAX_CELLS:
        raise ValueError(f"{who}: n_bins*S = {n_bins * S} exceeds the "
                         f"kernel's one-tile envelope {_MAX_CELLS}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {dev}")
    return dev


def _check_dense(who, bins_t, loc, ws, n_nodes, n_bins):
    dev = _check_common(who, [("bins_t", bins_t, (torch.int32,)),
                              ("loc", loc, (torch.int32,)),
                              ("ws", ws, (torch.float32,))],
                        n_nodes, n_bins, ws.shape[-1] if ws.dim() else 0)
    if bins_t.dim() != 2:
        raise ValueError(f"{who}: bins_t must be [dp, np_], got "
                         f"{tuple(bins_t.shape)}")
    if loc.dim() not in (1, 2) or ws.dim() != loc.dim() + 1 \
            or tuple(ws.shape[:-1]) != tuple(loc.shape):
        raise ValueError(f"{who}: need loc [n] with ws [n, S], or loc [E, n] "
                         f"with ws [E, n, S]; got {tuple(loc.shape)} and "
                         f"{tuple(ws.shape)}")
    if loc.shape[-1] > bins_t.shape[1]:
        raise ValueError(f"{who}: {loc.shape[-1]} rows but bins_t holds "
                         f"{bins_t.shape[1]}")
    return dev


def _check_rows(who, bins, loc, ws, n_nodes, n_bins):
    dev = _check_common(who, [("bins", bins, (torch.int32, torch.uint8)),
                              ("loc", loc, (torch.int32,)),
                              ("ws", ws, (torch.float32,))],
                        n_nodes, n_bins, ws.shape[-1] if ws.dim() else 0)
    if bins.dim() != 2 or loc.dim() != 1 or ws.dim() != 2 \
            or not (bins.shape[0] == loc.shape[0] == ws.shape[0]):
        raise ValueError(f"{who}: need bins [n, d], loc [n], ws [n, S]; got "
                         f"{tuple(bins.shape)}, {tuple(loc.shape)}, "
                         f"{tuple(ws.shape)}")
    return dev


# --- B3 / B4: dense, tree-batched --------------------------------------------

def _dense(name: str, bins_t, loc, ws, n_nodes: int, n_bins: int):
    dev = _check_dense(name, bins_t, loc, ws, n_nodes, n_bins)
    if dev.type == "cpu":
        return level_histogram_dense_reference(
            bins_t, loc, ws, n_nodes, n_bins, fast=name == "hist_dense_int")
    batched = loc.dim() == 2
    E, n = (loc.shape if batched else (1, loc.shape[0]))
    dp, np_ = bins_t.shape
    S = ws.shape[-1]
    out = torch.empty((E, n_nodes, dp, n_bins, S), dtype=torch.float32,
                      device=dev)
    _run(name, bins_t.data_ptr(), loc.data_ptr(), ws.data_ptr(),
         out.data_ptr(), E, n, np_, dp, n_nodes, n_bins, S, _stream(out))
    return out if batched else out[0]


def hist_dense_int(bins_t, loc, ws, n_nodes: int, n_bins: int):
    """B3: dense level histogram of integer-valued channels, accumulated in
    int32 (exact, the same bits on every run while a cell's sum stays below
    2^24). Each channel is rounded to the nearest integer (half to even)
    first, on the card and in the plain version alike."""
    out = _dense("hist_dense_int", bins_t, loc, ws, n_nodes, n_bins)
    if out.is_cuda:
        hist_dense_int.launches += 1
    return out


def hist_dense_f32(bins_t, loc, ws, n_nodes: int, n_bins: int):
    """B4: dense level histogram of arbitrary float32 channels (no bf16, no
    TF32 anywhere)."""
    out = _dense("hist_dense_f32", bins_t, loc, ws, n_nodes, n_bins)
    if out.is_cuda:
        hist_dense_f32.launches += 1
    return out


hist_dense_int.launches = 0
hist_dense_f32.launches = 0


def level_histogram_dense(bins_t: torch.Tensor, loc: torch.Tensor,
                          ws: torch.Tensor, n_nodes: int, n_bins: int,
                          fast: bool = False) -> torch.Tensor:
    """Dense level histogram.

    bins_t: int32 [dp, np_] transposed, padded bin codes (``transpose_bins``;
    built once a fit, it never changes across levels or trees). loc: int32
    [n] node-local ids (-1 = inactive); ws: f32 [n, S]. With a leading tree
    axis (loc [E, n], ws [E, n, S]) every tree goes in one launch.
    Returns f32 [n_nodes, dp, n_bins, S] ([E, n_nodes, dp, n_bins, S]); the
    padded features' rows are zero, callers slice ``[..., :d, :, :]``.
    ``fast`` (integer channels, rounded to the nearest integer) takes B3,
    else B4.
    """
    fn = hist_dense_int if fast else hist_dense_f32
    return fn(bins_t, loc, ws, n_nodes, n_bins)


# --- B5: flat ------------------------------------------------------------------

def level_histogram(bins: torch.Tensor, loc: torch.Tensor, ws: torch.Tensor,
                    n_nodes: int, n_bins: int,
                    fast: bool = False) -> torch.Tensor:
    """Histogram one level: bins uint8/int32 [n, d], loc int32 [n] (-1 =
    inactive), ws f32 [n, S] -> f32 [n_nodes, d, n_bins, S]. Channels go
    through the kernel in slabs of 8, one launch each, into one output; the
    codes are read in the dtype given. ``fast`` is kept for the
    reference's signature and changes nothing: the sum is float32."""
    dev = _check_rows("level_histogram", bins, loc, ws, n_nodes, n_bins)
    if dev.type == "cpu":
        return level_histogram_reference(bins, loc, ws, n_nodes, n_bins)
    n, d = bins.shape
    S = ws.shape[1]
    plan = _flat_plan(n, d, n_nodes, n_bins, S, _sms(dev))
    out = torch.empty((n_nodes, d, n_bins, S), dtype=torch.float32,
                      device=dev)                  # zeroed by the first slab
    stream = _stream(out)
    for c0 in range(0, S, _SCH):
        _run("hist_flat", bins.data_ptr(), bins.element_size(),
             loc.data_ptr(), ws.data_ptr(), out.data_ptr(), n, d, n_nodes,
             n_bins, S, c0, min(_SCH, S - c0), plan.nodes, plan.features,
             plan.rows, *plan.grid, plan.smem, stream)
        level_histogram.launches += 1
    return out


level_histogram.launches = 0


# --- B6: node-sorted ---------------------------------------------------------

def node_bucket(loc: torch.Tensor, n_nodes: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows bucketed by node: loc int32 [n] -> (order int32 [n], offsets
    int32 [n_nodes + 2]); node k's rows are ``order[offsets[k]:offsets[k +
    1]]``, rows outside [0, n_nodes) last. On the card a counting sort (a
    per-block count of every node, one scan, a scatter); the order inside
    a node is unset there. CPU tensors take node_bucket_reference."""
    if loc.dtype != torch.int32 or loc.dim() != 1 \
            or not loc.is_contiguous():
        raise ValueError("node_bucket: loc must be contiguous int32 [n], got "
                         f"{loc.dtype} {tuple(loc.shape)}")
    if n_nodes < 1:
        raise ValueError(f"node_bucket: need n_nodes >= 1, got {n_nodes}")
    if loc.device.type == "cpu":
        return node_bucket_reference(loc, n_nodes)
    if loc.device.type != "cuda":
        raise ValueError(f"node_bucket: unsupported device {loc.device}")
    n = loc.shape[0]
    buf = _bucket(loc, n_nodes)[0]
    return buf[:n], buf[n:n + n_nodes + 2]


def _bucket(loc: torch.Tensor, n_nodes: int):
    """node_bucket on the card into one new int32 buffer [n + 3*n_nodes +
    4]: order [n], offsets [n_nodes + 2], then 2*(n_nodes + 1) ints of
    scratch, free again once the launch is queued. Returns the buffer and
    the three addresses."""
    n = loc.shape[0]
    _check_rows_fit("node_bucket", n)
    buf = torch.empty(n + 3 * n_nodes + 4, dtype=torch.int32,
                      device=loc.device)
    order = buf.data_ptr()
    offsets = order + 4 * n
    scratch = offsets + 4 * (n_nodes + 2)
    _run("node_bucket", loc.data_ptr(), n, n_nodes, order, offsets, scratch,
         *_bucket_plan(n, n_nodes), _stream(loc))
    node_bucket.launches += 1
    return buf, order, offsets, scratch


node_bucket.launches = 0


def level_histogram_sorted(bins: torch.Tensor, loc: torch.Tensor,
                           ws: torch.Tensor, n_nodes: int, n_bins: int,
                           fast: bool = False) -> torch.Tensor:
    """The same contract as level_histogram over rows bucketed by node
    (``node_bucket``, counted apart). Each block takes one slice of one
    node's rows and histograms them in shared memory; every channel goes
    in one call. Bin counts that do not divide 128 go to level_histogram,
    as in the reference. ``fast`` is kept for the reference's signature
    and changes nothing."""
    dev = _check_rows("level_histogram_sorted", bins, loc, ws, n_nodes,
                      n_bins)
    if _TW % n_bins:
        return level_histogram(bins, loc, ws, n_nodes, n_bins, fast=fast)
    if dev.type == "cpu":
        return level_histogram_sorted_reference(bins, loc, ws, n_nodes,
                                                n_bins)
    n, d = bins.shape
    S = ws.shape[1]
    plan = _sorted_plan(n, d, n_nodes, n_bins, S, _sms(dev))
    # the bucket scratch holds the [n_nodes + 1] slice starts
    buf, order, offsets, slice_start = _bucket(loc, n_nodes)
    out = torch.empty((n_nodes, d, n_bins, S), dtype=torch.float32,
                      device=dev)                  # zeroed by hist_sorted
    _run("hist_sorted", order, offsets, slice_start, bins.data_ptr(),
         bins.element_size(), ws.data_ptr(), out.data_ptr(), d, n_nodes,
         n_bins, S, plan.features, plan.rows, *plan.grid, plan.smem,
         _stream(out))
    level_histogram_sorted.launches += 1
    return out


level_histogram_sorted.launches = 0
