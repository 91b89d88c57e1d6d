// Gradient scatter + AdaGrad for the FFM "parts" table, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by kernels/build.py and called only
// through hivemall_tpu_torch/ops/parts_scatter.py.
//
// Replaces two TPU kernels of hivemall_tpu/ops/fm_pallas.py:
//   B1 parts_scatter_adagrad: _make_scatter_opt_kernel (pallas_call at
//      fm_pallas.py:236), the single-device step: every slot's 256-wide
//      gradient row added into its table row, then AdaGrad on the table;
//   B2 parts_scatter_accum: _make_scatter_accum_kernel (pallas_call at
//      fm_pallas.py:301), the sharded step's accumulate alone, emitting
//      G [Fl*MRF, 256] f32 (the caller sums G over its dp ranks);
// and the sharded step's optimizer, parts_adagrad_tail, the same AdaGrad
// on a given G. The TPU kernels keep one field partition's G in VMEM
// (8 MiB at F=40, MRF=8192, far past an SM's 227 KB of shared memory) and
// add the slots one after another in slot order.
//
// What bounds them on an H100: bytes. At B=32768, F=40, MRF=8192 (m=1):
//   B1 must read each slot's bf16 gradient row once (671 MB) and read and
//      write T2/S2 on the rows that have a slot (~199,000 of 327,680 on
//      Zipf-skewed ids, ~612 MB): about 1.29 GB, 0.38 ms at 3.35 TB/s;
//   B2 reads the gradient and writes the whole G: 1.01 GB, 0.30 ms;
//   the tail reads G whole and T2/S2 on the rows G touches.
// The arithmetic (one add a gradient value, ~10 flops a table cell) is
// far below the card's rate. What held the first version (memset G, one
// red.global.add.f32 per gradient value, a tail over every cell) away from
// those bounds: ~5,000 serialized atomics on each Zipf-head row, G's round
// trip through device memory for B1, and a tail that visits all 84 M cells.
//
// The design: a stable bucketing of the slots by table row, then one
// segmented reduction over the sorted slots, with no float atomics.
//   parts_row_bucket: key = f*MRF + rows[f, j]; a slot whose local row is
//     outside [0, MRF) is dropped (it goes after every bucket, as an XLA
//     scatter drops it). Three kernels: per-(field, chunk) counts of each
//     local row (shared memory up to 48 KB of counters, else global), one
//     block a field scanning them into row offsets and each chunk's
//     cursors, and a scatter in which each warp of a chunk's block walks
//     the whole chunk in slot order and places the slots of its own
//     residue class of rows, so every row's slots keep slot order f*n + j
//     (the order in which the TPU kernel adds them). Out: order [F*n]
//     (slot ids by row), offsets [F*MRF + 1], and for the reduction each
//     sorted position's row. No host sync: every grid comes from shapes.
//   The reduction: one warp takes a tile of `tile` (128) consecutive
//     sorted positions, whatever rows they hold, so a Zipf-head row of
//     thousands of slots is spread over many warps and no warp sums more
//     than a tile. Each lane owns 8 of the 256 columns and loads every
//     slot's row 16 bytes a lane, several slots ahead, summing in f32 from
//     +0.0 in position order. A row whose slots lie in one tile is
//     finished by that warp. A row that spans tiles leaves one partial
//     sum per tile in a scratch area; the warp that takes the row's last
//     ticket (an integer atomic) adds the partials in tile order and
//     finishes it.
//   B1 finishes a row by applying AdaGrad to its two half-rows of T2/S2;
//     rows with no slot are never read or written, and no G exists. Its
//     row updates wait on their T2/S2 loads, so it runs more warps (4
//     blocks an SM, 64 registers) with fewer slots in flight each (4)
//     than B2 (3 blocks, 8 slots): on an H100 SXM that took its
//     reduction from 1.15 to 0.66 device ms at the flagship shape
//     (PERF.md).
//   B2 finishes a row by writing its sum into G; the same launch writes
//     +0.0 into every row with no slot, so each byte of G is written once.
//   The tail visits every row of G, but reads and writes T2/S2 only where
//     the G row has a bit set: an all +0.0 row comes out unchanged. (A
//     -0.0 in G is applied: with T = -0.0 and no L2 it gives +0.0.)
// Per table cell, with cnt = the row's count lane FK+2 (odd half-row):
//   Geff = (G + lam*T*cnt) * live   (lam_on)      Geff = G   (otherwise)
//   S'   = S + Geff^2
//   T'   = bf16_rn(T - eta*Geff / (sqrt(S') + 1e-6))
// built with --fmad=false, so it rounds as the plain PyTorch version's
// separate float32 operations do. A row whose gradient is +0.0 everywhere
// comes out bit-identical (for finite T and S >= +0.0).
//
// Determinism: the bucketing is stable, the tiles are fixed by positions,
// each partial is summed in position order and the partials in tile order,
// so every row's sum has one order and one rounding, on every run. B1 and
// B2 share the reduction, and the tail is B1's own device function, so
// parts_scatter_adagrad(rows, g, T2, S2, ...) equals
// parts_adagrad_tail(parts_scatter_accum(rows, g), T2, S2, ...) bit for
// bit on any gradient.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;          // lanes of one half-row
constexpr int kWidth = 2 * kLanes;   // padded row width Wp = 256
constexpr int kThreads = 256;        // bucketing, reduction and tail blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
// gradient rows a warp keeps in flight, and blocks an SM (register room):
// B1 trades depth for warps, since its row updates wait on their loads
constexpr int kAheadAccum = 8, kAheadApply = 4;
constexpr int kBlocksAccum = 3, kBlocksApply = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// local row of flat slot s, or MRF where it is outside [0, MRF) (dropped)
__device__ __forceinline__ int local_key(const int* __restrict__ rows,
                                         int64_t s, int MRF) {
  const int r = __ldg(rows + s);
  return (unsigned)r < (unsigned)MRF ? r : MRF;
}

// Inclusive scan of v over the block (blockDim.x a multiple of 32); *total
// gets the block's sum. All threads call it. sums: 32 ints of shared.
__device__ int block_scan(int v, int* sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  x += warp ? sums[warp - 1] : 0;
  *total = sums[nw - 1];
  __syncthreads();                               // sums is reused
  return x;
}

// ---- parts_row_bucket ----------------------------------------------------
// Block b = f*chunks + c takes slots j in [c*chunk, min((c+1)*chunk, n)) of
// field f. counts int32 [F*chunks, MRF+1]: row b holds its chunk's count of
// each local row (entry MRF: dropped slots), later its cursors.

// Counts of block b's chunk; dropped[b] = its dropped slots. Also zeroes
// the reduction's tickets (grid-stride), which run after it.
__global__ void __launch_bounds__(kThreads)
bucket_count_kernel(const int* __restrict__ rows, int n, int MRF, int chunk,
                    int chunks, int* __restrict__ counts,
                    int* __restrict__ dropped, int smem_keys,
                    int* __restrict__ tickets, int n_tickets) {
  extern __shared__ __align__(16) int sh[];
  const int b = blockIdx.x;
  const int f = b / chunks, c = b - f * chunks;
  int* row = counts + (int64_t)b * (MRF + 1);
  int* tgt = smem_keys ? sh : row;
  for (int k = threadIdx.x; k <= MRF; k += kThreads) tgt[k] = 0;
  for (int64_t i = (int64_t)b * kThreads + threadIdx.x; i < n_tickets;
       i += (int64_t)gridDim.x * kThreads)
    tickets[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j0 = c * chunk, j1 = min(j0 + chunk, n);
  for (int jb = j0; jb < j1; jb += kThreads) {
    const int j = jb + threadIdx.x;
    const int key = j < j1 ? local_key(rows, (int64_t)f * n + j, MRF) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    if (key >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(tgt + key, __popc(peers));
  }
  __syncthreads();
  if (smem_keys)
    for (int k = threadIdx.x; k <= MRF; k += kThreads) row[k] = sh[k];
  if (threadIdx.x == 0) dropped[b] = tgt[MRF];
}

// One block a field. offsets[f*MRF + k] = the first position of row
// (f, k); counts rows become cursors: the first position of chunk c's
// slots of row k (entry MRF: of its dropped slots, which go after all
// V valid slots in slot order). offsets[F*MRF] = V.
__global__ void __launch_bounds__(kScanThreads)
bucket_scan_kernel(int* __restrict__ counts, const int* __restrict__ dropped,
                   int n, int MRF, int F, int chunks,
                   int* __restrict__ offsets) {
  __shared__ int sums[32];
  const int f = blockIdx.x;
  const int64_t stride = (int64_t)MRF + 1;
  int before = 0, all = 0;                       // dropped slots
  for (int i = threadIdx.x; i < F * chunks; i += blockDim.x) {
    const int v = dropped[i];
    all += v;
    if (i < f * chunks) before += v;
  }
  block_scan(before, sums, &before);
  block_scan(all, sums, &all);
  const int V = F * n - all;
  int* base = counts + (int64_t)f * chunks * stride;
  if (threadIdx.x == 0) {
    int run = V + before;
    for (int c = 0; c < chunks; ++c) {
      base[c * stride + MRF] = run;
      run += dropped[f * chunks + c];
    }
    if (f == 0) offsets[(int64_t)F * MRF] = V;
  }
  int carry = f * n - before;                    // valid slots of fields < f
  for (int k0 = 0; k0 < MRF; k0 += blockDim.x) {
    const int k = k0 + threadIdx.x;
    int v = 0;
    if (k < MRF)
      for (int c = 0; c < chunks; ++c) v += base[c * stride + k];
    int total;
    const int incl = block_scan(v, sums, &total);
    if (k < MRF) {
      int run = carry + incl - v;
      offsets[(int64_t)f * MRF + k] = run;
      for (int c = 0; c < chunks; ++c) {
        int* p = base + c * stride + k;
        const int x = *p;
        *p = run;
        run += x;
      }
    }
    carry += total;
  }
}

// order[cursor + rank] = slot, and rowkey[cursor + rank] = its table row
// (meaningful at the valid positions only). The chunk's keys are staged in
// shared memory (after the cursors when those are there too); warp w walks
// all of them in slot order and places the slots whose key % kWarps == w,
// so one warp moves each key's cursor and ranks follow slot order.
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int* __restrict__ rows, int n, int MRF,
                      int chunk, int chunks, int* __restrict__ counts,
                      int smem_keys, int* __restrict__ order,
                      int* __restrict__ rowkey) {
  extern __shared__ __align__(16) int sh[];
  const int b = blockIdx.x;
  const int f = b / chunks, c = b - f * chunks;
  int* cur = counts + (int64_t)b * (MRF + 1);
  int* keys = sh;
  if (smem_keys) {
    for (int k = threadIdx.x; k <= MRF; k += kThreads) sh[k] = cur[k];
    cur = sh;
    keys = sh + MRF + 1;
  }
  const int64_t s0 = (int64_t)f * n;
  const int j0 = c * chunk, j1 = min(j0 + chunk, n);
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
    keys[j - j0] = local_key(rows, s0 + j, MRF);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int jb = j0; jb < j1; jb += 32) {
    const int j = jb + lane;
    int key = j < j1 ? keys[j - j0] : -1;
    if (key % kWarps != warp) key = -1;          // another warp's key
    const unsigned peers = __match_any_sync(kFull, key);
    const int leader = __ffs(peers) - 1;
    int pos = 0;
    if (key >= 0 && lane == leader) {
      pos = cur[key];
      cur[key] = pos + __popc(peers);
    }
    pos = __shfl_sync(kFull, pos, leader);
    if (key >= 0) {
      pos += __popc(peers & lanes_below());
      order[pos] = (int)(s0 + j);
      rowkey[pos] = f * MRF + key;
    }
    __syncwarp();
  }
}

// ---- the segmented reduction --------------------------------------------

struct Reduce {
  const int* order;          // [F*n] slot ids by row
  const int* offsets;        // [table_rows + 1]
  const int* rowkey;         // [F*n] the table row of each sorted position
  const uint4* grad;         // [F*n, 256] bf16, 32 uint4 a slot
  float* partial;            // [2*tiles, 256] partial sums of spanning rows
  int* tickets;              // [tiles] zeroed by bucket_count_kernel
  int tile, tiles;
  int64_t table_rows;
  float* G;                  // B2: [table_rows, 256]
  __nv_bfloat16* T2;         // B1 and the tail: [2*table_rows, 128]
  float* S2;
  const float* lam8;         // [8, 128]
  const float* live8;
  float eta;
  int lam_on;
  int cnt_col;               // column of the count lane, FK + 2
};

// 8 bf16 (16 bytes, the lower address first) widened to float32, exactly
__device__ __forceinline__ void widen8(const uint4& q, float* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned bf16x2_rn(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void add_bf16x8(float* acc, const uint4& q) {
  float v[8];
  widen8(q, v);
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] += v[i];
}

// AdaGrad on table row `row`, whose gradient sum's columns 8*lane .. +7
// this lane holds in g: lanes 0-15 the even half-row, 16-31 the odd one.
__device__ __forceinline__ void adagrad_row(const Reduce& a, int64_t row,
                                            const float* g, int lane) {
  float cnt = 0.0f;
  if (a.lam_on) {                                // the count lane's sum
    const int e = a.cnt_col & 7;
    float mine = g[0];
#pragma unroll
    for (int i = 1; i < 8; ++i)
      if (i == e) mine = g[i];
    cnt = __shfl_sync(kFull, mine, a.cnt_col >> 3);
  }
  const int64_t R = 2 * row + (lane >> 4);       // physical half-row
  const int c = (lane & 15) * 8;
  uint4* tp = reinterpret_cast<uint4*>(a.T2 + R * kLanes + c);
  float4* sp = reinterpret_cast<float4*>(a.S2 + R * kLanes + c);
  const float4 sa = sp[0], sb = sp[1];
  float w[8], s[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  widen8(*tp, w);
  const int p = (int)(R & 7) * kLanes + c;       // [8, 128] pattern cell
  float wn[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float geff = g[i];
    if (a.lam_on)
      geff = (geff + __ldg(a.lam8 + p + i) * w[i] * cnt) *
             __ldg(a.live8 + p + i);
    const float gg = s[i] + geff * geff;
    wn[i] = w[i] - a.eta * geff / (sqrtf(gg) + 1e-6f);
    s[i] = gg;
  }
  sp[0] = make_float4(s[0], s[1], s[2], s[3]);
  sp[1] = make_float4(s[4], s[5], s[6], s[7]);
  *tp = make_uint4(bf16x2_rn(wn[0], wn[1]), bf16x2_rn(wn[2], wn[3]),
                   bf16x2_rn(wn[4], wn[5]), bf16x2_rn(wn[6], wn[7]));
}

template <bool kApply>
__device__ __forceinline__ void finish_row(const Reduce& a, int row,
                                           const float* g, int lane) {
  if (kApply) {
    adagrad_row(a, row, g, lane);
  } else {
    float4* dst = reinterpret_cast<float4*>(a.G + (int64_t)row * kWidth) +
                  lane * 2;
    dst[0] = make_float4(g[0], g[1], g[2], g[3]);
    dst[1] = make_float4(g[4], g[5], g[6], g[7]);
  }
}

// The sum `acc` of row `row`'s slots inside tile t (first: the tile's first
// segment, last: its last). A row wholly inside the tile is finished here;
// a piece of a row that spans tiles is parked, and the warp that takes the
// row's last ticket adds the pieces in tile order and finishes the row.
template <bool kApply>
__device__ __forceinline__ void finish_segment(const Reduce& a, int t,
                                               int p0, int row,
                                               const float* acc, bool first,
                                               bool last, int lane) {
  int lo = p0, hi = p0;
  if (first || last) {
    lo = __ldg(a.offsets + row);
    hi = __ldg(a.offsets + row + 1);
  }
  if (lo >= p0 && hi <= p0 + a.tile) {
    finish_row<kApply>(a, row, acc, lane);
    return;
  }
  // a row that starts before this tile parks its piece in slot 2t (the
  // tile's first segment); one that starts here and runs on, in 2t + 1
  const int t0 = lo / a.tile, t1 = (hi - 1) / a.tile;
  const int64_t slot = lo < p0 ? 2 * (int64_t)t : 2 * (int64_t)t + 1;
  float4* dst = reinterpret_cast<float4*>(a.partial + slot * kWidth) +
                lane * 2;
  __stcg(dst, make_float4(acc[0], acc[1], acc[2], acc[3]));
  __stcg(dst + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
  __threadfence();
  __syncwarp();
  int ticket = 0;
  if (lane == 0) {
    __threadfence();
    ticket = atomicAdd(a.tickets + t0, 1);
  }
  ticket = __shfl_sync(kFull, ticket, 0);
  if (ticket != t1 - t0) return;                 // not the last piece
  __threadfence();
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int tt = t0; tt <= t1; ++tt) {
    const int64_t sl = tt == t0 ? 2 * (int64_t)tt + 1 : 2 * (int64_t)tt;
    const float4* src =
        reinterpret_cast<const float4*>(a.partial + sl * kWidth) + lane * 2;
    const float4 x = __ldcg(src), y = __ldcg(src + 1);
    s[0] += x.x; s[1] += x.y; s[2] += x.z; s[3] += x.w;
    s[4] += y.x; s[5] += y.y; s[6] += y.z; s[7] += y.w;
  }
  finish_row<kApply>(a, row, s, lane);
}

// Sorted positions [t*tile, min((t+1)*tile, V)) of one warp. The slot ids
// and rows of the next 32 positions load while these 32 are summed, kAhead
// gradient rows at a time.
template <bool kApply>
__device__ __forceinline__ void reduce_tile(const Reduce& a, int t,
                                            int lane) {
  const int V = __ldg(a.offsets + a.table_rows);
  const int p0 = t * a.tile;
  if (p0 >= V) return;
  const int p1 = min(p0 + a.tile, V);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  constexpr int kAhead = kApply ? kAheadApply : kAheadAccum;
  int cur = -1;
  bool first = true;
  int slot_n = 0, key_n = -1;
  if (p0 + lane < p1) {
    slot_n = __ldg(a.order + p0 + lane);
    key_n = __ldg(a.rowkey + p0 + lane);
  }
  for (int pb = p0; pb < p1; pb += 32) {
    const int slot = slot_n, key = key_n;
    const int pn = pb + 32 + lane;
    slot_n = 0;
    key_n = -1;
    if (pn < p1) {
      slot_n = __ldg(a.order + pn);
      key_n = __ldg(a.rowkey + pn);
    }
    const int cnt = min(32, p1 - pb);
    for (int u0 = 0; u0 < cnt; u0 += kAhead) {
      uint4 q[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int s = __shfl_sync(kFull, slot, u0 + u);
        q[u] = make_uint4(0u, 0u, 0u, 0u);
        if (u0 + u < cnt) q[u] = __ldg(a.grad + (int64_t)s * 32 + lane);
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int k = __shfl_sync(kFull, key, u0 + u);
        if (u0 + u < cnt) {
          if (k != cur) {
            if (cur >= 0) {
              finish_segment<kApply>(a, t, p0, cur, acc, first, false, lane);
              first = false;
            }
            cur = k;
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = 0.f;
          }
          add_bf16x8(acc, q[u]);
        }
      }
    }
  }
  finish_segment<kApply>(a, t, p0, cur, acc, first, true, lane);
}

// B2: +0.0 into every row with no slot, 32 rows a warp step.
__device__ void zero_empty_rows(const Reduce& a, int64_t w, int64_t nw,
                                int lane) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t r0 = w * 32; r0 < a.table_rows; r0 += nw * 32) {
    const int64_t r = r0 + lane;
    const bool empty = r < a.table_rows &&
                       __ldg(a.offsets + r) == __ldg(a.offsets + r + 1);
    unsigned m = __ballot_sync(kFull, empty);
    while (m) {
      const int i = __ffs(m) - 1;
      m &= m - 1;
      float4* dst = reinterpret_cast<float4*>(a.G + (r0 + i) * kWidth) +
                    lane * 2;
      dst[0] = z;
      dst[1] = z;
    }
  }
}

// Blocks [0, tile_blocks) reduce tiles, kWarps a block; B2's blocks after
// those write the empty rows.
template <bool kApply>
__global__ void __launch_bounds__(kThreads,
                                  kApply ? kBlocksApply : kBlocksAccum)
reduce_kernel(Reduce a, int tile_blocks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < tile_blocks) {
    const int t = blockIdx.x * kWarps + warp;
    if (t < a.tiles) reduce_tile<kApply>(a, t, lane);
  } else if (!kApply) {
    zero_empty_rows(a, (int64_t)(blockIdx.x - tile_blocks) * kWarps + warp,
                    (int64_t)(gridDim.x - tile_blocks) * kWarps, lane);
  }
}

// The tail alone: a warp a row; rows whose G is +0.0 everywhere are left.
__global__ void __launch_bounds__(kThreads)
adagrad_tail_kernel(const float* __restrict__ G, Reduce a) {
  const int lane = threadIdx.x & 31;
  const int64_t nw = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       r < a.table_rows; r += nw) {
    const float4* gp =
        reinterpret_cast<const float4*>(G + r * kWidth) + lane * 2;
    const float4 x = __ldg(gp), y = __ldg(gp + 1);
    const float g[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
    unsigned bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) bits |= __float_as_uint(g[i]);
    if (!__any_sync(kFull, bits != 0)) continue;
    adagrad_row(a, r, g, lane);
  }
}

int allow_smem(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

int launch_reduce(bool apply, const Reduce& a, int zero_blocks,
                  cudaStream_t stream) {
  const int tile_blocks = (a.tiles + kWarps - 1) / kWarps;
  const int blocks = tile_blocks + (apply ? 0 : zero_blocks);
  if (blocks == 0) return 0;
  if (apply)
    reduce_kernel<true><<<blocks, kThreads, 0, stream>>>(a, tile_blocks);
  else
    reduce_kernel<false><<<blocks, kThreads, 0, stream>>>(a, tile_blocks);
  return (int)cudaGetLastError();
}

Reduce reduce_args(const int* order, const int* offsets, const int* rowkey,
                   const void* grad, float* partial, int* tickets,
                   int table_rows, int tile, int tiles) {
  Reduce a = {};
  a.order = order;
  a.offsets = offsets;
  a.rowkey = rowkey;
  a.grad = (const uint4*)grad;
  a.partial = partial;
  a.tickets = tickets;
  a.tile = tile;
  a.tiles = tiles;
  a.table_rows = table_rows;
  return a;
}

}  // namespace

// Stable bucketing of the F*n slots by table row f*MRF + rows[f, j]:
// order int32 [F*n], offsets int32 [F*MRF + 1], rowkey int32 [F*n] (each
// sorted position's table row, for the reduction), scratch counts int32
// [F*chunks, MRF+1] and dropped int32 [F*chunks]; tickets [n_tickets] is
// zeroed on the way (the reduction's). The plan (chunk, chunks, smem_keys,
// smem sizes) comes from ops/parts_scatter.py::_scatter_plan.
extern "C" int parts_row_bucket(const int* rows, int F, int n, int MRF,
                                int chunk, int chunks, int smem_keys,
                                int count_smem, int scatter_smem,
                                int* order, int* offsets, int* rowkey,
                                int* counts, int* dropped, int* tickets,
                                int n_tickets, void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  int rc;
  if ((rc = allow_smem((const void*)bucket_count_kernel, count_smem)))
    return rc;
  if ((rc = allow_smem((const void*)bucket_scatter_kernel, scatter_smem)))
    return rc;
  const int blocks = F * chunks;
  bucket_count_kernel<<<blocks, kThreads, count_smem, stream>>>(
      rows, n, MRF, chunk, chunks, counts, dropped, smem_keys, tickets,
      n_tickets);
  if ((rc = (int)cudaGetLastError())) return rc;
  bucket_scan_kernel<<<F, kScanThreads, 0, stream>>>(counts, dropped, n, MRF,
                                                      F, chunks, offsets);
  if ((rc = (int)cudaGetLastError())) return rc;
  bucket_scatter_kernel<<<blocks, kThreads, scatter_smem, stream>>>(
      rows, n, MRF, chunk, chunks, counts, smem_keys, order, rowkey);
  return (int)cudaGetLastError();
}

// B1 over parts_row_bucket's order/offsets/rowkey: each row's slot sum,
// AdaGrad applied to the rows that have a slot (T2, S2 in place).
extern "C" int parts_scatter_adagrad(const int* order, const int* offsets,
                                     const int* rowkey, const void* grad,
                                     float* partial, int* tickets, void* T2,
                                     float* S2, const float* lam8,
                                     const float* live8, float eta,
                                     int table_rows, int tile, int tiles,
                                     int lam_on, int cnt_col,
                                     void* stream_handle) {
  Reduce a = reduce_args(order, offsets, rowkey, grad, partial, tickets,
                         table_rows, tile, tiles);
  a.T2 = (__nv_bfloat16*)T2;
  a.S2 = S2;
  a.lam8 = lam8;
  a.live8 = live8;
  a.eta = eta;
  a.lam_on = lam_on;
  a.cnt_col = cnt_col;
  return launch_reduce(true, a, 0, (cudaStream_t)stream_handle);
}

// B2 over parts_row_bucket's order/offsets/rowkey: G [table_rows, 256]
// f32, every row written once (its slot sum, or +0.0).
extern "C" int parts_scatter_accum(const int* order, const int* offsets,
                                   const int* rowkey, const void* grad,
                                   float* partial, int* tickets, float* G,
                                   int table_rows, int tile, int tiles,
                                   int zero_blocks, void* stream_handle) {
  Reduce a = reduce_args(order, offsets, rowkey, grad, partial, tickets,
                         table_rows, tile, tiles);
  a.G = G;
  return launch_reduce(false, a, zero_blocks, (cudaStream_t)stream_handle);
}

// The tail alone over `table_rows` logical rows of a given G: the sharded
// step's optimizer after the dp sum of G, with B1's rounding.
extern "C" int parts_adagrad_tail(const float* G, void* T2, float* S2,
                                  const float* lam8, const float* live8,
                                  float eta, int table_rows, int lam_on,
                                  int cnt_col, int blocks,
                                  void* stream_handle) {
  if (table_rows == 0 || blocks == 0) return 0;
  Reduce a = {};
  a.table_rows = table_rows;
  a.T2 = (__nv_bfloat16*)T2;
  a.S2 = S2;
  a.lam8 = lam8;
  a.live8 = live8;
  a.eta = eta;
  a.lam_on = lam_on;
  a.cnt_col = cnt_col;
  adagrad_tail_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream_handle>>>(
      G, a);
  return (int)cudaGetLastError();
}
