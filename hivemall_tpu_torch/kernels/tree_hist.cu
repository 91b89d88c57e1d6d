// Level histograms of the tree builders, for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by kernels/build.py and called only through
// hivemall_tpu_torch/ops/hist.py, which also plans every launch of the
// flat and sorted kernels (node tile, feature group, rows a block, grid,
// shared memory) in plain Python.
//
// Every histogram kernel here computes the same function of one tree level:
//
//   out[node, f, b, s] = sum_r [bins[r, f] == b] * [loc[r] == node] * ws[r, s]
//
// Rows whose node id lies outside [0, M) and bin codes outside [0, B) (the
// -1 padding of rows and features) add nothing. The TPU kernels recast this
// sum as a one-hot matrix product (n*d*B*M*S multiply-adds) to feed the MXU;
// here it is computed directly, n*d*S adds, as shared-memory atomics into a
// block-private slice of the histogram that is then flushed into the output
// with global atomics.
//
// Replaces (hivemall_tpu/ops/pallas_hist.py):
//   hist_dense_int  <- _dense_kernel      (level_histogram_dense, fast=True)
//   hist_dense_f32  <- _dense_kernel_f32  (level_histogram_dense, fast=False)
//   hist_flat       <- _hist_kernel       (level_histogram)
//   hist_sorted     <- _windowed_kernel   (level_histogram_sorted)
// and node_bucket, the counting sort of rows by node that hist_sorted reads
// (the reference sorts with jnp.argsort outside its kernel).
//
// Shared memory does not hold a deep level: the random forest's deepest
// level (M=256 nodes, 28 features, B=64 bins, S=2 channels) is 3.7 MB a
// tree against 227 KB an SM. So each block owns a tile of the histogram
// that fits and reads only what falls into it:
//   - dense: a range of nodes x a group of features, every row's node id;
//   - flat: a range of whole nodes x a group of features; each warp reads
//     the node ids of its rows (coalesced), keeps the rows its tile owns in
//     a warp-private list (ballot), and only then reads those rows' codes,
//     a row's features on neighbouring lanes. No block reads the codes of a
//     row it does not own, so the codes are read once over all blocks;
//   - sorted: one node's slice of node-bucketed rows (never two nodes), a
//     group of features; each warp takes 32 bucketed rows, stages their row
//     ids and channels in shared memory once, then reads their codes as
//     whole rows.
// A shallow level is the other extreme: at M=1 every row lands on the same
// B bins of a feature, so the rows are split over about two blocks an SM,
// whose private copies take the collisions in shared memory; only the flush
// reaches device memory, once a block.
//
// Bin codes come as uint8 (what StagedMatrix keeps on the card) or int32;
// the flat and sorted kernels read either directly.
//
// Bound on an H100 SXM: bytes. At the forest's deepest level the function
// needs the bin codes at one byte each (28 MB for 1M rows x 28 features),
// the node ids and weights of 16 trees (192 MB) and writes 59 MB of
// histogram over the real features: about 0.083 ms at the data sheet's
// 3.35 TB/s; its 0.9 G adds take 0.013 ms at its 67 TFLOP/s float32. The
// dense kernels read the codes as int32 with padded features and rows (128
// MB, 4.6x the codes) and re-read the node ids once per node tile and
// feature group; the flat kernel re-reads the node ids (4 bytes a row) once
// per node tile, from L2 at a deep level. What holds the flat and sorted
// kernels back on an H100 is their adds, not their bytes: a float atomic
// add in shared memory is a compare-and-swap loop there (ATOMS.CAST.SPIN),
// so uint8 and int32 codes take about the same time, and more loads in
// flight a lane (16 instead of kAddAhead) made them no faster.
//
// Determinism: hist_dense_int accumulates in int32, so each partial sum is
// an integer and the float32 flush is exact in any order: its result is the
// same bit for bit on every run (sums below 2^24 a cell). The f32 kernels'
// atomics add in an order that changes from run to run, and node_bucket's
// order inside a node changes too (the histograms do not depend on it
// beyond that float order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// per-block shared memory aimed for, so that two blocks fit on an SM; a
// tile that needs more (one node x one feature x B x S) gets up to kSmemMax
constexpr int kSmemBudget = 96 * 1024;
constexpr int kSmemMax = 227 * 1024;
// The flat and sorted kernels: channels a launch (wider ws goes in slabs),
// rows of a warp's list (flat) and rows a warp stages at a time (sorted),
// node ids a lane loads ahead. ops/hist.py sizes shared memory from the
// first three: keep them equal to _SCH, _FLAT_LIST and _SORTED_BATCH.
constexpr int kSlab = 8;
constexpr int kFlatList = 64;
constexpr int kSortedBatch = 32;
constexpr int kLocAhead = 16;
constexpr int kAddAhead = 8;     // code loads a lane keeps in flight
// node_bucket: rows a thread takes in the count and scatter kernels
constexpr int kBucketItems = 8;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

template <typename Acc>
__device__ __forceinline__ Acc to_acc(float w);
template <>
__device__ __forceinline__ int to_acc<int>(float w) {
  return __float2int_rn(w);
}
template <>
__device__ __forceinline__ float to_acc<float>(float w) {
  return w;
}

template <typename Acc>
__device__ __forceinline__ void zero_shared(Acc* sh, int cells) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = Acc(0);
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// ---- dense, tree-batched (B3 with Acc=int, B4 with Acc=float) ----------
// bins_t int32 [dp, np_] (feature-major, so a warp reads 32 neighbouring
// rows of one feature), loc int32 [E, n], ws f32 [E, n, S],
// out f32 [E, M, dp, B, S]. Block (tile, row chunk); tile = (tree e, node
// tile nt, feature group fg); shared [nn][nf][B][S].
template <typename Acc>
__global__ void __launch_bounds__(kThreads)
dense_hist_kernel(const int* __restrict__ bins_t, const int* __restrict__ loc,
                  const float* __restrict__ ws, float* __restrict__ out,
                  int n, int64_t np_, int dp, int M, int B, int S, int NT,
                  int FG, int n_ntiles, int n_fgroups, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* sh = reinterpret_cast<Acc*>(smem_raw);
  const int fg = blockIdx.x % n_fgroups;
  const int rest = blockIdx.x / n_fgroups;
  const int nt = rest % n_ntiles;
  const int e = rest / n_ntiles;
  const int node0 = nt * NT, f0 = fg * FG;
  const int nn = min(NT, M - node0), nf = min(FG, dp - f0);
  const int cells = nn * nf * B * S;
  zero_shared(sh, cells);
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = min((int64_t)n, r0 + rows_per_block);
  const int* loc_e = loc + (int64_t)e * n;
  const float* ws_e = ws + (int64_t)e * n * S;
  const int* bins_f = bins_t + (int64_t)f0 * np_;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int l = __ldg(loc_e + r) - node0;
    if ((unsigned)l >= (unsigned)nn) continue;   // other tile, or inactive
    for (int f = 0; f < nf; ++f) {
      const int b = __ldg(bins_f + (int64_t)f * np_ + r);
      if ((unsigned)b >= (unsigned)B) continue;  // -1 padding
      Acc* cell = sh + ((l * nf + f) * B + b) * S;
      for (int s = 0; s < S; ++s) {
        const Acc w = to_acc<Acc>(__ldg(ws_e + r * S + s));
        if (w != Acc(0)) atomicAdd(cell + s, w);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const Acc v = sh[i];
    if (v == Acc(0)) continue;
    const int s = i % S;
    int j = i / S;
    const int b = j % B;
    j /= B;
    const int f = j % nf;
    const int l = j / nf;
    atomicAdd(out + ((((int64_t)e * M + node0 + l) * dp + f0 + f) * B + b) * S
                  + s,
              (float)v);
  }
}

// ---- the row kernels' common inner step ---------------------------------
// One warp adds `cnt` staged rows into the block's shared tile hist
// [nodes][nf][B][Sk]. rows/node/w are the warp's staged row ids,
// tile-local node ids (kNodes false: node 0) and channels [cnt][Sk]. Lanes
// hold features: a step covers 32/fw rows of fw = min(nf, 32) features, so the
// lanes of a step read neighbouring codes of a row (a row's d codes are
// contiguous in bins [n, d]) and no lane divides per code. Each lane
// issues kAddAhead code loads before its first add: the codes are gathers
// from device memory, and a warp that waited on each in turn would leave
// the SM idle.
template <typename Code, bool kNodes>
__device__ __forceinline__ void add_rows(
    float* hist, const Code* __restrict__ bins, const int* rows,
    const int* node, const float* w, int cnt, int d, int f0, int nf, int B,
    int Sk, int lane) {
  const int fw = min(nf, 32);
  const int rps = 32 / fw;                       // rows a step
  const int jr = lane / fw;
  const bool on = jr < rps;
  for (int f = lane - jr * fw; f < nf + 32 - fw; f += 32) {  // nf > 32: chunks
    const bool live = on && f < nf;
    for (int j0 = jr; j0 < cnt; j0 += rps * kAddAhead) {
      int code[kAddAhead];
#pragma unroll
      for (int u = 0; u < kAddAhead; ++u) {
        const int j = j0 + u * rps;
        code[u] = live && j < cnt
                      ? (int)__ldg(bins + (int64_t)rows[j] * d + f0 + f)
                      : -1;
      }
#pragma unroll
      for (int u = 0; u < kAddAhead; ++u) {
        if ((unsigned)code[u] >= (unsigned)B) continue;   // -1 padding
        const int j = j0 + u * rps;
        const int l = kNodes ? node[j] : 0;
        float* cell = hist + ((l * nf + f) * B + code[u]) * Sk;
        const float* wj = w + j * Sk;
        for (int s = 0; s < Sk; ++s) {
          const float v = wj[s];
          if (v != 0.0f) atomicAdd(cell + s, v);
        }
      }
    }
  }
}

// B5's list step: the listed rows' channels into w (independent loads,
// one wait), then add_rows.
template <typename Code>
__device__ __noinline__ void stage_and_add(
    float* hist, const Code* __restrict__ bins, const float* __restrict__ ws,
    const int* rows, const int* node, float* w, int cnt, int d, int S,
    int c0, int f0, int nf, int B, int Sk, int lane) {
  __syncwarp();
  for (int i = lane; i < cnt * Sk; i += 32)
    w[i] = __ldg(ws + (int64_t)rows[i / Sk] * S + c0 + i % Sk);
  __syncwarp();
  add_rows<Code, true>(hist, bins, rows, node, w, cnt, d, f0, nf, B, Sk,
                       lane);
  __syncwarp();
}

// ---- flat (B5) ---------------------------------------------------------
// bins Code [n, d], loc int32 [n], ws f32 [n, S] (channels c0..c0+Sk of
// this launch), out f32 [M, d, B, S], zeroed before the first slab. Block
// (tile, row chunk); tile = (node tile nt of NT whole nodes, feature group
// fg of FG features). Shared: the tile [NT][FG][B][Sk], then each warp's
// list of kFlatList owned rows (row ids, tile-local nodes, channels).
template <typename Code>
__global__ void __launch_bounds__(kThreads, 2)
flat_hist_kernel(const Code* __restrict__ bins, const int* __restrict__ loc,
                 const float* __restrict__ ws, float* __restrict__ out,
                 int n, int d, int M, int B, int S, int c0, int Sk, int NT,
                 int FG, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_fgroups = (d + FG - 1) / FG;
  const int fg = blockIdx.x % n_fgroups;
  const int node0 = (blockIdx.x / n_fgroups) * NT, f0 = fg * FG;
  const int nn = min(NT, M - node0), nf = min(FG, d - f0);
  float* hist = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* rows = reinterpret_cast<int*>(hist + NT * FG * B * Sk) +
              warp * kFlatList;
  int* node = reinterpret_cast<int*>(hist + NT * FG * B * Sk) +
              kWarps * kFlatList + warp * kFlatList;
  float* w = reinterpret_cast<float*>(
                 reinterpret_cast<int*>(hist + NT * FG * B * Sk) +
                 2 * kWarps * kFlatList) + warp * kFlatList * Sk;
  const int cells = nn * nf * B * Sk;
  zero_shared(hist, cells);
  __syncthreads();
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_block;
  const int64_t r1 = min((int64_t)n, r0 + rows_per_block);
  constexpr int kStep = 32 * kLocAhead;
  int cnt = 0;                                   // warp-uniform
  // a step: the block's next kWarps * kStep rows, 32 at a time dealt to
  // the warps in turn, so that a short chunk still keeps every warp busy
  for (int64_t base = r0; base < r1; base += (int64_t)kWarps * kStep) {
    int l[kLocAhead];
#pragma unroll
    for (int it = 0; it < kLocAhead; ++it) {
      const int64_t r = base + (it * kWarps + warp) * 32 + lane;
      l[it] = r < r1 ? __ldg(loc + r) - node0 : -1;
    }
#pragma unroll
    for (int it = 0; it < kLocAhead; ++it) {
      const bool own = (unsigned)l[it] < (unsigned)nn;
      const unsigned m = __ballot_sync(kFull, own);
      if (own) {
        const int pos = cnt + __popc(m & lanes_below());
        rows[pos] = (int)(base + (it * kWarps + warp) * 32 + lane);
        node[pos] = l[it];
      }
      cnt += __popc(m);
      if (cnt >= 32) {                           // room for one more step
        stage_and_add(hist, bins, ws, rows, node, w, cnt, d, S, c0, f0, nf,
                      B, Sk, lane);
        cnt = 0;
      }
    }
  }
  stage_and_add(hist, bins, ws, rows, node, w, cnt, d, S, c0, f0, nf, B, Sk,
                lane);
  __syncthreads();
  // the tile [nn][nf][B][Sk] into out [M][d][B][S]
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = hist[i];
    if (v == 0.0f) continue;
    const int s = i % Sk;
    int j = i / Sk;
    const int b = j % B;
    j /= B;
    const int f = j % nf;
    const int ln = j / nf;
    atomicAdd(out + (((int64_t)(node0 + ln) * d + f0 + f) * B + b) * S + c0
                  + s,
              v);
  }
}

// ---- node-sorted (B6) --------------------------------------------------
// order int32 [n] and offsets int32 [M+2] from node_bucket (the rows of
// node k at order[offsets[k] .. offsets[k+1])), slice_start int32 [M+1]
// (slices before node k, slices of L rows), bins Code [n, d], ws f32
// [n, S] (channels c0..c0+Sk), out f32 [M, d, B, S], zeroed before.
// Block (slice, feature group): one slice of one node's rows. Shared: the
// node's [FG][B][Sk], then each warp's kSortedBatch staged row ids and
// channels.
template <typename Code>
__global__ void __launch_bounds__(kThreads, 2)
sorted_hist_kernel(const int* __restrict__ order,
                   const int* __restrict__ offsets,
                   const int* __restrict__ slice_start,
                   const Code* __restrict__ bins,
                   const float* __restrict__ ws, float* __restrict__ out,
                   int d, int M, int B, int S, int c0, int Sk, int FG, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int owner;
  const int sb = blockIdx.x;
  if (sb >= __ldg(slice_start + M)) return;      // grid is an upper bound
  if (threadIdx.x == 0) {     // the node k with slice_start[k] <= sb < [k+1]
    int lo = 0, hi = M;
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(slice_start + mid) <= sb) lo = mid; else hi = mid;
    }
    owner = lo;
  }
  float* hist = reinterpret_cast<float*>(smem_raw);
  const int f0 = blockIdx.y * FG, nf = min(FG, d - f0);
  const int cells = nf * B * Sk;
  zero_shared(hist, cells);
  __syncthreads();
  const int k = owner;
  const int p0 = __ldg(offsets + k) + (sb - __ldg(slice_start + k)) * L;
  const int p1 = min(__ldg(offsets + k + 1), p0 + L);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* rows =
      reinterpret_cast<int*>(hist + FG * B * Sk) + warp * kSortedBatch;
  float* w = reinterpret_cast<float*>(
                 reinterpret_cast<int*>(hist + FG * B * Sk) +
                 kWarps * kSortedBatch) + warp * kSortedBatch * Sk;
  for (int base = p0 + warp * kSortedBatch; base < p1;
       base += kWarps * kSortedBatch) {
    const int p = base + lane;
    if (p < p1) {
      const int row = __ldg(order + p);
      rows[lane] = row;
      for (int s = 0; s < Sk; ++s)
        w[lane * Sk + s] = __ldg(ws + (int64_t)row * S + c0 + s);
    }
    __syncwarp();
    add_rows<Code, false>(hist, bins, rows, nullptr, w, min(32, p1 - base),
                          d, f0, nf, B, Sk, lane);
    __syncwarp();
  }
  __syncthreads();
  // the node's [nf][B][Sk] into out[k][f0 .. f0+nf][B][S]
  float* dst = out + ((int64_t)k * d + f0) * B * S + c0;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.0f) atomicAdd(dst + (i / Sk) * S + i % Sk, v);
  }
}

// ---- node_bucket: counting sort of rows by node --------------------------
// key(r) = loc[r] for loc in [0, M), else M (inactive rows go last).
__device__ __forceinline__ int node_key(const int* __restrict__ loc,
                                        int64_t r, int n, int M) {
  if (r >= n) return -1;                         // past the end: no row
  const int l = __ldg(loc + r);
  return (unsigned)l < (unsigned)M ? l : M;
}

// Adds one for each lane's key into counts (shared or global) with one
// atomic for each distinct key of the warp; returns the lane's slot: the
// counter's old value plus the lane's rank among the warp's lanes of the
// same key. All 32 lanes call it; key -1 takes no slot.
__device__ __forceinline__ int warp_slot(int* counts, int key, int lane) {
  const unsigned peers = __match_any_sync(kFull, key);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader && key >= 0)
    base = atomicAdd(counts + key, __popc(peers));
  base = __shfl_sync(kFull, base, leader);
  return base + __popc(peers & lanes_below());
}

// Block (chunk of kThreads * kBucketItems rows). shared: per-block counts
// of M+1 keys, or none (smem_keys == 0: straight into global counts).
__global__ void __launch_bounds__(kThreads)
bucket_count_kernel(const int* __restrict__ loc, int n, int M,
                    int* __restrict__ counts, int smem_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sh = reinterpret_cast<int*>(smem_raw);
  const int lane = threadIdx.x & 31;
  int* tgt = smem_keys ? sh : counts;
  if (smem_keys) {
    zero_shared(sh, M + 1);
    __syncthreads();
  }
  const int64_t r0 = (int64_t)blockIdx.x * kThreads * kBucketItems;
#pragma unroll
  for (int it = 0; it < kBucketItems; ++it)
    warp_slot(tgt, node_key(loc, r0 + it * kThreads + threadIdx.x, n, M),
              lane);
  if (!smem_keys) return;
  __syncthreads();
  for (int k = threadIdx.x; k <= M; k += blockDim.x)
    if (sh[k]) atomicAdd(counts + k, sh[k]);
}

// The same chunks: each row's slot in its node's bucket, from one global
// atomic per (block, node) on cursor (the buckets' next free positions).
__global__ void __launch_bounds__(kThreads)
bucket_scatter_kernel(const int* __restrict__ loc, int n, int M,
                      int* __restrict__ cursor, int* __restrict__ order,
                      int smem_keys) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* sh = reinterpret_cast<int*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int64_t r0 = (int64_t)blockIdx.x * kThreads * kBucketItems;
  int key[kBucketItems], slot[kBucketItems];
  if (smem_keys) {
    zero_shared(sh, M + 1);
    __syncthreads();
  }
  int* tgt = smem_keys ? sh : cursor;
#pragma unroll
  for (int it = 0; it < kBucketItems; ++it) {
    key[it] = node_key(loc, r0 + it * kThreads + threadIdx.x, n, M);
    slot[it] = warp_slot(tgt, key[it], lane);
  }
  if (smem_keys) {               // block-local ranks -> global positions
    __syncthreads();
    for (int k = threadIdx.x; k <= M; k += blockDim.x)
      if (sh[k]) sh[k] = atomicAdd(cursor + k, sh[k]);
    __syncthreads();
  }
#pragma unroll
  for (int it = 0; it < kBucketItems; ++it) {
    if (key[it] < 0) continue;
    const int pos = smem_keys ? sh[key[it]] + slot[it] : slot[it];
    order[pos] = (int)(r0 + it * kThreads + threadIdx.x);
  }
}

// One block: incl[0] = 0, incl[i+1] = v(0) + ... + v(i) for i < len, and
// excl[i] = incl[i] when excl is given. v(i) = counts[i], or, with L > 0,
// the slices of L rows node i needs: ceil((counts[i+1]-counts[i]) / L)
// (counts then being offsets).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int len, int L,
            int* __restrict__ incl, int* __restrict__ excl) {
  __shared__ int sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x == 0) incl[0] = 0;
  int carry = 0;
  for (int base = 0; base < len; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int v = 0;
    if (i < len) {
      v = __ldg(counts + i);
      if (L > 0) v = (__ldg(counts + i + 1) - v + L - 1) / L;
    }
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
      sums[lane] = s;                            // inclusive over warps
    }
    __syncthreads();
    x += (warp ? sums[warp - 1] : 0) + carry;
    if (i < len) {
      incl[i + 1] = x;
      if (excl) excl[i] = x - v;
    }
    carry += sums[nw - 1];
    __syncthreads();                             // sums is reused
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     dev);
}

// Rows per block such that about 8 blocks an SM are in flight over all
// tiles, but no block takes fewer than 256 rows and gridDim.y stays legal.
int64_t rows_per_block(int64_t n, int64_t tiles, int sms) {
  const int64_t target = (int64_t)sms * 8;
  int64_t chunks = (target + tiles - 1) / tiles;
  const int64_t most = (n + 255) / 256;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  int64_t rpb = (n + chunks - 1) / chunks;
  if ((n + rpb - 1) / rpb > 65535) rpb = (n + 65534) / 65535;
  return rpb < 1 ? 1 : rpb;
}

template <typename Acc>
int launch_dense(const int* bins_t, const int* loc, const float* ws,
                 float* out, int E, int n, int64_t np_, int dp, int M, int B,
                 int S, cudaStream_t stream) {
  const size_t out_bytes = (size_t)E * M * dp * B * S * sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  if (n == 0 || E == 0) return 0;
  const int64_t per_node = (int64_t)B * S;       // one node x one feature
  if (per_node * (int64_t)sizeof(Acc) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const int64_t budget = kSmemBudget / (int64_t)sizeof(Acc);
  int64_t n_ntiles = (M * per_node + budget - 1) / budget;
  if (n_ntiles > M) n_ntiles = M;
  const int64_t NT = (M + n_ntiles - 1) / n_ntiles;
  n_ntiles = (M + NT - 1) / NT;
  int64_t FG = budget / (NT * per_node);
  if (FG < 1) FG = 1;
  if (FG > dp) FG = dp;
  const int64_t n_fgroups = (dp + FG - 1) / FG;
  const size_t smem = (size_t)(NT * FG * per_node) * sizeof(Acc);
  int sms = 0;
  if ((err = (cudaError_t)sm_count(&sms)) != cudaSuccess) return (int)err;
  const int64_t tiles = (int64_t)E * n_ntiles * n_fgroups;
  const int64_t rpb = rows_per_block(n, tiles, sms);
  const int64_t chunks = (n + rpb - 1) / rpb;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(dense_hist_kernel<Acc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_hist_kernel<Acc><<<dim3((unsigned)tiles, (unsigned)chunks), kThreads,
                           smem, stream>>>(
      bins_t, loc, ws, out, n, np_, dp, M, B, S, (int)NT, (int)FG,
      (int)n_ntiles, (int)n_fgroups, (int)rpb);
  return (int)cudaGetLastError();
}

template <typename K>
int allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename Code>
int launch_flat(const Code* bins, const int* loc, const float* ws,
                float* out, int n, int d, int M, int B, int S, int c0, int Sk,
                int NT, int FG, int rows, int grid_x, int grid_y, int smem,
                cudaStream_t stream) {
  int err;
  if (c0 == 0 && (err = (int)cudaMemsetAsync(
                      out, 0, (size_t)M * d * B * S * sizeof(float), stream)))
    return err;
  if ((err = allow_smem(flat_hist_kernel<Code>, smem))) return err;
  flat_hist_kernel<Code><<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
      bins, loc, ws, out, n, d, M, B, S, c0, Sk, NT, FG, rows);
  return (int)cudaGetLastError();
}

template <typename Code>
int launch_sorted(const int* order, const int* offsets, int* slice_start,
                  const Code* bins, const float* ws, float* out, int d,
                  int M, int B, int S, int FG, int L, int grid_x, int grid_y,
                  int smem, cudaStream_t stream) {
  int err = (int)cudaMemsetAsync(out, 0, (size_t)M * d * B * S * sizeof(float),
                                 stream);
  if (err) return err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(offsets, M, L, slice_start,
                                               nullptr);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = allow_smem(sorted_hist_kernel<Code>, smem))) return err;
  for (int c0 = 0; c0 < S; c0 += kSlab) {
    const int Sk = S - c0 < kSlab ? S - c0 : kSlab;
    sorted_hist_kernel<Code><<<dim3(grid_x, grid_y), kThreads, smem,
                               stream>>>(order, offsets, slice_start, bins,
                                         ws, out, d, M, B, S, c0, Sk, FG, L);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

}  // namespace

extern "C" int hist_dense_int(const int* bins_t, const int* loc,
                              const float* ws, float* out, int E, int n,
                              long long np_, int dp, int M, int B, int S,
                              void* stream) {
  return launch_dense<int>(bins_t, loc, ws, out, E, n, (int64_t)np_, dp, M,
                           B, S, (cudaStream_t)stream);
}

extern "C" int hist_dense_f32(const int* bins_t, const int* loc,
                              const float* ws, float* out, int E, int n,
                              long long np_, int dp, int M, int B, int S,
                              void* stream) {
  return launch_dense<float>(bins_t, loc, ws, out, E, n, (int64_t)np_, dp, M,
                             B, S, (cudaStream_t)stream);
}

// B5, channels c0..c0+Sk of ws [n, S] into out [M, d, B, S] (zeroed here
// when c0 == 0); code_bytes 1 (uint8 codes) or 4 (int32). The plan (NT,
// FG, rows, grid, smem) comes from ops/hist.py::_flat_plan.
extern "C" int hist_flat(const void* bins, int code_bytes, const int* loc,
                         const float* ws, float* out, int n, int d, int M,
                         int B, int S, int c0, int Sk, int NT, int FG,
                         int rows, int grid_x, int grid_y, int smem,
                         void* stream) {
  if (code_bytes == 1)
    return launch_flat((const uint8_t*)bins, loc, ws, out, n, d, M, B, S, c0,
                       Sk, NT, FG, rows, grid_x, grid_y, smem,
                       (cudaStream_t)stream);
  if (code_bytes == 4)
    return launch_flat((const int*)bins, loc, ws, out, n, d, M, B, S, c0, Sk,
                       NT, FG, rows, grid_x, grid_y, smem,
                       (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// B6 over node_bucket's order/offsets: out [M, d, B, S] zeroed, the slice
// scan into slice_start [M+1], then one launch per slab of kSlab channels.
// The plan (FG, L, grid, smem) comes from ops/hist.py::_sorted_plan.
extern "C" int hist_sorted(const int* order, const int* offsets,
                           int* slice_start, const void* bins,
                           int code_bytes, const float* ws, float* out,
                           int d, int M, int B, int S, int FG, int L,
                           int grid_x, int grid_y, int smem,
                           void* stream) {
  if (code_bytes == 1)
    return launch_sorted(order, offsets, slice_start, (const uint8_t*)bins,
                         ws, out, d, M, B, S, FG, L, grid_x, grid_y, smem,
                         (cudaStream_t)stream);
  if (code_bytes == 4)
    return launch_sorted(order, offsets, slice_start, (const int*)bins, ws,
                         out, d, M, B, S, FG, L, grid_x, grid_y, smem,
                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

// Counting sort of the rows by node: order int32 [n] (rows of node k at
// order[offsets[k] .. offsets[k+1]), rows outside [0, M) last, in no set
// order inside a node), offsets int32 [M+2]; scratch int32 [2*(M+1)].
// smem_keys: 0 counts in global memory, else (M+1) ints a block.
extern "C" int node_bucket(const int* loc, int n, int M, int* order,
                           int* offsets, int* scratch, int blocks,
                           int smem_keys, void* stream_handle) {
  cudaStream_t stream = (cudaStream_t)stream_handle;
  int* counts = scratch;
  int* cursor = scratch + (M + 1);
  cudaError_t err =
      cudaMemsetAsync(counts, 0, (size_t)(M + 1) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_keys ? (M + 1) * (int)sizeof(int) : 0;
  int rc;
  if ((rc = allow_smem(bucket_count_kernel, smem))) return rc;
  if ((rc = allow_smem(bucket_scatter_kernel, smem))) return rc;
  if (blocks > 0) {
    bucket_count_kernel<<<blocks, kThreads, smem, stream>>>(loc, n, M, counts,
                                                            smem_keys);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, M + 1, 0, offsets,
                                               cursor);
  if ((rc = (int)cudaGetLastError())) return rc;
  if (blocks > 0) {
    bucket_scatter_kernel<<<blocks, kThreads, smem, stream>>>(
        loc, n, M, cursor, order, smem_keys);
    if ((rc = (int)cudaGetLastError())) return rc;
  }
  return 0;
}
