// The device scans of the port's kernels.
//
// * A single-pass stable compaction over tiles (`start_order`,
//   `tile_ranks`, `look_back`): each tile ranks its flags with ballots
//   and takes its exclusive prefix from the tiles before it by
//   decoupled look-back, the tiles numbered in the order their blocks
//   start, so a tile only ever waits on tiles already running.  K9's
//   stage (ell_chain.cu) and K4's repack (livefirst_repack.cu) build on
//   it.
// * The three-pass count of byte flags (`scan`: per-tile counts, one
//   block scanning the tile counts, per-tile scan and apply), with no
//   atomics, so the positions it gives are stable by construction; K1's
//   row planner (lmm_round.cu) runs it.  K14's block arm runs the same
//   passes over the rows of a float table (`lane_scan`).

#pragma once

#include "common.cuh"

namespace {

#define SCAN_TB 256
#define SCAN_IPT 8
#define SCAN_TILE (SCAN_TB * SCAN_IPT)

// ---- the single-pass compaction ----

// The tile number in the order the blocks start (counter after the
// status words), broadcast to the block.
__device__ __forceinline__ int start_order(unsigned long long* counter) {
  __shared__ int tile;
  if (threadIdx.x == 0) tile = (int)atomicAdd(counter, 1ULL);
  __syncthreads();
  return tile;
}

// The ranks of a tile's flags: element (k, t) of the tile is its
// k * blockDim.x + t-th (thread t holds IPT elements a blockDim apart, so
// the block reads consecutive addresses); ex[k] receives the number of
// set flags before element (k, t) in the tile, *total the tile's count.
// Ballots count within warps; one warp scans the (k, warp) counts.
template <int IPT>
__device__ __forceinline__ void tile_ranks(const bool (&f)[IPT],
                                           int (&ex)[IPT], int* total) {
  __shared__ int wc[IPT * 32];
  __shared__ int tot;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  unsigned lt = (1u << lane) - 1u;
  unsigned b[IPT];
  for (int k = 0; k < IPT; ++k) {
    b[k] = __ballot_sync(FULL_MASK, f[k]);
    if (lane == 0) wc[k * nw + wid] = __popc(b[k]);
  }
  __syncthreads();
  if (wid == 0) {
    int n = IPT * nw, carry = 0;
    for (int base = 0; base < n; base += 32) {
      int i = base + lane;
      int v = i < n ? wc[i] : 0;
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        int y = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += y;
      }
      if (i < n) wc[i] = carry + incl - v;
      carry += __shfl_sync(FULL_MASK, incl, 31);
    }
    if (lane == 0) tot = carry;
  }
  __syncthreads();
  for (int k = 0; k < IPT; ++k) ex[k] = wc[k * nw + wid] + __popc(b[k] & lt);
  *total = tot;
}

// Decoupled look-back, by warp 0 of the tile's block: publish the
// tile's count, then read the status words of the 32 tiles before it at
// once (each lane spins until its word is written), add the counts down
// to the nearest tile that holds its inclusive prefix (and that prefix),
// and go on 32 tiles further down if none does; publish this tile's
// prefix.  Returns the exclusive prefix (in every lane).  A status word
// is (flag << 62) | count, flag 1 a tile's own count and 2 its inclusive
// prefix; 0 not yet written.  The caller zeroes the words (and the start
// counter after them) before their next use, in a later pass.
__device__ int look_back(unsigned long long* st, int tile, int agg,
                         int lane) {
  const unsigned long long AGG = 1ULL << 62, PRE = 2ULL << 62;
  if (tile == 0) {
    if (lane == 0) atomicExch(st, PRE | (unsigned)agg);
    return 0;
  }
  if (lane == 0) atomicExch(st + tile, AGG | (unsigned)agg);
  int ex = 0;
  for (int top = tile - 1;; top -= 32) {
    int t = top - lane;
    unsigned long long w = PRE;  // before the first tile: a prefix of 0
    if (t >= 0) {
      volatile unsigned long long* p = st + t;
      do {
        w = *p;
      } while (w == 0);
    }
    unsigned pre = __ballot_sync(FULL_MASK, (w >> 62) == 2);
    int stop = pre ? __ffs(pre) - 1 : 31;
    ex += warp_sum(lane <= stop ? (int)(unsigned)w : 0);
    if (pre) break;
  }
  if (lane == 0) atomicExch(st + tile, PRE | (unsigned)(ex + agg));
  return ex;
}

// One tile of a single-pass stable compaction over n flags, for a block
// of IPT * blockDim.x elements: the tile's number (in start order, from
// the counter at st[tiles]), each element's exclusive rank in ex[k] and
// the tile's exclusive prefix in *base (every thread), the tile's count
// in *agg.  `flag(i)` gives element i's flag (called for i < n only).
// The block's threads all call it.
template <int IPT, class F>
__device__ __forceinline__ int compact_tile(unsigned long long* st,
                                            int tiles, int n, F flag,
                                            bool (&f)[IPT], int (&ex)[IPT],
                                            int* base, int* agg) {
  __shared__ int b;
  int tile = start_order(st + tiles);
  int lo = tile * IPT * (int)blockDim.x + threadIdx.x;
  for (int k = 0; k < IPT; ++k) {
    int i = lo + k * (int)blockDim.x;
    f[k] = i < n && flag(i);
  }
  tile_ranks<IPT>(f, ex, agg);
  if (threadIdx.x < 32) {
    int x = look_back(st, tile, *agg, threadIdx.x);
    if (threadIdx.x == 0) b = x;
  }
  __syncthreads();
  *base = b;
  return tile;
}

__global__ void scan_count(int n, const uint8_t* __restrict__ f, int* bsum) {
  int lo = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_IPT;
  int c = 0;
  for (int i = lo; i < lo + SCAN_IPT && i < n; ++i) c += f[i];
  int tot = block_sum(c);
  if (threadIdx.x == 0) bsum[blockIdx.x] = tot;
}

__global__ void scan_blocks(int nb, int* bsum, int* total) {
  int carry = 0;
  for (int base = 0; base < nb; base += blockDim.x) {
    int i = base + threadIdx.x;
    int v = i < nb ? bsum[i] : 0;
    int tot;
    int ex = block_exclusive_scan(v, &tot);
    if (i < nb) bsum[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
}

__global__ void scan_apply(int n, const uint8_t* __restrict__ f,
                           const int* __restrict__ boff, int* out) {
  int lo = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_IPT;
  int c = 0;
  for (int i = lo; i < lo + SCAN_IPT && i < n; ++i) c += f[i];
  int tot;
  int off = boff[blockIdx.x] + block_exclusive_scan(c, &tot);
  for (int i = lo; i < lo + SCAN_IPT && i < n; ++i) {
    out[i] = off;
    off += f[i];
  }
}

// exclusive prefix count of `f` into `out`, total into *total
void scan(int n, const uint8_t* f, int* out, int* bsum, int* total,
          cudaStream_t s) {
  int nb = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (nb == 0) {
    cudaMemsetAsync(total, 0, sizeof(int), s);
    return;
  }
  scan_count<<<nb, SCAN_TB, 0, s>>>(n, f, bsum);
  scan_blocks<<<1, 1024, 0, s>>>(nb, bsum, total);
  scan_apply<<<nb, SCAN_TB, 0, s>>>(n, f, bsum, out);
}

// ---- a row-wise inclusive scan of T over [R, W] (K14's block arm) ----
// The same three passes over tiles of SCAN_TILE lanes of each row (grid
// (tiles, R)): per-tile totals, one block scanning each row's tile
// totals, and per-tile scan and apply.  OP 0 is the sum (round to
// nearest; its order is the tiles', not a left fold's), OP 1 the
// minimum (exact in any order).

template <typename T, int OP>
__device__ __forceinline__ T scan_op(T a, T b) {
  return OP == 0 ? add_rn(a, b) : min_v(a, b);
}

template <typename T, int OP>
__device__ __forceinline__ T scan_ident() {
  return OP == 0 ? T(0) : inf_v<T>();
}

// Exclusive scan of one T per thread over the block, in thread order;
// *total receives the block's fold (all threads).
template <typename T, int OP>
__device__ __forceinline__ T block_exclusive_scan_t(T v, T* total) {
  __shared__ T warp_tot[32];
  __shared__ T tot;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const T id = scan_ident<T, OP>();
  T incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl = scan_op<T, OP>(y, incl);
  }
  T ex = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) ex = id;
  __syncthreads();
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int nw = blockDim.x >> 5;
    T w = lane < nw ? warp_tot[lane] : id;
    T wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi = scan_op<T, OP>(y, wi);
    }
    T wex = __shfl_up_sync(FULL_MASK, wi, 1);
    if (lane == 0) wex = id;
    if (lane < nw) warp_tot[lane] = wex;
    if (lane == 31) tot = wi;
  }
  __syncthreads();
  T out = wid == 0 ? ex : scan_op<T, OP>(warp_tot[wid], ex);
  *total = tot;
  __syncthreads();
  return out;
}

template <typename T, int OP>
__device__ __forceinline__ T tile_fold(const T* row, int W, int lo) {
  T a = scan_ident<T, OP>();
  for (int i = lo; i < lo + SCAN_IPT && i < W; ++i)
    a = scan_op<T, OP>(a, row[i]);
  return a;
}

template <typename T, int OP>
__global__ void lscan_count(int W, const T* __restrict__ x, T* tsum) {
  int nt = gridDim.x;
  const T* row = x + (long long)blockIdx.y * W;
  T a = tile_fold<T, OP>(row, W, blockIdx.x * SCAN_TILE +
                                     threadIdx.x * SCAN_IPT);
  T tot;
  block_exclusive_scan_t<T, OP>(a, &tot);
  if (threadIdx.x == 0) tsum[(long long)blockIdx.y * nt + blockIdx.x] = tot;
}

template <typename T, int OP>
__global__ void lscan_blocks(int nt, T* tsum) {
  T* t = tsum + (long long)blockIdx.x * nt;
  T carry = scan_ident<T, OP>();
  for (int base = 0; base < nt; base += blockDim.x) {
    int i = base + threadIdx.x;
    T v = i < nt ? t[i] : scan_ident<T, OP>();
    T tot;
    T ex = block_exclusive_scan_t<T, OP>(v, &tot);
    if (i < nt) t[i] = scan_op<T, OP>(carry, ex);
    carry = scan_op<T, OP>(carry, tot);
  }
}

template <typename T, int OP>
__global__ void lscan_apply(int W, const T* __restrict__ x,
                            const T* __restrict__ toff, T* out) {
  int nt = gridDim.x;
  long long r0 = (long long)blockIdx.y * W;
  int lo = blockIdx.x * SCAN_TILE + threadIdx.x * SCAN_IPT;
  T a = tile_fold<T, OP>(x + r0, W, lo);
  T tot;
  T ex = block_exclusive_scan_t<T, OP>(a, &tot);
  T off = scan_op<T, OP>(toff[(long long)blockIdx.y * nt + blockIdx.x], ex);
  for (int i = lo; i < lo + SCAN_IPT && i < W; ++i) {
    off = scan_op<T, OP>(off, x[r0 + i]);
    out[r0 + i] = off;
  }
}

// inclusive scan of each row of x [R, W] into out; tsum holds R x
// ceil(W / SCAN_TILE) values of scratch
template <typename T, int OP>
int lane_scan(int R, int W, const T* x, T* out, T* tsum, cudaStream_t s) {
  int nt = (W + SCAN_TILE - 1) / SCAN_TILE;
  if (R < 1 || R > 65535 || nt < 1) return (int)cudaErrorInvalidValue;
  dim3 g(nt, R);
  lscan_count<T, OP><<<g, SCAN_TB, 0, s>>>(W, x, tsum);
  lscan_blocks<T, OP><<<R, 1024, 0, s>>>(nt, tsum);
  lscan_apply<T, OP><<<g, SCAN_TB, 0, s>>>(W, x, tsum, out);
  return (int)cudaGetLastError();
}

}  // namespace
