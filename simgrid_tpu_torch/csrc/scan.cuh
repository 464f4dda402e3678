// The stable three-pass device scan shared by K4 (the drain's
// live-first repack) and K9 (the ELL compaction chain's stage
// partition): per-tile counts, one block scanning the tile counts,
// per-tile scan and apply, over byte flags, with no atomics, so the
// positions it gives are stable by construction.  K14's block arm runs
// the same passes over the rows of a float table (`lane_scan`).

#pragma once

#include "common.cuh"

namespace {

#define SCAN_TB 256
#define SCAN_IPT 8
#define SCAN_TILE (SCAN_TB * SCAN_IPT)

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
