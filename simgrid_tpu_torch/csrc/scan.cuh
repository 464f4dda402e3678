// The stable three-pass device scan shared by K4 (the drain's
// live-first repack) and K9 (the ELL compaction chain's stage
// partition): per-tile counts, one block scanning the tile counts,
// per-tile scan and apply, over byte flags, with no atomics, so the
// positions it gives are stable by construction.

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

}  // namespace
