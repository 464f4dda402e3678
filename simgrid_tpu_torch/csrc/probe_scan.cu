// K14 probe_scan: the inclusive scan of each row of x [R, W] along its
// lanes (a cumulative sum, or a cumulative minimum).
//
// Replaces: P6 tools/tpu_pallas_gather3.py `ck` (:93, `jnp.cumsum(w,
// axis=1)` over [32, 16384] inside a kernel) and the XLA scans
// `cumsum_E` / `cummin_E` of tools/tpu_opcost.py (one row of 524,288).
//
// What bounds it on this card: bytes (each value read once and written
// once); for few long rows, the length of the dependency chain.
//
// What the design does about it: two arms.
//   seq (arm 0): one thread per row folds the row from left to right
//     with round-to-nearest adds: np.cumsum's order and rounding, so it
//     equals np.cumsum by bits.  Its time is the chain of W dependent
//     adds: fine for 32 rows of 16,384, a single thread for one row.
//   block (arm 1): the three passes of csrc/scan.cuh's `lane_scan`
//     (per-tile totals, a scan of each row's tile totals, per-tile scan
//     and apply), every row's tiles in parallel.  The sum's order is the
//     tiles' (a thread's 8 lanes, then the warps, then the tiles), so it
//     is held to a tolerance; the minimum is exact.

#include "scan.cuh"

namespace {

// A thread loads SEQ_BATCH lanes ahead of its fold, so that the loads'
// latency is paid once a batch rather than once a lane.
#define SEQ_BATCH 16

template <typename T, int OP>
__global__ void scan_seq(int R, int W, const T* __restrict__ x,
                         T* __restrict__ out) {
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < R;
       r += gridDim.x * blockDim.x) {
    const T* row = x + (long long)r * W;
    T* o = out + (long long)r * W;
    T a = scan_ident<T, OP>();
    int j = 0;
    for (; j + SEQ_BATCH <= W; j += SEQ_BATCH) {
      T v[SEQ_BATCH];
#pragma unroll
      for (int k = 0; k < SEQ_BATCH; ++k) v[k] = row[j + k];
#pragma unroll
      for (int k = 0; k < SEQ_BATCH; ++k) {
        a = scan_op<T, OP>(a, v[k]);
        o[j + k] = a;
      }
    }
    for (; j < W; ++j) {
      a = scan_op<T, OP>(a, row[j]);
      o[j] = a;
    }
  }
}

template <typename T, int OP>
int launch(int arm, int R, int W, const void* x, void* out, void* tsum,
           cudaStream_t s) {
  if (arm == 0) {
    const int TB = 128;
    scan_seq<T, OP><<<grid_for(R, TB), TB, 0, s>>>(R, W, (const T*)x,
                                                   (T*)out);
    return (int)cudaGetLastError();
  }
  return lane_scan<T, OP>(R, W, (const T*)x, (T*)out, (T*)tsum, s);
}

}  // namespace

// dbl: float64 (1) or float32 (0); arm: 0 seq, 1 block; op: 0 sum,
// 1 min; x and out [R, W] row-major; tsum: R * ceil(W / 2048) values of
// scratch for the block arm (NULL for seq).
extern "C" int probe_scan(int dbl, int arm, int op, int R, int W,
                          const void* x, void* out, void* tsum,
                          void* stream) {
  if (arm < 0 || arm > 1 || op < 0 || op > 1 || R < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0 || W == 0) return 0;
  if (arm == 1 && tsum == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    return op == 0 ? launch<double, 0>(arm, R, W, x, out, tsum, s)
                   : launch<double, 1>(arm, R, W, x, out, tsum, s);
  return op == 0 ? launch<float, 0>(arm, R, W, x, out, tsum, s)
                 : launch<float, 1>(arm, R, W, x, out, tsum, s);
}
