// K13 probe_segsum: the segment reduction out[c] = sum (or min) of w[i]
// over the elements i with idx[i] == c, for one or a few channels
// (w [n, ch] -> out [C, ch]).
//
// Replaces: P2 tools/tpu_pallas_probe.py `sk` (:80,
// `zeros(C).at[idx].add(w)` inside a kernel) and P7
// tools/tpu_pallas_gather3.py `mk` (:109, the same sum as a one-hot
// matmul over 1,024-element chunks), and the XLA scatters of
// tools/tpu_opcost.py (`scatter_add`, `scatter_min`, `scatter_add3`,
// `seg_sum_sorted`, `seg_min_sorted`).
//
// What bounds it on this card: bytes, then the conflicts.  Each element
// reads a 4-byte index and its weights once; the C totals are written
// once.  Many elements land on one row (32 on average at the probes'
// shapes), so the ways the arms resolve those collisions are the
// question the probe asks.
//
// What the design does about it: three arms.
//   atomic (arm 0): one global atomicAdd per element and channel into
//     the zeroed totals.  The order of the adds changes from run to run,
//     so it is held to a tolerance, never by bits.
//   smem_atomic (arm 1): every block privatises the C x ch totals in
//     dynamic shared memory (shared-memory atomics), then flushes its
//     nonzero totals with one global atomicAdd each.  Also unordered.
//   inorder (arm 2): one warp per row over a CSR that lists each row's
//     elements in increasing element order (ops/csr.py `build_csr`,
//     built by the caller outside any timed window): the warp loads 32
//     entries at once and folds them one by one in lane order with
//     round-to-nearest adds.  That is np.add.at's order and rounding,
//     so it equals np.add.at (and XLA:CPU's scatter) by bits; it is the
//     fold the port's ordered sums use.  It also takes the minimum
//     (op 1; exact in any order).

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T fold(int op, T a, T b) {
  return op == 0 ? add_rn(a, b) : min_v(a, b);
}

template <typename T>
__global__ void seg_atomic(long long n, int ch, const int* __restrict__ idx,
                           const T* __restrict__ w, T* out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    long long r = (long long)idx[i] * ch;
    for (int k = 0; k < ch; ++k) atomicAdd(out + r + k, w[i * ch + k]);
  }
}

template <typename T>
__global__ void seg_smem_atomic(long long n, int c, int ch,
                                const int* __restrict__ idx,
                                const T* __restrict__ w, T* out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  int m = c * ch;
  for (int j = threadIdx.x; j < m; j += blockDim.x) s[j] = T(0);
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x) {
    int r = idx[i] * ch;
    for (int k = 0; k < ch; ++k) atomicAdd(s + r + k, w[i * ch + k]);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x)
    if (s[j] != T(0)) atomicAdd(out + j, s[j]);
}

template <typename T>
__global__ void seg_inorder(int c, int ch, int op,
                            const int* __restrict__ c_ptr,
                            const int* __restrict__ c_idx,
                            const T* __restrict__ w, T* out) {
  int lane = threadIdx.x & 31;
  int warps = (gridDim.x * blockDim.x) >> 5;
  T ident = op == 0 ? T(0) : inf_v<T>();
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; r < c;
       r += warps) {
    int beg = c_ptr[r], end = c_ptr[r + 1];
    for (int k = 0; k < ch; ++k) {
      T acc = ident;
      for (int base = beg; base < end; base += 32) {
        int j = base + lane;
        T x = j < end ? w[(long long)c_idx[j] * ch + k] : ident;
        int cnt = min(32, end - base);
        for (int l = 0; l < cnt; ++l)
          acc = fold(op, acc, __shfl_sync(FULL_MASK, x, l));
      }
      if (lane == 0) out[(long long)r * ch + k] = acc;
    }
  }
}

const int TB = 256;

template <typename T>
int launch(int arm, int op, long long n, int c, int ch, const int* idx,
           const T* w, const int* c_ptr, const int* c_idx, T* out,
           cudaStream_t s) {
  if (arm == 2) {
    seg_inorder<T><<<grid_for((long long)c * 32, TB), TB, 0, s>>>(
        c, ch, op, c_ptr, c_idx, w, out);
    return (int)cudaGetLastError();
  }
  if (op != 0) return (int)cudaErrorInvalidValue;  // atomics add only
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)c * ch * sizeof(T), s);
  if (e != cudaSuccess) return (int)e;
  if (arm == 0) {
    seg_atomic<T><<<grid_for(n, TB), TB, 0, s>>>(n, ch, idx, w, out);
    return (int)cudaGetLastError();
  }
  size_t bytes = (size_t)c * ch * sizeof(T);
  int dev = 0, lim = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)lim) return (int)cudaErrorInvalidValue;
  static size_t last_bytes = 0;
  static int last_grid = 0;
  if (bytes != last_bytes) {
    e = cudaFuncSetAttribute(seg_smem_atomic<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, seg_smem_atomic<T>, TB, bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    last_bytes = bytes;
    last_grid = per_sm * sm_count();
  }
  long long need = (n + TB - 1) / TB;
  int g = need < last_grid ? (int)(need > 0 ? need : 1) : last_grid;
  seg_smem_atomic<T><<<g, TB, bytes, s>>>(n, c, ch, idx, w, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dbl: float64 (1) or float32 (0); arm: 0 atomic, 1 smem_atomic,
// 2 inorder; op: 0 sum, 1 min (inorder only); n elements of idx (each in
// [0, c)) and of w [n, ch]; out [c, ch].  c_ptr [c+1] / c_idx: the CSR of
// the inorder arm (NULL for the others).
extern "C" int probe_segsum(int dbl, int arm, int op, long long n, int c,
                            int ch, const void* idx, const void* w,
                            const void* c_ptr, const void* c_idx, void* out,
                            void* stream) {
  if (arm < 0 || arm > 2 || op < 0 || op > 1 || c < 1 || ch < 1)
    return (int)cudaErrorInvalidValue;
  if (arm == 2 && (c_ptr == nullptr || c_idx == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    return launch<double>(arm, op, n, c, ch, (const int*)idx,
                          (const double*)w, (const int*)c_ptr,
                          (const int*)c_idx, (double*)out, s);
  return launch<float>(arm, op, n, c, ch, (const int*)idx, (const float*)w,
                       (const int*)c_ptr, (const int*)c_idx, (float*)out, s);
}
