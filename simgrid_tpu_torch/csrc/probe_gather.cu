// K12 probe_gather: out[i] = tab[idx[i]] over a flat index.
//
// Replaces: the gathers of the Pallas probes, P1 tools/tpu_pallas_probe.py
// `gk` (:59, `jnp.take(tab, idx [V, 4])` in VMEM), P4
// tools/tpu_pallas_gather2.py `buildA`-`buildD` (:69/81/93/106: the same
// gather as a take_along_axis on a broadcast [8, C] or [64, C] table, a
// row gather from [C, 1], and an axis-0 take_along_axis on [C, 128]) and
// P5 tools/tpu_pallas_gather3.py `k` (:69, at table widths 128, 2048 and
// 16384), and the XLA gathers `gather_flat_E` / `gather_2d_V4` of
// tools/tpu_opcost.py.  P4's four forms and P5's widths are layouts of
// the index over one function; on this card the layout is only the
// order in which the flat index is walked, so one kernel serves them all.
//
// What bounds it on this card: bytes.  Each element reads one 4-byte
// index and writes one 4- or 8-byte value; the table (16,384 entries,
// 64 or 128 KB) stays in L1/L2, so the random reads cost L2 hits, not
// device-memory traffic.
//
// What the design does about it: two arms.
//   global (arm 0): one element per thread, grid-stride, the table read
//     through the read-only path (__ldg);
//   smem (arm 1): each block first stages the whole table in dynamic
//     shared memory (16,384 f64 are 128 KB: above the 48 KB default, so
//     the attribute MaxDynamicSharedMemorySize is raised to the table's
//     size), then gathers from it.  One block per SM's share of the
//     occupancy: the staging is paid once per block.  A table larger
//     than the card's opt-in limit is refused (cudaErrorInvalidValue),
//     never served from global memory instead.

#include "common.cuh"

namespace {

template <typename T>
__global__ void gather_global(long long n, const T* __restrict__ tab,
                              const int* __restrict__ idx,
                              T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    out[i] = __ldg(tab + idx[i]);
}

template <typename T>
__global__ void gather_smem(long long n, int c, const T* __restrict__ tab,
                            const int* __restrict__ idx,
                            T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  for (int j = threadIdx.x; j < c; j += blockDim.x) s[j] = tab[j];
  __syncthreads();
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    out[i] = s[idx[i]];
}

const int TB = 256;

int smem_optin() {
  static int lim = -1;
  if (lim < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&lim, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return lim;
}

template <typename T>
int launch(int arm, long long n, int c, const void* tab, const void* idx,
           void* out, cudaStream_t s) {
  if (arm == 0) {
    gather_global<T><<<grid_for(n, TB), TB, 0, s>>>(
        n, (const T*)tab, (const int*)idx, (T*)out);
    return (int)cudaGetLastError();
  }
  size_t bytes = (size_t)c * sizeof(T);
  if (c < 1 || bytes > (size_t)smem_optin())
    return (int)cudaErrorInvalidValue;
  // the grid of the last table size, per type (the occupancy query is a
  // host call; a timed loop repeats one size)
  static size_t last_bytes = 0;
  static int last_grid = 0;
  if (bytes != last_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        gather_smem<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      gather_smem<T>, TB,
                                                      bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    last_bytes = bytes;
    last_grid = per_sm * sm_count();
  }
  long long need = (n + TB - 1) / TB;
  int g = need < last_grid ? (int)(need > 0 ? need : 1) : last_grid;
  gather_smem<T><<<g, TB, bytes, s>>>(n, c, (const T*)tab, (const int*)idx,
                                      (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// The opt-in dynamic shared memory of one block (bytes): the largest
// table the smem arm takes is this over the element size.
extern "C" int probe_gather_smem_limit(int* out) {
  *out = smem_optin();
  return 0;
}

// dbl: float64 (1) or float32 (0); arm: 0 global, 1 smem; n elements of
// idx (int32, each in [0, c)), out shaped like idx.
extern "C" int probe_gather(int dbl, int arm, long long n, int c,
                            const void* tab, const void* idx, void* out,
                            void* stream) {
  if (arm != 0 && arm != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? launch<double>(arm, n, c, tab, idx, out, s)
             : launch<float>(arm, n, c, tab, idx, out, s);
}
