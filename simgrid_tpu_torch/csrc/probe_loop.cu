// K15 probe_loop: K rounds of a whole-table gather, each round depending
// on the last through one scalar, and P8's `x * 2`.
//
// Replaces: P3 tools/tpu_pallas_probe.py `lk` (:105, a fori_loop of 16
// gather rounds inside one Pallas kernel) and P8 tools/tpu_opcost.py
// `pk` (:166, `x * 2`, the check that Pallas lowers at all).  Each round
//     g   = (tab + acc[0] * 1e-30)[idx]        g [V, DEG], written whole
//     acc = acc + g[:8, 0]                     acc [8], from zeros
// so round k+1's gather reads round k's acc[0]: the rounds cannot
// overlap, as the fixpoint's rounds cannot.  `lk` keeps only g[:8]; a
// CUDA loop that gathered only those would measure nothing, so every
// arm writes the whole g to a scratch [V, DEG] each round.  The multiply
// and the adds are pinned with __*mul_rn / __*add_rn.
//
// What bounds it on this card: per round, the gather's bytes (an index
// read and a value written per element, as K12) and the round-to-round
// dependency: between two rounds every thread of the grid must see the
// last round's acc.  That is ROADMAP A11's question: how to put the
// solver's fixpoint loop on the device.
//
// What the design does about it: three arms of the same function.
//   coop: one cooperative launch (cudaLaunchCooperativeKernel) of a
//     grid-stride body with cooperative_groups' grid.sync() between the
//     gather and the acc update, and between rounds.  The grid is the
//     co-resident maximum (the occupancy query times the SM count); a
//     larger grid is refused by the launch
//     (cudaErrorCooperativeLaunchTooLarge) and the wrapper raises.
//   launch: K launches of a one-round kernel.  acc lives in two buffers
//     (round k reads acc[k % 2] and writes acc[(k + 1) % 2]), so the
//     threads that gathered g[:8, 0] update acc in the same launch
//     without a race; round 0 reads zeros.
//   graph: the same K launches captured once in a CUDA graph (by the
//     wrapper, through torch.cuda.CUDAGraph) and replayed.
//   cond: one round's launch captured once into the body of a CUDA-graph
//     conditional WHILE node (K16, csrc/superstep_loop.cu), whose
//     condition node counts the rounds (`loop_round_at` reads the
//     count); one graph launch runs all K rounds, each a round kernel
//     and a one-block condition kernel.
// `probe_double` is one elementwise launch: chained, its time per launch
// is the card's launch floor, which every other probe is read against.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ double tiny<double>() { return 1e-30; }
template <> __device__ __forceinline__ float tiny<float>() { return 1e-30f; }

template <typename T>
__global__ void loop_coop(int rounds, long long n, int deg,
                          const T* __restrict__ tab,
                          const int* __restrict__ idx, T* g, T* acc) {
  cg::grid_group grid = cg::this_grid();
  long long t0 = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long stride = (long long)gridDim.x * blockDim.x;
  if (t0 < 8) acc[t0] = T(0);
  grid.sync();
  for (int k = 0; k < rounds; ++k) {
    // acc and g are written by other blocks between the syncs: read them
    // past L1 (__ldcg)
    T sh = mul_rn(__ldcg(acc), tiny<T>());
    for (long long i = t0; i < n; i += stride)
      g[i] = add_rn(__ldg(tab + idx[i]), sh);
    grid.sync();
    if (t0 < 8) acc[t0] = add_rn(acc[t0], __ldcg(g + t0 * deg));
    grid.sync();
  }
}

template <typename T>
__global__ void loop_round(int first, long long n, int deg,
                           const T* __restrict__ tab,
                           const int* __restrict__ idx, T* g,
                           const T* acc_in, T* acc_out) {
  T a0 = first ? T(0) : acc_in[0];
  T sh = mul_rn(a0, tiny<T>());
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    T v = add_rn(__ldg(tab + idx[i]), sh);
    g[i] = v;
    if (i < 8LL * deg && i % deg == 0) {
      int r = (int)(i / deg);
      acc_out[r] = add_rn(first ? T(0) : acc_in[r], v);
    }
  }
}

// The cond arm's round: round k = *cnt (the WHILE loop's count word,
// which the loop's condition node bumps after each round) reads
// accs[k % 2] (zeros when k == 0) and writes accs[(k + 1) % 2].
template <typename T>
__global__ void loop_round_at(const int* __restrict__ cnt, long long n,
                              int deg, const T* __restrict__ tab,
                              const int* __restrict__ idx, T* g, T* accs) {
  int k = *cnt;
  const T* acc_in = accs + 8 * (k & 1);
  T* acc_out = accs + 8 * ((k + 1) & 1);
  T a0 = k == 0 ? T(0) : acc_in[0];
  T sh = mul_rn(a0, tiny<T>());
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    T v = add_rn(__ldg(tab + idx[i]), sh);
    g[i] = v;
    if (i < 8LL * deg && i % deg == 0) {
      int r = (int)(i / deg);
      acc_out[r] = add_rn(k == 0 ? T(0) : acc_in[r], v);
    }
  }
}

template <typename T>
__global__ void double_k(long long n, const T* __restrict__ x,
                         T* __restrict__ out) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = mul_rn(x[i], T(2));
}

const int TB = 256;

template <typename T>
int coop_grid(int* grid) {
  static int g = 0;
  if (g == 0) {
    int per_sm = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, loop_coop<T>, TB, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidValue;
    g = per_sm * sm_count();
  }
  *grid = g;
  return 0;
}

template <typename T>
int coop(int rounds, long long n, int deg, int grid, const void* tab,
         const void* idx, void* g, void* acc, cudaStream_t s) {
  if (grid <= 0) {
    int rc = coop_grid<T>(&grid);
    if (rc) return rc;
  }
  const T* tp = (const T*)tab;
  const int* ip = (const int*)idx;
  T* gp = (T*)g;
  T* ap = (T*)acc;
  void* args[] = {&rounds, &n, &deg, &tp, &ip, &gp, &ap};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)loop_coop<T>, grid, TB,
                                              args, 0, s);
  cudaGetLastError();  // a refused launch leaves no sticky error behind
  return (int)e;
}

}  // namespace

// The cooperative arm's grid: the co-resident maximum of its blocks
// (blocks per SM by occupancy, times the SMs).
extern "C" int probe_loop_coop_grid(int dbl, int* grid) {
  return dbl ? coop_grid<double>(grid) : coop_grid<float>(grid);
}

// All `rounds` in one cooperative launch; grid 0 takes probe_loop_coop_grid.
// tab [C]; idx, g [n = V * deg]; acc [8] (the result).
extern "C" int probe_loop_coop(int dbl, int rounds, long long n, int deg,
                               int grid, const void* tab, const void* idx,
                               void* g, void* acc, void* stream) {
  if (rounds < 0 || n < 8LL * deg || deg < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? coop<double>(rounds, n, deg, grid, tab, idx, g, acc, s)
             : coop<float>(rounds, n, deg, grid, tab, idx, g, acc, s);
}

// One round: reads acc_in (zeros when `first`), writes g and acc_out.
extern "C" int probe_loop_round(int dbl, int first, long long n, int deg,
                                const void* tab, const void* idx, void* g,
                                const void* acc_in, void* acc_out,
                                void* stream) {
  if (n < 8LL * deg || deg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int gr = grid_for(n, TB);
  if (dbl)
    loop_round<double><<<gr, TB, 0, s>>>(
        first, n, deg, (const double*)tab, (const int*)idx, (double*)g,
        (const double*)acc_in, (double*)acc_out);
  else
    loop_round<float><<<gr, TB, 0, s>>>(
        first, n, deg, (const float*)tab, (const int*)idx, (float*)g,
        (const float*)acc_in, (float*)acc_out);
  return (int)cudaGetLastError();
}

// The cond arm's round (captured into the body of K16's WHILE node,
// kernels/probe_loop.py `CondLoop`): reads the round number from cnt.
extern "C" int probe_loop_round_at(int dbl, long long n, int deg,
                                   const void* tab, const void* idx, void* g,
                                   void* accs, const void* cnt,
                                   void* stream) {
  if (n < 8LL * deg || deg < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int gr = grid_for(n, TB);
  if (dbl)
    loop_round_at<double><<<gr, TB, 0, s>>>(
        (const int*)cnt, n, deg, (const double*)tab, (const int*)idx,
        (double*)g, (double*)accs);
  else
    loop_round_at<float><<<gr, TB, 0, s>>>(
        (const int*)cnt, n, deg, (const float*)tab, (const int*)idx,
        (float*)g, (float*)accs);
  return (int)cudaGetLastError();
}

extern "C" int probe_double(int dbl, long long n, const void* x, void* out,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    double_k<double><<<grid_for(n, TB), TB, 0, s>>>(n, (const double*)x,
                                                    (double*)out);
  else
    double_k<float><<<grid_for(n, TB), TB, 0, s>>>(n, (const float*)x,
                                                   (float*)out);
  return (int)cudaGetLastError();
}
