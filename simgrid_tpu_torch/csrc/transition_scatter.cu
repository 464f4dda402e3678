// K5 transition_scatter: one payload of indexed runs into device arrays.
//
// Replaces: simgrid_tpu/ops/lmm_drain.py `_apply_transition_payload`
// (:552-581), the device half of `DrainSim.apply_transitions`
// (:1122-1166), and simgrid_tpu/ops/lmm_warm.py `_apply_deltas`
// (:119-137), the warm solver's delta upload, and `_apply_deltas_ell`
// (:140-154), its element deltas into the ELL masters: the payload is one
// float64 vector of per-field runs [indices..., values...]; each run is
// an indexed set into one target (the drain's element, bound and flow
// arrays, or the warm solver's seven masters).  Indices are exact in
// float64 below 2^32 and convert by truncation; values convert to the
// target's type (truncation to int32, round to nearest to float32,
// nonzero to bool), as XLA's convert does, or, for the ELL validity
// masters (KIND_POS), to `value > 0`, as `_apply_deltas_ell` writes
// them.  Indexes address the target flat (row * width + lane).  The drain's runs never
// repeat an index; the warm solver's runs are padded by repeating their
// first (index, value) pair, so every duplicate write carries the same
// value and the order in which the threads write does not matter.
//
// What bounds it on this card: latency.  A batch is a few thousand
// slots (16 B of payload and one 1-8 B store each, tens of KB in all),
// far below a microsecond of bandwidth; the launches are the cost.
//
// What the design does about it: one launch per run, one thread per
// slot, no atomics and no synchronisation; the run table (target,
// offset, length) comes from the host as kernel arguments.

#include "common.cuh"

#define KIND_I32 0
#define KIND_F32 1
#define KIND_F64 2
#define KIND_BOOL 3
#define KIND_POS 4

namespace {

template <typename T>
__global__ void scatter_run(int n, const double* __restrict__ idx,
                            const double* __restrict__ vals, T* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[(long long)idx[i]] = (T)vals[i];
}

__global__ void scatter_run_bool(int n, const double* __restrict__ idx,
                                 const double* __restrict__ vals,
                                 bool* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[(long long)idx[i]] = vals[i] != 0.0;
}

__global__ void scatter_run_pos(int n, const double* __restrict__ idx,
                                const double* __restrict__ vals,
                                bool* out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[(long long)idx[i]] = vals[i] > 0.0;
}

}  // namespace

// runs: n_runs triples (target, offset, length) on the host; kinds: the
// element type of each of the n_targets targets (KIND_*).
extern "C" int transition_scatter(int n_runs, const int* runs,
                                  const double* payload, void** targets,
                                  const int* kinds, int n_targets,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int TB = 256;
  for (int r = 0; r < n_runs; ++r) {
    int ti = runs[3 * r], off = runs[3 * r + 1], n = runs[3 * r + 2];
    if (ti < 0 || ti >= n_targets || n <= 0)
      return (int)cudaErrorInvalidValue;
    const double* idx = payload + off;
    const double* vals = payload + off + n;
    int g = grid_for(n, TB);
    switch (kinds[ti]) {
      case KIND_I32:
        scatter_run<int><<<g, TB, 0, s>>>(n, idx, vals, (int*)targets[ti]);
        break;
      case KIND_F32:
        scatter_run<float><<<g, TB, 0, s>>>(n, idx, vals,
                                            (float*)targets[ti]);
        break;
      case KIND_F64:
        scatter_run<double><<<g, TB, 0, s>>>(n, idx, vals,
                                             (double*)targets[ti]);
        break;
      case KIND_BOOL:
        scatter_run_bool<<<g, TB, 0, s>>>(n, idx, vals,
                                          (bool*)targets[ti]);
        break;
      case KIND_POS:
        scatter_run_pos<<<g, TB, 0, s>>>(n, idx, vals, (bool*)targets[ti]);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
