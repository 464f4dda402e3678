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
// far below a microsecond of bandwidth; the launches are the cost (one
// launch a run: 7 runs took 16 us on an NVIDIA H100 80GB HBM3 at
// 700 W, about 2.3 us a launch; one launch of all runs takes 5.8 us
// there, of which 1.3 us is the kernel's own).
//
// What the design does about it: one launch a call, whatever the number
// of runs.  The run table (each run's target, kind, payload offset and
// first slot in the call) travels by value as a kernel argument, so a
// captured call holds no pointer to host memory; one thread a slot over
// all runs finds its run among at most MAX_RUNS slot prefixes (an
// unrolled compare, no search in memory), then converts and stores as
// the per-run kernels did.  Writes of different runs are unordered, so
// no two runs of a call may share a target: the C entry and the Python
// wrapper refuse such a layout (every caller ships one run per field).
// No atomics and no synchronisation.

#include "common.cuh"

#define KIND_I32 0
#define KIND_F32 1
#define KIND_F64 2
#define KIND_BOOL 3
#define KIND_POS 4

// the most runs a call takes (the drain's eight TRANSITION_FIELDS)
#define MAX_RUNS 8

namespace {

struct RunTable {
  void* target[MAX_RUNS];
  int kind[MAX_RUNS];
  int off[MAX_RUNS];          // payload offset of the run's indices
  int start[MAX_RUNS + 1];    // the run's first slot; the total from
                              // start[n_runs] on
};

__global__ void scatter_runs(RunTable rt, const double* __restrict__ payload,
                             int total) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int r = 0;
#pragma unroll
    for (int q = 1; q < MAX_RUNS; ++q) r += i >= rt.start[q];
    void* out = nullptr;
    int kind = 0, off = 0, beg = 0, end = 0;
#pragma unroll
    for (int q = 0; q < MAX_RUNS; ++q)
      if (q == r) {
        out = rt.target[q];
        kind = rt.kind[q];
        off = rt.off[q];
        beg = rt.start[q];
        end = rt.start[q + 1];
      }
    const double* run = payload + off;
    int j = i - beg;
    long long at = (long long)run[j];
    double x = run[(end - beg) + j];
    switch (kind) {
      case KIND_I32: ((int*)out)[at] = (int)x; break;
      case KIND_F32: ((float*)out)[at] = (float)x; break;
      case KIND_F64: ((double*)out)[at] = x; break;
      case KIND_BOOL: ((bool*)out)[at] = x != 0.0; break;
      default: ((bool*)out)[at] = x > 0.0; break;   // KIND_POS
    }
  }
}

}  // namespace

// runs: n_runs triples (target, offset, length) on the host; kinds: the
// element type of each of the n_targets targets (KIND_*).  At most
// MAX_RUNS runs, each on its own target; no run is empty.
extern "C" int transition_scatter(int n_runs, const int* runs,
                                  const double* payload, void** targets,
                                  const int* kinds, int n_targets,
                                  void* stream) {
  if (n_runs == 0) return 0;
  if (n_runs < 0 || n_runs > MAX_RUNS) return (int)cudaErrorInvalidValue;
  RunTable rt;
  long long total = 0;
  for (int r = 0; r < n_runs; ++r) {
    int ti = runs[3 * r], off = runs[3 * r + 1], n = runs[3 * r + 2];
    if (ti < 0 || ti >= n_targets || n <= 0 || off < 0 ||
        kinds[ti] < KIND_I32 || kinds[ti] > KIND_POS)
      return (int)cudaErrorInvalidValue;
    for (int q = 0; q < r; ++q)
      if (runs[3 * q] == ti) return (int)cudaErrorInvalidValue;
    rt.target[r] = targets[ti];
    rt.kind[r] = kinds[ti];
    rt.off[r] = off;
    rt.start[r] = (int)total;
    total += n;
    if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  }
  for (int r = n_runs; r < MAX_RUNS; ++r) {
    rt.target[r] = nullptr;
    rt.kind[r] = KIND_F64;
    rt.off[r] = 0;
  }
  for (int r = n_runs; r <= MAX_RUNS; ++r) rt.start[r] = (int)total;
  const int TB = 256;
  scatter_runs<<<grid_for(total, TB), TB, 0, (cudaStream_t)stream>>>(
      rt, payload, (int)total);
  return (int)cudaGetLastError();
}
