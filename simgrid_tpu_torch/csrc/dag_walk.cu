// K10 dag_walk: one advance of a collective schedule's DAG walk.
//
// Replaces: simgrid_tpu/ops/lmm_drain.py `_superstep_program`, the
// `has_coll` arm's walk (:457-463): every completion of this advance
// decrements the outstanding-predecessor count of each of its
// successors over the static edge list,
//     pred[edge_dst] -= done[edge_src]    (pad rows, dst == n_v, dropped)
// and a flow whose count crossed to zero in this advance gets its
// activation date `ready = t_new + exec_cost` (a later advance lands on
// it; K3 fires it).  The walk commits only when the advance did (K3's
// `ADV_OK` word: converged and a finite dt, in an active slot), as JAX's
// `sel` keeps `pred2`/`ready2` only if ok.  It runs after K3, so K3's
// activation test reads the dates from before this walk.
//
// What bounds it on this card: latency.  The JAX function reads the
// whole edge list (36,864 rows for the 1,024-rank recursive-doubling
// allreduce, under half a megabyte), but an advance completes only a
// handful of flows, so the decrements it has to make are a few dozen.
//
// What the design does about it: the edges are held as an out-edge CSR
// (`src_ptr` [n_v + 1], `out_dst`: the targets grouped by source, pad
// rows dropped; kernels/dag_walk.py `dag_csr`, built once per schedule
// when it is uploaded).  LANES threads serve a flow: each reads the
// flow's flag and row pointers in one wave of independent loads, and
// where the flow completed in this advance, walks every LANES-th of its
// out-edges; so the launch reads n_v flags and only the completions'
// edges, and a completion's decrements run side by side, not one after
// another (with 16 flags a thread, the completions of one collective
// step, which sit a few flows apart, queued a dozen dependent atomics on
// one thread).  Each replica's grid is capped as `grid_b` caps it (a
// fleet of 32 took longer with a block for every 256 items).  The
// kernel is launched as a programmatic dependent of K3's last kernel
// (`ss_write`).  Each decrement is one integer atomicSub; integer
// atomics are exact, and the one that returns 1 takes the count from 1
// to 0: exactly the flows where `pred2 <= 0 && pred_c > 0`, whatever
// order the decrements come in (a flow's count equals its number of
// in-edges, so it never goes below zero).  The date is written once, at
// that crossing, with one f64 add with round-to-nearest; no
// floating-point atomic feeds anything.  The count of flows freed goes
// into the pending-activation word the superstep's loop condition reads
// (one integer atomicAdd per block).
//
// The replica axis (simgrid_tpu/ops/lmm_batch.py `_batch_superstep_
// program`'s `has_coll` arm, :479-529: the walk vmapped over a fleet):
// blockIdx.y picks the replica, whose control words (`ADV_OK`,
// `PENDING`), Kahan sum, completion mask and `pred`/`ready` rows move to
// its row; the CSR and the exec costs are shared.  A dead replica
// (k = 0, so its slot never runs) or one whose advance did not commit
// has `ADV_OK` 0 and moves nothing.  B = 1 is the solo walk.

#include "common.cuh"

namespace {

const int TB = 256;
// threads a flow: thread k of a flow takes its out-edges k, k + LANES,
// ... (the schedules' flows have at most 4)
const int LANES = 4;

__global__ void __launch_bounds__(TB)
    walk(int n_v, const bool* __restrict__ done,
         const int* __restrict__ src_ptr, const int* __restrict__ out_dst,
         int* pred, double* ready, const double* __restrict__ exec_cost,
         int* ctrl, const double* fctrl) {
  pdl_wait();
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  fctrl += b * N_FCTRL;
  done += b * n_v;
  pred += b * n_v;
  ready += b * n_v;
  // one wave of independent loads: the gate, the clock, and each item's
  // flag and row
  int ok = ctrl[C_ADV_OK];
  double t_new = fctrl[F_TSUM];
  int freed = 0;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < (long long)n_v * LANES; t += (long long)gridDim.x * blockDim.x) {
    int f = (int)(t / LANES), k = (int)(t % LANES);
    bool dn = done[f];
    int beg = src_ptr[f], end = src_ptr[f + 1];
    if (!ok) break;
    if (!dn) continue;
    for (int j = beg + k; j < end; j += LANES) {
      int d = out_dst[j];
      double c = exec_cost[d];
      if (atomicSub(pred + d, 1) == 1) {
        ready[d] = __dadd_rn(t_new, c);
        ++freed;
      }
    }
  }
  if (!ok) return;
  int tot = block_sum(freed);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_PENDING, tot);
}

}  // namespace

// B replicas in one launch (B = 1: the solo walk); done, pred and
// ready are [B, n_v], ctrl and fctrl the replicas' control words;
// src_ptr [n_v + 1] and out_dst the schedule's out-edge CSR.
extern "C" int dag_walk(int B, int n_v, const void* done,
                        const void* src_ptr, const void* out_dst,
                        void* pred, void* ready, const void* exec_cost,
                        void* ctrl, const void* fctrl, void* stream) {
  if (B < 1 || B > 65535 || n_v < 0) return (int)cudaErrorInvalidValue;
  dim3 grid = grid_b((long long)n_v * LANES, TB, B);
  cudaError_t e = launch_dependent(
      walk, grid, TB,
      (cudaStream_t)stream, n_v, (const bool*)done, (const int*)src_ptr,
      (const int*)out_dst, (int*)pred, (double*)ready,
      (const double*)exec_cost, (int*)ctrl, (const double*)fctrl);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
