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
// What bounds it on this card: latency.  The edge list is a few tens of
// thousands of rows (36,864 for the 1,024-rank recursive-doubling
// allreduce): under half a megabyte read once.
//
// What the design does about it: one grid-stride pass with one integer
// atomicSub per decrement.  Integer atomics are exact, and the one that
// returns 1 takes the count from 1 to 0: exactly the flows where
// `pred2 <= 0 && pred_c > 0` (a flow's count equals its number of
// in-edges, so it never goes below zero).  The date is one f64 add with
// round-to-nearest; no floating-point atomic feeds anything.  The count
// of flows freed goes into the pending-activation word the superstep's
// loop condition reads (one integer atomicAdd per block).
//
// The replica axis (simgrid_tpu/ops/lmm_batch.py `_batch_superstep_
// program`'s `has_coll` arm, :479-529: the walk vmapped over a fleet):
// blockIdx.y picks the replica, whose control words (`ADV_OK`,
// `PENDING`), Kahan sum, completion mask and `pred`/`ready` rows move to
// its row; the edge list and the exec costs are shared.  A dead replica
// (k = 0, so its slot never runs) or one whose advance did not commit
// has `ADV_OK` 0 and moves nothing.  B = 1 is the solo walk.

#include "common.cuh"

namespace {

__global__ void walk(int n_edges, int n_v, const bool* __restrict__ done,
                     const int* __restrict__ edge_src,
                     const int* __restrict__ edge_dst, int* pred,
                     double* ready, const double* __restrict__ exec_cost,
                     int* ctrl, const double* fctrl) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!ctrl[C_ADV_OK]) return;
  fctrl += b * N_FCTRL;
  done += b * n_v;
  pred += b * n_v;
  ready += b * n_v;
  double t_new = fctrl[F_TSUM];
  int freed = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_edges;
       e += gridDim.x * blockDim.x) {
    int d = edge_dst[e];
    if (d >= n_v || !done[edge_src[e]]) continue;
    if (atomicSub(pred + d, 1) == 1) {
      ready[d] = __dadd_rn(t_new, exec_cost[d]);
      ++freed;
    }
  }
  int tot = block_sum(freed);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_PENDING, tot);
}

}  // namespace

// B replicas in one launch (B = 1: the solo walk); done, pred and
// ready are [B, n_v], ctrl and fctrl the replicas' control words.
extern "C" int dag_walk(int B, int n_edges, int n_v, const void* done,
                        const void* edge_src, const void* edge_dst,
                        void* pred, void* ready, const void* exec_cost,
                        void* ctrl, const void* fctrl, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  const int TB = 256;
  walk<<<grid_b(n_edges, TB, B), TB, 0, (cudaStream_t)stream>>>(
      n_edges, n_v, (const bool*)done, (const int*)edge_src,
      (const int*)edge_dst, (int*)pred, (double*)ready,
      (const double*)exec_cost, (int*)ctrl, (const double*)fctrl);
  return (int)cudaGetLastError();
}
