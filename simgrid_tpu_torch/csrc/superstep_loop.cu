// K16 superstep_loop: the fixpoint's and the superstep's while loops on
// the device, as CUDA graphs with conditional WHILE nodes.
//
// Replaces: the loops of the JAX programs whose bodies the port already
// runs as K1-K3, K7, K8 and K10:
// * simgrid_tpu/ops/lmm_drain.py `_superstep_program`'s lax.while_loop
//   (cond :332-342, loop :506), whose body solves to convergence inside
//   the remaining budget with `fixpoint` (:355-359), itself a
//   lax.while_loop (simgrid_tpu/ops/lmm_jax.py:174-183); vmapped over a
//   fleet in simgrid_tpu/ops/lmm_batch.py `_batch_superstep_program`
//   (:477);
// * the chunked solves' bounded fixpoint (lmm_jax.py `fixpoint`'s
//   `max_rounds` chunks), the compaction chain's stage loop
//   (`_ell_chain_stage`, :760-765) and its finisher (`_vc_chunk`,
//   :793-799).
//
// What bounds it on this card: latency.  A loop iteration is its body's
// kernels plus the condition; nothing here moves data beyond a few
// control words (B x 32 int32).  The least a superstep can take is the
// sum of its bodies' kernels over the rounds and advances it runs.
//
// What the design does about it: the host builds each loop nest once
// as a graph and launches it once a superstep (or a chunk, or a chain
// stage).  The graph is a sequence of captured launches (the existing
// wrappers' launches on a side stream, captured into the graph itself
// or into a body graph, kernel arguments baked in) and WHILE nodes;
// before each WHILE node, and as the last
// node of its body (unless the body's last kernel ends the iteration
// itself: K1's, K7's and K8's rounds, `Loop(..., ends=True)`, common.cuh
// `end_iteration`), sits one `loop_cond` kernel node, which evaluates
// the loop's condition on the control words of every replica, reduces
// it over the fleet in one block and sets the node's handle from one
// thread (`cudaGraphSetConditional`): each condition has exactly one
// writer.  The conditions (PRED_*) are the JAX programs' own:
// * PRED_SUPERSTEP: `flag == OK && adv < k && rounds < budget &&
//   (n_live > stop || pending > 0)` per replica, written to its
//   C_SS_ACTIVE (the gate of the slot's kernels), and the node runs
//   while any replica's slot is active;
// * PRED_ROUND: K1's round guard `armed && light > 0 && it < limit`
//   (the superstep's limit is the budget left, lmm_round.cu's init);
// * PRED_VC_ROUND: K7's and K8's guard, which adds a chain stage's
//   `vlive > half`;
// * PRED_COUNT: no control words: only the iteration cap.
// A loop with a cap (the chunked solves: `chunk` rounds between two
// host checks) counts its iterations in a device word: the node before
// the loop sets it to 0, each body's last node adds one, and the loop
// runs while `any && count < cap`.  Each body's last node also adds one
// to the loop's own tally word, which the host reads after a run, with
// no fetch per loop: the loop's iterations since the last reset (the
// device rounds a path ran, and with the launches its body holds, each
// kernel's launches inside the graph).
// Kernels inside the body still gate
// per replica on their own control words, so a replica that converged
// or ended its superstep waits untouched while the others run.
//
// Hazards the graph must respect, and how: every buffer a captured
// launch touches is allocated before the capture and kept alive by the
// graph's owner (kernels/superstep_loop.py `DeviceLoop`); no wrapper
// syncs with the host or allocates under capture (K1's row plan is
// built before it); the programmatic dependent launches of K2 and K3
// are captured as programmatic edges of the graph they are captured
// into.
//
// The graph-building entries below take and return opaque CUDA handles
// (graphs, nodes, executable graphs) as pointers; the Python side keeps
// them and destroys them with the loop.

#include <vector>

#include "common.cuh"

#define PRED_SUPERSTEP 0
#define PRED_ROUND 1
#define PRED_VC_ROUND 2
#define PRED_COUNT 3

namespace {

const int TB = 256;

__device__ __forceinline__ bool pred_of(int pred, int* ctrl) {
  switch (pred) {
    case PRED_SUPERSTEP: {
      bool on = ctrl[C_SS_FLAG] == FLAG_OK &&
                ctrl[C_SS_ADV] < ctrl[C_SS_K] &&
                ctrl[C_SS_ROUNDS] < ctrl[C_SS_BUDGET] &&
                (ctrl[C_SS_NLIVE] > ctrl[C_SS_STOP] ||
                 ctrl[C_PENDING] > 0);
      ctrl[C_SS_ACTIVE] = on;
      return on;
    }
    case PRED_ROUND:
      return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
             ctrl[C_IT] < ctrl[C_LIMIT];
    case PRED_VC_ROUND:
      return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
             ctrl[C_IT] < ctrl[C_LIMIT] && ctrl[C_VLIVE] > ctrl[C_HALF];
    default:
      return true;
  }
}

// One block: thread t evaluates replicas t, t + TB, ...; the OR over the
// block decides; thread 0 alone counts and sets the handle.
__global__ void __launch_bounds__(TB)
    loop_cond(int pred, int B, int* ctrl, int* cnt, int cap, int first,
              int* tally, cudaGraphConditionalHandle h) {
  bool any = pred == PRED_COUNT;
  if (!any)
    for (int b = threadIdx.x; b < B; b += blockDim.x)
      any |= pred_of(pred, ctrl + (long long)b * N_CTRL);
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    if (!first && tally) *tally += 1;
    bool go = any;
    if (cnt) {
      int n = first ? 0 : *cnt + 1;
      *cnt = n;
      go = go && n < cap;
    }
    cudaGraphSetConditional(h, go ? 1u : 0u);
  }
}

struct Cond {
  int pred, B;
  int* ctrl;
  int* cnt;
  int cap, first;
  int* tally;
  cudaGraphConditionalHandle h;
};

// A loop_cond kernel node in `g` after `*prev` (none when NULL); *prev
// becomes it.
cudaError_t add_cond(cudaGraph_t g, cudaGraphNode_t* prev, Cond c) {
  void* args[] = {&c.pred,  &c.B,     &c.ctrl, &c.cnt,
                  &c.cap,   &c.first, &c.tally, &c.h};
  cudaKernelNodeParams p = {};
  p.func = (void*)loop_cond;
  p.gridDim = dim3(1);
  p.blockDim = dim3(TB);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t n;
  cudaError_t e =
      cudaGraphAddKernelNode(&n, g, *prev ? prev : nullptr, *prev ? 1 : 0, &p);
  if (e == cudaSuccess) *prev = n;
  return e;
}

cudaError_t add_node(cudaGraphNode_t* n, cudaGraph_t g,
                     const cudaGraphNode_t* dep, cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(n, g, dep, nullptr, dep ? 1 : 0, p);
#else
  return cudaGraphAddNode(n, g, dep, dep ? 1 : 0, p);
#endif
}

}  // namespace

extern "C" {

// The runtime's and the driver's CUDA versions (1000 * major + 10 *
// minor).
int loop_versions(int* runtime, int* driver) {
  cudaError_t e = cudaRuntimeGetVersion(runtime);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDriverGetVersion(driver);
}

int loop_graph_new(void** graph) {
  return (int)cudaGraphCreate((cudaGraph_t*)graph, 0);
}

// Start capturing `stream` (a side stream of the caller's) into `graph`
// after `prev` (none when NULL): the wrappers called next append their
// launches to the graph itself (a conditional node's body graph too).
int loop_capture_begin(void* stream, void* graph, void* prev) {
  cudaGraphNode_t pv = (cudaGraphNode_t)prev;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)stream, (cudaGraph_t)graph, pv ? &pv : nullptr, nullptr,
      pv ? 1 : 0, cudaStreamCaptureModeRelaxed);
}

// End the capture; *prev becomes the node the next one depends on: the
// capture's last node (an empty node joining them if it left several;
// *prev itself if it captured nothing).
int loop_capture_end(void* stream, void* graph, void** prev) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus st;
  const cudaGraphNode_t* deps = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &st, nullptr, nullptr, &deps, nullptr, &n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &st, nullptr, nullptr, &deps,
                                           &n);
#endif
  // the array belongs to the stream: copy it before the capture ends
  cudaGraphNode_t last[8];
  size_t m = n < 8 ? n : 8;
  for (size_t i = 0; e == cudaSuccess && i < m; ++i) last[i] = deps[i];
  cudaGraph_t g = nullptr;
  cudaError_t e2 = cudaStreamEndCapture(s, &g);
  if (e != cudaSuccess) return (int)e;
  if (e2 != cudaSuccess) return (int)e2;
  if (n > 8) return (int)cudaErrorNotSupported;
  if (m == 1) {
    *prev = (void*)last[0];
  } else if (m > 1) {
    cudaGraphNode_t join;
    e = cudaGraphAddEmptyNode(&join, (cudaGraph_t)graph, last, m);
    if (e != cudaSuccess) return (int)e;
    *prev = (void*)join;
  }
  return 0;
}

// A WHILE loop in `parent` after *prev: a new conditional handle, the
// condition's first evaluation (a loop_cond node: count reset to 0),
// then the WHILE node; *prev becomes the WHILE node, *body its body
// graph (owned by the node) and *handle the handle, which `loop_end`
// needs.  ctrl: the control words of B replicas ([B, N_CTRL] int32;
// NULL for PRED_COUNT); cnt: the loop's count word (NULL: no cap).
int loop_while(void* parent, void** prev, int pred, int B, void* ctrl,
               void* cnt, int cap, void** body,
               unsigned long long* handle) {
  if (pred < PRED_SUPERSTEP || pred > PRED_COUNT || B < 0 ||
      (pred != PRED_COUNT && (!ctrl || B < 1)) || (cnt && cap < 0))
    return (int)cudaErrorInvalidValue;
  cudaGraph_t g = (cudaGraph_t)parent;
  cudaGraphConditionalHandle h;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t* pv = (cudaGraphNode_t*)prev;
  e = add_cond(g, pv,
               Cond{pred, B, (int*)ctrl, (int*)cnt, cap, 1, nullptr, h});
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = add_node(&node, g, pv, &p);
  if (e != cudaSuccess) return (int)e;
  *pv = node;
  *body = (void*)p.conditional.phGraph_out[0];
  *handle = (unsigned long long)h;
  return 0;
}

// The body's last node: the condition again (count + 1), after `prev`
// (none when NULL); it adds each iteration to the loop's word `tally`
// (NULL: none).
int loop_end(void* body, void* prev, int pred, int B, void* ctrl, void* cnt,
             int cap, void* tally, unsigned long long handle) {
  cudaGraphNode_t pv = (cudaGraphNode_t)prev;
  return (int)add_cond((cudaGraph_t)body, &pv,
                       Cond{pred, B, (int*)ctrl, (int*)cnt, cap, 0,
                            (int*)tally,
                            (cudaGraphConditionalHandle)handle});
}

// What a round loop's body holds once built: its nodes, its kernel
// nodes and its loop_cond nodes (0 in a body its last kernel ends).
int loop_body_nodes(void* body, int* nodes, int* kernels, int* conds) {
  cudaGraph_t g = (cudaGraph_t)body;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess) return (int)e;
  std::vector<cudaGraphNode_t> all(n);
  if (n) e = cudaGraphGetNodes(g, all.data(), &n);
  if (e != cudaSuccess) return (int)e;
  int k = 0, c = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(all[i], &t);
    if (e != cudaSuccess) return (int)e;
    if (t != cudaGraphNodeTypeKernel) continue;
    ++k;
    cudaKernelNodeParams p = {};
    if (cudaGraphKernelNodeGetParams(all[i], &p) == cudaSuccess &&
        p.func == (void*)loop_cond)
      ++c;
  }
  cudaGetLastError();  // a captured node's parameters may not be readable
  *nodes = (int)n;
  *kernels = k;
  *conds = c;
  return 0;
}

int loop_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec,
                                   (cudaGraph_t)graph, 0);
}

int loop_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int loop_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

}  // extern "C"
