// K3 superstep_commit: the control of a superstep of up to K advances.
//
// Replaces: simgrid_tpu/ops/lmm_drain.py `_superstep_program`
// (:248-531) and, through the same kernels, the commit half of
// `_fused_step_program` (:203-234).  Its tape arm replaces :423-437,
// its collective arm :332-342, :439-456 and :486-521 (K10 `dag_walk`
// takes :457-463).
// The JAX program is one lax.while_loop; here the host queues K advance
// slots back to back (begin -> K1 init -> K1 rounds -> K2 -> commit)
// and the device decides, slot by slot, whether each one runs:
//
// * superstep_reset: the loop carry (advance/round counters, flag,
//   ring length, Kahan pair) and the live count of the input; with a
//   tape, the cursor and the f64 base clock t0 the event peek adds
//   t_sum to (set once, so a STARVED resume peeks from the same t0);
//   with a collective, the Kahan pair from `coll_clk` (carried across
//   supersteps, so event dates do not depend on how advances are
//   grouped) and the count of pending activation dates;
// * superstep_begin: the while_loop cond, `flag == OK && adv < k &&
//   rounds < budget && (n_live > stop_live || pending > 0)`;
// * superstep_commit: the loop body after the solve and the advance:
//   the Kahan clock update `y = dt - c; t' = t + y; c' = (t' - t) - y`
//   (explicit round-to-nearest intrinsics, so nothing reassociates or
//   contracts it), ring positions `n_ev + cumsum(done) - 1` in slot
//   order, the per-advance dt and event-count tables, the flag and the
//   `commit only if ok` select.  Its event arms, after the completions:
//   when K2 said the fault-tape entry fires, one tagged ring entry
//   `-(1 + slot)` at t_new, the new bound scattered into the drain's
//   c_bound and the cursor bumped; when activations fire, every flow
//   with `ready <= next_t` (read before K10 writes new dates) gets a
//   ring entry `-(1 + n_c + id)` in slot order after those, penalty 1
//   and `ready = inf`, and the pending and live counts move by their
//   number.  All of it only if ok, as JAX's `sel`;
// * superstep_finish: live elements and the packed stats vector,
//   laid out as lmm_drain.py:525-530, so the host collect is a straight
//   port and the host fetches once per superstep; with a collective,
//   the Kahan pair back into `coll_clk`.
//
// What bounds it on this card: latency.  The commit reads the V-long
// completion mask once (100 KB at 100k flows, tens of nanoseconds of
// bandwidth); the rest is scalar work.  The finish reads the element
// list once (E x 12 B = 15 MB at config #4, about 4.5 us).
//
// What the design does about it: the commit is a single block of 1024
// threads, each scanning a contiguous chunk of the mask, with one block
// scan of the chunk counts; that keeps slot order (the order the host
// paths emit completions in) with no second launch and no atomics.

// The replica axis (simgrid_tpu/ops/lmm_batch.py
// `_batch_superstep_program`, :477-523: the solo superstep vmapped over
// a fleet): blockIdx.y picks the replica, whose control words, Kahan
// pair, event clock, ring row of `packed`, flow state, tape row and
// bounds move to its row (the ids are shared).  `ss_reset` takes a
// per-replica k (`k_l = where(alive, k, 0)`, :510), base clock t0 and
// tape cursor, so a dead replica's guards are false from entry and its
// state comes back unchanged; `ss_resume` resumes exactly the replicas
// that came back STARVED and turns every other replica's slot off, so
// one queued resume serves the fleet and the grouping of advances into
// supersteps stays JAX's; `superstep_finish` packs [B, packed_size] for
// one fetch per fleet superstep.

#include "common.cuh"

namespace {

template <typename T>
__global__ void ss_reset(int V, const T* __restrict__ pen, int* ctrl,
                         T* fctrl, int k, int budget, int stop, double* evf,
                         double t0, int tpos,
                         const double* __restrict__ ready,
                         const double* __restrict__ clk, const int* k_arr,
                         const double* t0_arr, const int* tpos_arr) {
  long long b = blockIdx.y;
  pen += b * V;
  ctrl += b * N_CTRL;
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  if (ready) ready += b * V;
  if (clk) clk += 2 * b;
  if (k_arr) k = k_arr[b];
  if (t0_arr) t0 = t0_arr[b];
  if (tpos_arr) tpos = tpos_arr[b];
  int live = 0, pend = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    live += pen[v] > T(0);
    if (ready) pend += isfinite(ready[v]);
  }
  int tot = block_sum(live);
  int ptot = block_sum(pend);
  if (threadIdx.x == 0) {
    ctrl[C_SS_ACTIVE] = 0;
    ctrl[C_SS_ADV] = 0;
    ctrl[C_SS_ROUNDS] = 0;
    ctrl[C_SS_FLAG] = FLAG_OK;
    ctrl[C_SS_NEV] = 0;
    ctrl[C_SS_NLIVE] = tot;
    ctrl[C_SS_K] = k;
    ctrl[C_SS_BUDGET] = budget;
    ctrl[C_SS_STOP] = stop;
    ctrl[C_SS_STARVED] = 0;
    ctrl[C_TPOS] = tpos;
    ctrl[C_PENDING] = ptot;
    ctrl[C_ADV_OK] = 0;
    fctrl[F_TSUM] = clk ? T(clk[0]) : T(0);
    fctrl[F_TCOMP] = clk ? T(clk[1]) : T(0);
    evf[EV_T0] = t0;
    evf[EV_NEXT_T] = inf_v<double>();
  }
}

__global__ void ss_begin(int* ctrl) {
  ctrl += (long long)blockIdx.y * N_CTRL;
  ctrl[C_SS_ACTIVE] = !ctrl[C_SS_STARVED] && ctrl[C_SS_FLAG] == FLAG_OK &&
                      ctrl[C_SS_ADV] < ctrl[C_SS_K] &&
                      ctrl[C_SS_ROUNDS] < ctrl[C_SS_BUDGET] &&
                      (ctrl[C_SS_NLIVE] > ctrl[C_SS_STOP] ||
                       ctrl[C_PENDING] > 0);
}

__global__ void ss_resume(int* ctrl) {
  ctrl += (long long)blockIdx.y * N_CTRL;
  if (ctrl[C_SS_STARVED]) {
    ctrl[C_SS_STARVED] = 0;
    ctrl[C_SS_ACTIVE] = 1;
    ctrl[C_ARMED] = 1;
  } else {
    // a replica that did not starve has ended its superstep
    ctrl[C_SS_ACTIVE] = 0;
  }
}

// The event arms' arrays (NULL when the arm is off).
template <typename T>
struct Arms {
  const int* tape_slot;  // [T] int32 constraint slots
  const T* tape_val;     // [T] new bounds, in the drain's dtype
  int n_tape;            // T, the tape row's stride
  T* c_bound;            // [C] the drain's bounds (scattered into)
  int cb_stride;         // C, the bounds row's stride
  int n_c;
  double* ready;         // [V] f64 pending activation dates
  T* pen;                // [V] penalties (activations set 1.0)
};

template <typename T>
__global__ void ss_commit(int V, const bool* __restrict__ done,
                          const int* __restrict__ ids, T* packed, int* ctrl,
                          T* fctrl, int k_max, int ring_n,
                          const double* evf, Arms<T> arm) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!ctrl[C_ADV_GO]) return;
  done += b * V;
  packed += b * (7 + 2 * (long long)k_max + 2 * (long long)ring_n);
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  if (arm.tape_slot) {
    arm.tape_slot += b * arm.n_tape;
    arm.tape_val += b * arm.n_tape;
    arm.c_bound += b * arm.cb_stride;
  }
  if (arm.ready) {
    arm.ready += b * V;
    arm.pen += b * V;
  }
  T dt = fctrl[F_DT];
  bool conv = ctrl[C_ADV_CONV] != 0;
  bool ok = conv && finite_v(dt);
  bool f_fire = ok && arm.tape_slot && ctrl[C_FFIRE];
  bool a_any = ok && arm.ready && ctrl[C_AANY];
  int tpos = ctrl[C_TPOS];
  T ts = fctrl[F_TSUM], tc = fctrl[F_TCOMP];
  T y = sub_rn(dt, tc);
  T tn = add_rn(ts, y);
  T tc2 = sub_rn(sub_rn(tn, ts), y);
  int n_ev = ctrl[C_SS_NEV];
  int n_done = 0, n_act = 0;
  T* ring_t = packed + 7 + 2 * k_max;
  T* ring_id = ring_t + ring_n;
  int per = (V + blockDim.x - 1) / blockDim.x;
  int lo = threadIdx.x * per;
  int hi = min(V, lo + per);
  if (ok) {
    int cnt = 0;
    for (int v = lo; v < hi; ++v) cnt += done[v];
    int ex = block_exclusive_scan(cnt, &n_done);
    int pos = n_ev + ex;
    for (int v = lo; v < hi; ++v) {
      if (done[v]) {
        ring_t[pos] = tn;
        ring_id[pos] = T(ids[v]);
        ++pos;
      }
    }
  }
  int n_new = n_ev + n_done;
  if (f_fire) {
    // the fault fires after this advance's completions
    if (threadIdx.x == 0) {
      int slot = arm.tape_slot[tpos];
      ring_t[n_new] = tn;
      ring_id[n_new] = T(-(1 + slot));
      arm.c_bound[slot] = arm.tape_val[tpos];
    }
    n_new += 1;
  }
  if (a_any) {
    // activations after completions and the fault entry, in slot order
    double nt = evf[EV_NEXT_T];
    int cnt = 0;
    for (int v = lo; v < hi; ++v) cnt += arm.ready[v] <= nt;
    int ex = block_exclusive_scan(cnt, &n_act);
    int pos = n_new + ex;
    for (int v = lo; v < hi; ++v) {
      if (arm.ready[v] <= nt) {
        ring_t[pos] = tn;
        ring_id[pos] = T(-(1 + arm.n_c + ids[v]));
        arm.pen[v] = T(1);
        arm.ready[v] = inf_v<double>();
        ++pos;
      }
    }
    n_new += n_act;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int adv = ctrl[C_SS_ADV];
    if (ok) {
      packed[7 + adv] = dt;
      packed[7 + k_max + adv] = T(n_new);
      fctrl[F_TSUM] = tn;
      fctrl[F_TCOMP] = tc2;
      ctrl[C_SS_NEV] = n_new;
      ctrl[C_SS_ADV] = adv + 1;
      ctrl[C_TPOS] = tpos + (f_fire ? 1 : 0);
      ctrl[C_PENDING] -= n_act;
    }
    ctrl[C_ADV_OK] = ok;
    ctrl[C_SS_ROUNDS] += ctrl[C_IT];
    ctrl[C_SS_FLAG] = !conv ? FLAG_BUDGET
                            : (finite_v(dt) ? FLAG_OK : FLAG_STALLED);
    ctrl[C_SS_NLIVE] = ctrl[C_LIVE_ACC] + n_act;
  }
}

__global__ void ss_zero_le(int* ctrl) {
  ctrl[(long long)blockIdx.y * N_CTRL + C_LE_ACC] = 0;
}

template <typename T>
__global__ void ss_live_elems(int E, const int* __restrict__ e_var,
                              const T* __restrict__ e_w,
                              const T* __restrict__ pen, int* ctrl, int V,
                              long long s_ew) {
  long long b = blockIdx.y;
  e_w += b * s_ew;
  pen += b * V;
  ctrl += b * N_CTRL;
  int n = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x)
    n += e_w[e] > T(0) && pen[e_var[e]] > T(0);
  int tot = block_sum(n);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_LE_ACC, tot);
}

template <typename T>
__global__ void ss_stats(T* packed, const int* ctrl, const T* fctrl,
                         double* clk, long long psize) {
  long long b = blockIdx.y;
  packed += b * psize;
  ctrl += b * N_CTRL;
  fctrl += b * N_FCTRL;
  if (clk) clk += 2 * b;
  if (clk) {
    clk[0] = (double)fctrl[F_TSUM];
    clk[1] = (double)fctrl[F_TCOMP];
  }
  packed[0] = T(ctrl[C_SS_ROUNDS]);
  packed[1] = T(ctrl[C_SS_ADV]);
  packed[2] = T(ctrl[C_SS_NEV]);
  packed[3] = fctrl[F_TSUM];
  packed[4] = T(ctrl[C_SS_NLIVE]);
  packed[5] = ctrl[C_SS_STARVED] ? T(-1) : T(ctrl[C_SS_FLAG]);
  packed[6] = T(ctrl[C_LE_ACC]);
}

template <typename T>
int reset_t(int B, int V, const void* pen, void* ctrl, void* fctrl, int k,
            int budget, int stop, void* evf, double t0, int tpos,
            const void* ready, const void* clk, const void* k_arr,
            const void* t0_arr, const void* tpos_arr, cudaStream_t s) {
  ss_reset<T><<<grid_r(B), 1024, 0, s>>>(
      V, (const T*)pen, (int*)ctrl, (T*)fctrl, k, budget, stop,
      (double*)evf, t0, tpos, (const double*)ready, (const double*)clk,
      (const int*)k_arr, (const double*)t0_arr, (const int*)tpos_arr);
  return (int)cudaGetLastError();
}

template <typename T>
int commit_t(int B, int V, const void* done, const void* ids, void* packed,
             void* ctrl, void* fctrl, int k_max, int ring_n,
             const void* evf, const void* tape_slot, const void* tape_val,
             int n_tape, void* c_bound, int cb_stride, int n_c, void* ready,
             void* pen, cudaStream_t s) {
  Arms<T> arm{(const int*)tape_slot, (const T*)tape_val, n_tape,
              (T*)c_bound, cb_stride, n_c, (double*)ready, (T*)pen};
  ss_commit<T><<<grid_r(B), 1024, 0, s>>>(
      V, (const bool*)done, (const int*)ids, (T*)packed, (int*)ctrl,
      (T*)fctrl, k_max, ring_n, (const double*)evf, arm);
  return (int)cudaGetLastError();
}

template <typename T>
int finish_t(int B, int E, int V, const void* e_var, const void* e_w,
             long long s_ew, const void* pen, void* packed, long long psize,
             void* ctrl, void* fctrl, void* clk, cudaStream_t s) {
  const int TB = 256;
  ss_zero_le<<<grid_r(B), 1, 0, s>>>((int*)ctrl);
  ss_live_elems<T><<<grid_b(E, TB, B), TB, 0, s>>>(
      E, (const int*)e_var, (const T*)e_w, (const T*)pen, (int*)ctrl, V,
      s_ew);
  ss_stats<T><<<grid_r(B), 1, 0, s>>>((T*)packed, (const int*)ctrl,
                                      (const T*)fctrl, (double*)clk, psize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B replicas in one launch each.  ready (f64 activation dates) and clk
// (the f64 Kahan pair) are NULL without a collective; k_arr, t0_arr
// and tpos_arr (per replica) are NULL for the solo scalars.
int superstep_reset(int dbl, int B, int V, const void* pen, void* ctrl,
                    void* fctrl, int k, int budget, int stop, void* evf,
                    double t0, int tpos, const void* ready, const void* clk,
                    const void* k_arr, const void* t0_arr,
                    const void* tpos_arr, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? reset_t<double>(B, V, pen, ctrl, fctrl, k, budget, stop, evf,
                               t0, tpos, ready, clk, k_arr, t0_arr, tpos_arr,
                               s)
             : reset_t<float>(B, V, pen, ctrl, fctrl, k, budget, stop, evf,
                              t0, tpos, ready, clk, k_arr, t0_arr, tpos_arr,
                              s);
}

int superstep_begin(int B, void* ctrl, void* stream) {
  ss_begin<<<grid_r(B), 1, 0, (cudaStream_t)stream>>>((int*)ctrl);
  return (int)cudaGetLastError();
}

int superstep_resume(int B, void* ctrl, void* stream) {
  ss_resume<<<grid_r(B), 1, 0, (cudaStream_t)stream>>>((int*)ctrl);
  return (int)cudaGetLastError();
}

// tape_slot/tape_val/c_bound are NULL without a tape, ready/pen without
// a collective; n_tape and cb_stride are the per-replica strides of the
// tape rows and the bounds, n_c the collective arm's ring id offset.
int superstep_commit(int dbl, int B, int V, const void* done,
                     const void* ids, void* packed, void* ctrl, void* fctrl,
                     int k_max, int ring_n, const void* evf,
                     const void* tape_slot, const void* tape_val, int n_tape,
                     void* c_bound, int cb_stride, int n_c, void* ready,
                     void* pen, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? commit_t<double>(B, V, done, ids, packed, ctrl, fctrl, k_max,
                                ring_n, evf, tape_slot, tape_val, n_tape,
                                c_bound, cb_stride, n_c, ready, pen, s)
             : commit_t<float>(B, V, done, ids, packed, ctrl, fctrl, k_max,
                               ring_n, evf, tape_slot, tape_val, n_tape,
                               c_bound, cb_stride, n_c, ready, pen, s);
}

// s_ew: the per-replica stride of e_w (0: shared); psize: the stride of
// one replica's packed row.
int superstep_finish(int dbl, int B, int E, int V, const void* e_var,
                     const void* e_w, long long s_ew, const void* pen,
                     void* packed, long long psize, void* ctrl, void* fctrl,
                     void* clk, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? finish_t<double>(B, E, V, e_var, e_w, s_ew, pen, packed,
                                psize, ctrl, fctrl, clk, s)
             : finish_t<float>(B, E, V, e_var, e_w, s_ew, pen, packed, psize,
                               ctrl, fctrl, clk, s);
}

}  // extern "C"
