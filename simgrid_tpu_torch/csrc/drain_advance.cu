// K2 drain_advance: the dt/retire step of the drain, and its forced mode.
//
// Replaces: simgrid_tpu/ops/lmm_drain.py `_advance_math` with
// `_rounded_product` (:147-189) and the `_drain_advance` program
// (:192-200): dt = min rem/rate over flowing flows, rem - rate*dt with
// the product rounded on its own, strict `< thresh` retirement, and the
// live count.  `drain_forced_advance` replaces `_drain_forced_advance`
// (:584-603): the same update and retirement at a delta the host gives
// (an engine advance decided elsewhere), run unconditionally.
//
// What bounds it on this card: memory, and at the drain's sizes launch
// latency.  It reads pen, rem, thresh and the rates once for the min
// and once more for the update (V x 4 x 8 B = 3.2 MB at 100k flows in
// f64, about a microsecond at 3.35 TB/s), so every kernel boundary of a
// call (about 2.5 us on the H100) costs more than the bytes.
//
// What the design does about it: two launches a call, and no launch of
// one thread.  `adv_min` (the min pass) derives the gate and the
// convergence from the control words in every block (read only; thread
// 0 of block 0 writes them back, with the STARVED hand-back and the
// cleared words), folds the min with a per-block reduction and one
// unsigned atomicMin per block on the bits of the non-negative quotient
// (exact: IEEE order of non-negative floats is the integer order of
// their bits), and its last block (`last_block`: a fence and a
// per-replica ticket) reads the final bits, does the event peek and
// clamp, writes dt to fctrl[F_DT] and resets the bit slots to the key
// of +inf for the next call (a Work creates them so).  `adv_apply` (the
// update) is one elementwise pass that reads dt from fctrl[F_DT] and
// counts live flows with one atomic per block into C_LIVE_ACC, which
// the min pass cleared.  A grid sync in place of the boundary between
// the two costs more than the boundary on this card (PERF.md, PR 8);
// the apply pass is a programmatic dependent launch instead, so its
// launch overlaps the min pass (`launch_dependent`, common.cuh).
// `rem - rate*dt` is written __dsub_rn(rem, __dmul_rn(rate, dt))
// (__fsub_rn/__fmul_rn in f32), which pins `_rounded_product` whatever
// the compiler flags.  The forced mode is one launch: each block adds
// its live count to the ticket, and the last block stores the total in
// C_LIVE_ACC.
//
// The event arm (a fault tape, a collective schedule or both) replaces
// the `has_tape or has_coll` branch of the superstep body
// (simgrid_tpu/ops/lmm_drain.py:363-401).  After the planned dt (the
// same min), the min pass's last block peeks the next event: the next
// tape date `tape_t[tpos]` while `tpos < T`, the earliest pending
// activation `min(ready)` (folded by the same pass, an unsigned
// atomicMin on the bits of non-negative f64 dates, +inf included), and
// the clock `now = t0 + t_sum` (tape) or `t_sum` (collective clocks are
// absolute).  The advance fires when the event date lies inside it,
// `next_t <= now + dt_plan` (ties go to the event; a pending event
// rescues an infinite plan), and dt is clamped to land on it:
// `dt = (T) max(next_t - now, 0)`.  All of that clock arithmetic is
// f64 with explicit round-to-nearest adds, also on an f32 drain, as in
// JAX.  The clamped dt goes to fctrl[F_DT], so the retire below is
// unchanged; `fire`, `f_fire = fire && next_ft <= next_at` and
// `a_any = fire && next_at <= next_ft` go to control words for K3, and
// the event date to `evf[EV_NEXT_T]`.
//
// In a superstep (gated=1) the step runs only in an active advance
// slot; when the fixpoint it follows has neither converged nor spent
// its JAX round limit, the queued rounds ran out first: the step marks
// the superstep STARVED and does nothing, and the host resumes the same
// advance with more rounds.  The flow state is updated only when the
// fixpoint converged and dt is finite (the JAX `ok` select).

// The replica axis (simgrid_tpu/ops/lmm_batch.py, the fleet superstep
// and the fused rescue, `_batch_fused_fresh`/`_cont` `:564/:584`):
// blockIdx.y picks the replica; its flow state, rates, completion mask,
// control words, dt/min-date bit slots, event clock and tape row move
// to its row, so each replica's minima are its own (one shared
// atomicMin slot would mix replicas).  Gated mode 2 is the fused
// rescue's guard: the step runs in the replicas whose SS_ACTIVE is set,
// with no STARVED hand-back (the host checks convergence per chunk).

#include "common.cuh"

namespace {

// The gate of an advance, from control words no block of the call
// writes before reading them (C_SS_STARVED is written, by one thread,
// only to say what every block derives anyway).
__device__ __forceinline__ int adv_gate(const int* ctrl, int gated,
                                        bool* starve) {
  *starve = false;
  if (gated == 2) return ctrl[C_SS_ACTIVE];
  if (!gated) return 1;
  int go = ctrl[C_SS_ACTIVE] && !ctrl[C_SS_STARVED];
  if (go && ctrl[C_LIGHT] > 0 && ctrl[C_IT] < ctrl[C_LIMIT]) {
    *starve = true;
    go = 0;
  }
  return go;
}

// The min pass, the event peek and the dt (see the header).
template <typename T>
__global__ void adv_min(int V, const T* __restrict__ pen,
                        const T* __restrict__ rem,
                        const T* __restrict__ rate,
                        unsigned long long* dtbits,
                        const double* __restrict__ ready,
                        unsigned long long* atbits, int* ctrl, T* fctrl,
                        double* evf, const double* __restrict__ tape_t,
                        int n_tape, int gated) {
  // the apply pass may be scheduled now: it waits for this grid's end
  pdl_trigger();
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  bool starve;
  int go = adv_gate(ctrl, gated, &starve);
  bool conv = ctrl[C_LIGHT] == 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (starve) ctrl[C_SS_STARVED] = 1;
    ctrl[C_ADV_GO] = go;
    ctrl[C_ADV_CONV] = conv;
    ctrl[C_LIVE_ACC] = 0;
    ctrl[C_ADV_OK] = 0;
    if (!go) {
      // with go the last block writes them
      ctrl[C_FIRE] = 0;
      ctrl[C_FFIRE] = 0;
      ctrl[C_AANY] = 0;
    }
  }
  if (!go) return;
  pen += b * V;
  rem += b * V;
  rate += b * V;
  dtbits += b;
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  if (ready) {
    ready += b * V;
    atbits += b;
  }
  if (tape_t) tape_t += b * n_tape;
  if (conv) {
    T m = inf_v<T>();
    double a = inf_v<double>();
    for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
         v += gridDim.x * blockDim.x) {
      T r = pen[v] > T(0) ? rate[v] : T(0);
      if (r > T(0)) m = min_v(m, div_rn(rem[v], r));
      if (ready) a = min_v(a, ready[v]);
    }
    block_min_to(m, dtbits);
    if (ready) {
      __syncthreads();
      block_min_to(a, atbits);
    }
  }
  unsigned unused;
  if (!last_block(ticket_of(ctrl), 0, &unused) || threadIdx.x != 0) return;
  // the last block: the final minima, reset for the next call
  const double inf = inf_v<double>();
  T dt = from_key<T>(atomicExch(dtbits, key_of(inf_v<T>())));
  double next_at =
      ready ? from_key<double>(atomicExch(atbits, key_of(inf))) : inf;
  int fire = 0, f_fire = 0, a_any = 0;
  if (conv && (tape_t || ready)) {
    int tpos = ctrl[C_TPOS];
    double next_ft = (tape_t && tpos < n_tape) ? tape_t[tpos] : inf;
    double ts = (double)fctrl[F_TSUM];
    double now = ready ? ts : __dadd_rn(evf[EV_T0], ts);
    double next_t = next_at < next_ft ? next_at : next_ft;
    fire = isfinite(next_t) && next_t <= __dadd_rn(now, (double)dt);
    if (fire) {
      double gap = __dsub_rn(next_t, now);
      if (gap < 0.0) gap = 0.0;
      dt = from_f64<T>(gap);
    }
    f_fire = fire && next_ft <= next_at;
    a_any = fire && next_at <= next_ft;
    evf[EV_NEXT_T] = next_t;
  }
  // without convergence no block folded a minimum: dt is +inf
  fctrl[F_DT] = dt;
  ctrl[C_FIRE] = fire;
  ctrl[C_FFIRE] = f_fire;
  ctrl[C_AANY] = a_any;
}

template <typename T>
__global__ void adv_apply(int V, T* pen, T* rem, const T* __restrict__ thresh,
                          const T* __restrict__ rate, bool* done, int* ctrl,
                          const T* fctrl) {
  pdl_wait();
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!ctrl[C_ADV_GO]) return;
  pen += b * V;
  rem += b * V;
  thresh += b * V;
  rate += b * V;
  done += b * V;
  fctrl += b * N_FCTRL;
  T dt = fctrl[F_DT];
  bool ok = ctrl[C_ADV_CONV] && finite_v(dt);
  int live = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    T p = pen[v];
    bool d = false;
    if (ok && p > T(0)) {
      T r = rate[v];
      if (r > T(0)) {
        T r2 = sub_rn(rem[v], mul_rn(r, dt));
        d = r2 < thresh[v];
        if (d) {
          p = T(0);
          pen[v] = p;
          r2 = T(0);
        }
        rem[v] = r2;
      }
    }
    done[v] = d;
    live += p > T(0);
  }
  int tot = block_sum(live);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_LIVE_ACC, tot);
}

template <typename T>
int launch(int B, int V, void* pen, void* rem, const void* thresh,
           const void* rate, void* done, void* ctrl, void* fctrl,
           void* dtbits, int gated, void* evf, void* atbits,
           const void* tape_t, int n_tape, const void* ready,
           cudaStream_t s) {
  const int TB = 256;
  dim3 g = grid_b(V, TB, B);
  unsigned long long* ab = ready ? (unsigned long long*)atbits : nullptr;
  adv_min<T><<<g, TB, 0, s>>>(V, (const T*)pen, (const T*)rem,
                              (const T*)rate, (unsigned long long*)dtbits,
                              (const double*)ready, ab, (int*)ctrl,
                              (T*)fctrl, (double*)evf, (const double*)tape_t,
                              n_tape, gated);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_dependent(adv_apply<T>, g, TB, s, V, (T*)pen, (T*)rem,
                               (const T*)thresh, (const T*)rate, (bool*)done,
                               (int*)ctrl, (const T*)fctrl);
}

template <typename T>
__global__ void fadv_apply(int V, T* pen, T* rem, const T* __restrict__ thresh,
                           const T* __restrict__ rate, bool* done, T delta,
                           int* ctrl) {
  int live = 0;
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    T p = pen[v];
    bool d = false;
    if (p > T(0)) {
      T r = rate[v];
      if (r > T(0)) {
        T r2 = sub_rn(rem[v], mul_rn(r, delta));
        d = r2 < thresh[v];
        if (d) {
          p = T(0);
          pen[v] = p;
          r2 = T(0);
        }
        rem[v] = r2;
      }
    }
    done[v] = d;
    live += p > T(0);
  }
  unsigned tot;
  if (last_block(ticket_of(ctrl), (unsigned)block_sum(live), &tot) &&
      threadIdx.x == 0)
    ctrl[C_LIVE_ACC] = (int)tot;
}

template <typename T>
int launch_forced(int V, void* pen, void* rem, const void* thresh,
                  const void* rate, void* done, void* ctrl, double delta,
                  cudaStream_t s) {
  const int TB = 256;
  fadv_apply<T><<<grid_for(V, TB), TB, 0, s>>>(
      V, (T*)pen, (T*)rem, (const T*)thresh, (const T*)rate, (bool*)done,
      (T)delta, (int*)ctrl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int drain_forced_advance(int dbl, int V, void* pen, void* rem,
                                    const void* thresh, const void* rate,
                                    void* done, void* ctrl, double delta,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    return launch_forced<double>(V, pen, rem, thresh, rate, done, ctrl,
                                 delta, s);
  return launch_forced<float>(V, pen, rem, thresh, rate, done, ctrl, delta,
                              s);
}

// tape_t (f64 dates, n_tape of them per replica) and ready (f64
// activation dates) are NULL when their arm is off; evf and atbits are
// read only by the event arm.  B replicas in one launch.
extern "C" int drain_advance(int dbl, int B, int V, void* pen, void* rem,
                             const void* thresh, const void* rate,
                             void* done, void* ctrl, void* fctrl,
                             void* dtbits, int gated, void* evf,
                             void* atbits, const void* tape_t, int n_tape,
                             const void* ready, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    return launch<double>(B, V, pen, rem, thresh, rate, done, ctrl, fctrl,
                          dtbits, gated, evf, atbits, tape_t, n_tape, ready,
                          s);
  return launch<float>(B, V, pen, rem, thresh, rate, done, ctrl, fctrl,
                       dtbits, gated, evf, atbits, tape_t, n_tape, ready, s);
}
