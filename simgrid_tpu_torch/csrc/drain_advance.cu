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
// f64, about a microsecond at 3.35 TB/s), so three short launches cost
// more than the bytes.
//
// What the design does about it: the min is one pass with a per-block
// reduction and one unsigned atomicMin per block on the bits of the
// non-negative quotient (exact: IEEE order of non-negative floats is
// the integer order of their bits); the update is one elementwise pass
// that also counts live flows with one atomic per block.
// `rem - rate*dt` is written __dsub_rn(rem, __dmul_rn(rate, dt))
// (__fsub_rn/__fmul_rn in f32), which pins `_rounded_product` whatever
// the compiler flags.
//
// The event arm (a fault tape, a collective schedule or both) replaces
// the `has_tape or has_coll` branch of the superstep body
// (simgrid_tpu/ops/lmm_drain.py:363-401).  After the planned dt (the
// same min), `adv_event` peeks the next event: the next tape date
// `tape_t[tpos]` while `tpos < T`, the earliest pending activation
// `min(ready)` (folded by `adv_min` in the same pass, an unsigned
// atomicMin on the bits of non-negative f64 dates, +inf included), and
// the clock `now = t0 + t_sum` (tape) or `t_sum` (collective clocks are
// absolute).  The advance fires when the event date lies inside it,
// `next_t <= now + dt_plan` (ties go to the event; a pending event
// rescues an infinite plan), and dt is clamped to land on it:
// `dt = (T) max(next_t - now, 0)`.  All of that clock arithmetic is
// f64 with explicit round-to-nearest adds, also on an f32 drain, as in
// JAX.  The clamped dt replaces the planned one in `dtbits`, so the
// retire below is unchanged; `fire`, `f_fire = fire && next_ft <=
// next_at` and `a_any = fire && next_at <= next_ft` go to control words
// for K3, and the event date to `evf[EV_NEXT_T]`.
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

template <typename T>
__global__ void adv_pre(int* ctrl, unsigned long long* dtbits,
                        unsigned long long* atbits, int gated) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  dtbits += b;
  if (atbits) atbits += b;
  int go = 1;
  if (gated == 2) {
    go = ctrl[C_SS_ACTIVE];
  } else if (gated) {
    go = ctrl[C_SS_ACTIVE] && !ctrl[C_SS_STARVED];
    if (go && ctrl[C_LIGHT] > 0 && ctrl[C_IT] < ctrl[C_LIMIT]) {
      ctrl[C_SS_STARVED] = 1;
      go = 0;
    }
  }
  ctrl[C_ADV_GO] = go;
  ctrl[C_ADV_CONV] = ctrl[C_LIGHT] == 0;
  ctrl[C_LIVE_ACC] = 0;
  ctrl[C_ADV_OK] = 0;
  ctrl[C_FIRE] = 0;
  ctrl[C_FFIRE] = 0;
  ctrl[C_AANY] = 0;
  *dtbits = key_of(inf_v<T>());
  if (atbits) *atbits = key_of(inf_v<double>());
}

template <typename T>
__global__ void adv_min(int V, const T* __restrict__ pen,
                        const T* __restrict__ rem,
                        const T* __restrict__ rate,
                        unsigned long long* dtbits,
                        const double* __restrict__ ready,
                        unsigned long long* atbits, const int* ctrl) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!(ctrl[C_ADV_GO] && ctrl[C_ADV_CONV])) return;
  pen += b * V;
  rem += b * V;
  rate += b * V;
  dtbits += b;
  if (ready) {
    ready += b * V;
    atbits += b;
  }
  T m = inf_v<T>();
  double a = inf_v<double>();
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    T r = pen[v] > T(0) ? rate[v] : T(0);
    if (r > T(0)) m = min_v(m, div_rn(rem[v], r));
    if (ready) a = min_v(a, ready[v]);
  }
  m = warp_min(m);
  __shared__ T wmin[32];
  __shared__ double amin[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) wmin[wid] = m;
  if (ready) {
    a = warp_min(a);
    if (lane == 0) amin[wid] = a;
  }
  __syncthreads();
  if (wid == 0) {
    int nw = blockDim.x >> 5;
    T x = lane < nw ? wmin[lane] : inf_v<T>();
    x = warp_min(x);
    if (lane == 0 && x < inf_v<T>()) atomicMin(dtbits, key_of(x));
    if (ready) {
      double y = lane < nw ? amin[lane] : inf_v<double>();
      y = warp_min(y);
      if (lane == 0 && y < inf_v<double>()) atomicMin(atbits, key_of(y));
    }
  }
}

// The event peek and the dt clamp (one thread; see the header).
template <typename T>
__global__ void adv_event(int* ctrl, const T* fctrl,
                          unsigned long long* dtbits,
                          const unsigned long long* atbits, double* evf,
                          const double* __restrict__ tape_t, int n_tape,
                          int has_ready) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!(ctrl[C_ADV_GO] && ctrl[C_ADV_CONV])) return;
  fctrl += b * N_FCTRL;
  dtbits += b;
  if (atbits) atbits += b;
  evf += b * N_EVF;
  if (tape_t) tape_t += b * n_tape;
  const double inf = inf_v<double>();
  T dt_plan = from_key<T>(*dtbits);
  int tpos = ctrl[C_TPOS];
  double next_ft = (tape_t && tpos < n_tape) ? tape_t[tpos] : inf;
  double next_at = has_ready ? from_key<double>(*atbits) : inf;
  double ts = (double)fctrl[F_TSUM];
  double now = has_ready ? ts : __dadd_rn(evf[EV_T0], ts);
  double next_t = next_at < next_ft ? next_at : next_ft;
  bool fire = isfinite(next_t) && next_t <= __dadd_rn(now, (double)dt_plan);
  if (fire) {
    double gap = __dsub_rn(next_t, now);
    if (gap < 0.0) gap = 0.0;
    *dtbits = key_of(from_f64<T>(gap));
  }
  ctrl[C_FIRE] = fire;
  ctrl[C_FFIRE] = fire && next_ft <= next_at;
  ctrl[C_AANY] = fire && next_at <= next_ft;
  evf[EV_NEXT_T] = next_t;
}

template <typename T>
__global__ void adv_apply(int V, T* pen, T* rem, const T* __restrict__ thresh,
                          const T* __restrict__ rate, bool* done,
                          const unsigned long long* dtbits, int* ctrl,
                          T* fctrl) {
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  if (!ctrl[C_ADV_GO]) return;
  pen += b * V;
  rem += b * V;
  thresh += b * V;
  rate += b * V;
  done += b * V;
  dtbits += b;
  fctrl += b * N_FCTRL;
  T dt = from_key<T>(*dtbits);
  bool ok = ctrl[C_ADV_CONV] && finite_v(dt);
  if (blockIdx.x == 0 && threadIdx.x == 0) fctrl[F_DT] = dt;
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
  bool event = tape_t != nullptr || ready != nullptr;
  unsigned long long* ab = ready ? (unsigned long long*)atbits : nullptr;
  adv_pre<T><<<grid_r(B), 1, 0, s>>>((int*)ctrl, (unsigned long long*)dtbits,
                                     ab, gated);
  adv_min<T><<<g, TB, 0, s>>>(V, (const T*)pen, (const T*)rem,
                              (const T*)rate, (unsigned long long*)dtbits,
                              (const double*)ready, ab, (const int*)ctrl);
  if (event)
    adv_event<T><<<grid_r(B), 1, 0, s>>>((int*)ctrl, (const T*)fctrl,
                                 (unsigned long long*)dtbits, ab,
                                 (double*)evf, (const double*)tape_t,
                                 n_tape, ready != nullptr);
  adv_apply<T><<<g, TB, 0, s>>>(V, (T*)pen, (T*)rem, (const T*)thresh,
                                (const T*)rate, (bool*)done,
                                (const unsigned long long*)dtbits,
                                (int*)ctrl, (T*)fctrl);
  return (int)cudaGetLastError();
}

__global__ void fadv_pre(int* ctrl) { ctrl[C_LIVE_ACC] = 0; }

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
  int tot = block_sum(live);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_LIVE_ACC, tot);
}

template <typename T>
int launch_forced(int V, void* pen, void* rem, const void* thresh,
                  const void* rate, void* done, void* ctrl, double delta,
                  cudaStream_t s) {
  const int TB = 256;
  fadv_pre<<<1, 1, 0, s>>>((int*)ctrl);
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
