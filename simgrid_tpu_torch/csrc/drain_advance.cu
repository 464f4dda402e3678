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
// In a superstep (gated=1) the step runs only in an active advance
// slot; when the fixpoint it follows has neither converged nor spent
// its JAX round limit, the queued rounds ran out first: the step marks
// the superstep STARVED and does nothing, and the host resumes the same
// advance with more rounds.  The flow state is updated only when the
// fixpoint converged and dt is finite (the JAX `ok` select).

#include "common.cuh"

namespace {

template <typename T>
__global__ void adv_pre(int* ctrl, unsigned long long* dtbits, int gated) {
  int go = 1;
  if (gated) {
    go = ctrl[C_SS_ACTIVE] && !ctrl[C_SS_STARVED];
    if (go && ctrl[C_LIGHT] > 0 && ctrl[C_IT] < ctrl[C_LIMIT]) {
      ctrl[C_SS_STARVED] = 1;
      go = 0;
    }
  }
  ctrl[C_ADV_GO] = go;
  ctrl[C_ADV_CONV] = ctrl[C_LIGHT] == 0;
  ctrl[C_LIVE_ACC] = 0;
  *dtbits = key_of(inf_v<T>());
}

template <typename T>
__global__ void adv_min(int V, const T* __restrict__ pen,
                        const T* __restrict__ rem,
                        const T* __restrict__ rate,
                        unsigned long long* dtbits, const int* ctrl) {
  if (!(ctrl[C_ADV_GO] && ctrl[C_ADV_CONV])) return;
  T m = inf_v<T>();
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    T r = pen[v] > T(0) ? rate[v] : T(0);
    if (r > T(0)) m = min_v(m, div_rn(rem[v], r));
  }
  m = warp_min(m);
  __shared__ T wmin[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) wmin[wid] = m;
  __syncthreads();
  if (wid == 0) {
    int nw = blockDim.x >> 5;
    T x = lane < nw ? wmin[lane] : inf_v<T>();
    x = warp_min(x);
    if (lane == 0 && x < inf_v<T>()) atomicMin(dtbits, key_of(x));
  }
}

template <typename T>
__global__ void adv_apply(int V, T* pen, T* rem, const T* __restrict__ thresh,
                          const T* __restrict__ rate, bool* done,
                          const unsigned long long* dtbits, int* ctrl,
                          T* fctrl) {
  if (!ctrl[C_ADV_GO]) return;
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
int launch(int V, void* pen, void* rem, const void* thresh,
           const void* rate, void* done, void* ctrl, void* fctrl,
           void* dtbits, int gated, cudaStream_t s) {
  const int TB = 256;
  int g = grid_for(V, TB);
  adv_pre<T><<<1, 1, 0, s>>>((int*)ctrl, (unsigned long long*)dtbits,
                             gated);
  adv_min<T><<<g, TB, 0, s>>>(V, (const T*)pen, (const T*)rem,
                              (const T*)rate, (unsigned long long*)dtbits,
                              (const int*)ctrl);
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

extern "C" int drain_advance(int dbl, int V, void* pen, void* rem,
                             const void* thresh, const void* rate,
                             void* done, void* ctrl, void* fctrl,
                             void* dtbits, int gated, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dbl)
    return launch<double>(V, pen, rem, thresh, rate, done, ctrl, fctrl,
                          dtbits, gated, s);
  return launch<float>(V, pen, rem, thresh, rate, done, ctrl, fctrl, dtbits,
                       gated, s);
}
