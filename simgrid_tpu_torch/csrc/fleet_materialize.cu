// K11 fleet_materialize: a fleet's per-replica state, built on the card
// from the shared base arrays and each replica's compact payload.
//
// Replaces: simgrid_tpu/ops/lmm_batch.py `_materialize` (:390-407) and
// `_materialize_ew` (:375-388), the fleet's birth, and the admission of
// one replica into row b of a live fleet, `_admit_lane_state` (:409-437),
// `_admit_lane_tape` (:440-449), `_admit_lane_coll` (:453-461) and
// `_admit_lane_ew` (:463-470).  Birth
// and admission are the same kernels over a range of rows [b0, b0+nb):
// the whole fleet, or the one admitted row.
//
// Per replica r (fleet row b0+r), in f64, in the order of
// `derive_replica_arrays` (:298-317), every multiply one __dmul_rn:
//   cb64  = base_cb * bw[r], then cb64[li] *= lf (sorted link slots)
//   sz64  = base_sizes * fs[r], rem64 = base_rem * fs[r],
//           then sz64[fi] *= ff, rem64[fi] *= ff (sorted flow slots)
//   pen64 = base_pen, then pen64[di] = 0 (dead flows)
//   th64  = done_eps * sz64 (done_mode "rel") or done_eps ("abs")
// and the f64 -> dtype casts (__double2float_rn on a float32 fleet).
// A pad slot (index C, resp. V) drops, as JAX's mode="drop".  The slots
// of one payload row are distinct (sorted keys of a dict), so the
// scatters do not race.  Element weights: the shared table copied into
// the row, then ew[ei] = ewv (scatter-SET, pad index E drops).  The
// admitted tape row is a copy of the row the host built (inf-padded).
// A collective fleet's DAG-walk state (`fleet_coll`): rows [b0, b0+nb)
// of the predecessor counts and activation dates become the compiled
// schedule's birth rows and the rows' Kahan clock pairs (0, 0): the
// collective birth (lmm_batch.py:1083-1089, B copies of the base rows)
// over every row, `_admit_lane_coll` over the admitted one.
//
// What bounds it on this card: memory, and at a fleet's sizes launch
// latency.  Birth reads the four base arrays once per replica and writes
// four [B, .] outputs (B x (C + 3V) x 16 B: 6.9 MB at config #4 with
// B = 8, about 2 us at 3.35 TB/s); the payloads are tiny.
//
// What the design does about it: one elementwise pass per row range
// into f64 scratch (the wrapper's), one pass of one block per replica
// over its payload slots, and one elementwise cast pass; no atomics.

#include "common.cuh"

namespace {

// Pointers of `fleet_state`, in the order of kernels/fleet_materialize.py.
struct StateArgs {
  const double* base_cb;
  const double* base_sz;
  const double* base_rem;
  const double* base_pen;
  const double* bw;   // [nb]
  const double* fs;   // [nb]
  const int* li;      // [nb, sl]
  const double* lf;   // [nb, sl]
  const int* fi;      // [nb, sf]
  const double* ff;   // [nb, sf]
  const int* di;      // [nb, sd]
  double* cb64;       // [nb, C] scratch
  double* sz64;       // [nb, V] scratch
  double* rem64;      // [nb, V] scratch
  double* pen64;      // [nb, V] scratch
  void* cb;           // [B, C] dtype, rows b0 .. b0+nb-1 written
  void* pen;          // [B, V]
  void* rem;          // [B, V]
  void* thresh;       // [B, V]
};
#define N_STATE_PTRS 19

__global__ void fm_scale(StateArgs a, int C, int V) {
  long long r = blockIdx.y;
  double bw = a.bw[r], fs = a.fs[r];
  int n = C > V ? C : V;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (i < C) a.cb64[r * C + i] = __dmul_rn(a.base_cb[i], bw);
    if (i < V) {
      a.sz64[r * V + i] = __dmul_rn(a.base_sz[i], fs);
      a.rem64[r * V + i] = __dmul_rn(a.base_rem[i], fs);
      a.pen64[r * V + i] = a.base_pen[i];
    }
  }
}

__global__ void fm_scatter(StateArgs a, int C, int V, int sl, int sf,
                           int sd) {
  long long r = blockIdx.y;
  for (int j = threadIdx.x; j < sl; j += blockDim.x) {
    int c = a.li[r * sl + j];
    if (c >= 0 && c < C) {
      double* x = a.cb64 + r * C + c;
      *x = __dmul_rn(*x, a.lf[r * sl + j]);
    }
  }
  for (int j = threadIdx.x; j < sf; j += blockDim.x) {
    int v = a.fi[r * sf + j];
    if (v >= 0 && v < V) {
      double f = a.ff[r * sf + j];
      a.sz64[r * V + v] = __dmul_rn(a.sz64[r * V + v], f);
      a.rem64[r * V + v] = __dmul_rn(a.rem64[r * V + v], f);
    }
  }
  for (int j = threadIdx.x; j < sd; j += blockDim.x) {
    int v = a.di[r * sd + j];
    if (v >= 0 && v < V) a.pen64[r * V + v] = 0.0;
  }
}

template <typename T>
__global__ void fm_cast(StateArgs a, int C, int V, int b0, double done_eps,
                        int done_rel) {
  long long r = blockIdx.y, b = b0 + r;
  T* cb = (T*)a.cb;
  T* pen = (T*)a.pen;
  T* rem = (T*)a.rem;
  T* th = (T*)a.thresh;
  int n = C > V ? C : V;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (i < C) cb[b * C + i] = from_f64<T>(a.cb64[r * C + i]);
    if (i < V) {
      double sz = a.sz64[r * V + i];
      pen[b * V + i] = from_f64<T>(a.pen64[r * V + i]);
      rem[b * V + i] = from_f64<T>(a.rem64[r * V + i]);
      th[b * V + i] = from_f64<T>(done_rel ? __dmul_rn(done_eps, sz)
                                           : done_eps);
    }
  }
}

template <typename T>
__global__ void fm_ew_copy(const T* __restrict__ base, T* ew, long long E,
                           int b0) {
  long long b = b0 + (long long)blockIdx.y;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < E;
       e += (long long)gridDim.x * blockDim.x)
    ew[b * E + e] = base[e];
}

template <typename T>
__global__ void fm_ew_set(T* ew, long long E, int b0, const int* ei,
                          const T* ewv, int se) {
  long long r = blockIdx.y, b = b0 + r;
  for (int j = threadIdx.x; j < se; j += blockDim.x) {
    long long e = ei[r * se + j];
    if (e >= 0 && e < E) ew[b * E + e] = ewv[r * se + j];
  }
}

template <typename T>
__global__ void fm_tape(int b, int n, double* tt, int* ts, T* tv,
                        const double* row_t, const int* row_s,
                        const T* row_v) {
  long long o = (long long)b * n;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    tt[o + j] = row_t[j];
    ts[o + j] = row_s[j];
    tv[o + j] = row_v[j];
  }
}

__global__ void fm_coll(int V, int b0, int* pred, double* ready,
                        double* clk, const int* __restrict__ row_p,
                        const double* __restrict__ row_r) {
  long long b = b0 + (long long)blockIdx.y;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V;
       i += gridDim.x * blockDim.x) {
    pred[b * V + i] = row_p[i];
    ready[b * V + i] = row_r[i];
  }
  if (blockIdx.x == 0 && threadIdx.x < 2) clk[2 * b + threadIdx.x] = 0.0;
}

const int TB = 256;

template <typename T>
int state_t(int nb, int b0, int C, int V, StateArgs a, int sl, int sf,
            int sd, double done_eps, int done_rel, cudaStream_t s) {
  int n = C > V ? C : V;
  fm_scale<<<grid_b(n, TB, nb), TB, 0, s>>>(a, C, V);
  fm_scatter<<<grid_r(nb), TB, 0, s>>>(a, C, V, sl, sf, sd);
  fm_cast<T><<<grid_b(n, TB, nb), TB, 0, s>>>(a, C, V, b0, done_eps,
                                               done_rel);
  return (int)cudaGetLastError();
}

template <typename T>
int ew_t(int nb, int b0, long long E, const void* base, void* ew,
         const void* ei, const void* ewv, int se, cudaStream_t s) {
  fm_ew_copy<T><<<grid_b(E, TB, nb), TB, 0, s>>>((const T*)base, (T*)ew, E,
                                                 b0);
  fm_ew_set<T><<<grid_r(nb), TB, 0, s>>>((T*)ew, E, b0, (const int*)ei,
                                         (const T*)ewv, se);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows [b0, b0+nb) of the fleet's bounds, penalties, remains and
// thresholds from the base arrays and nb payload rows (birth: b0 = 0,
// nb = B; admission: nb = 1, b0 = the admitted row).
int fleet_state(int dbl, int nb, int b0, int C, int V, void** p, int n_ptrs,
                int sl, int sf, int sd, double done_eps, int done_rel,
                void* stream) {
  if (n_ptrs != N_STATE_PTRS || nb < 1 || nb > 65535)
    return (int)cudaErrorInvalidValue;
  StateArgs a{(const double*)p[0], (const double*)p[1], (const double*)p[2],
              (const double*)p[3], (const double*)p[4], (const double*)p[5],
              (const int*)p[6],    (const double*)p[7], (const int*)p[8],
              (const double*)p[9], (const int*)p[10],   (double*)p[11],
              (double*)p[12],      (double*)p[13],      (double*)p[14],
              p[15],               p[16],               p[17],
              p[18]};
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? state_t<double>(nb, b0, C, V, a, sl, sf, sd, done_eps,
                               done_rel, s)
             : state_t<float>(nb, b0, C, V, a, sl, sf, sd, done_eps,
                              done_rel, s);
}

// Rows [b0, b0+nb) of the fleet's [B, E] element weights: the shared
// table, then the payload's scatter-SET.
int fleet_ew(int dbl, int nb, int b0, long long E, const void* base,
             void* ew, const void* ei, const void* ewv, int se,
             void* stream) {
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? ew_t<double>(nb, b0, E, base, ew, ei, ewv, se, s)
             : ew_t<float>(nb, b0, E, base, ew, ei, ewv, se, s);
}

// Row b of the fleet's [B, n] tape (dates f64, slots int32, bounds in
// the fleet's dtype) from the admitted row.
int fleet_tape(int dbl, int b, int n, void* tt, void* ts, void* tv,
               const void* row_t, const void* row_s, const void* row_v,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int g = grid_for(n, TB);
  if (dbl)
    fm_tape<double><<<g, TB, 0, s>>>(b, n, (double*)tt, (int*)ts,
                                     (double*)tv, (const double*)row_t,
                                     (const int*)row_s,
                                     (const double*)row_v);
  else
    fm_tape<float><<<g, TB, 0, s>>>(b, n, (double*)tt, (int*)ts, (float*)tv,
                                    (const double*)row_t, (const int*)row_s,
                                    (const float*)row_v);
  return (int)cudaGetLastError();
}

// Rows [b0, b0+nb) of a collective fleet's [B, V] predecessor counts
// (int32) and activation dates (f64) from the schedule's birth rows, and
// their [B, 2] Kahan clock pairs set to (0, 0).
int fleet_coll(int nb, int b0, int V, void* pred, void* ready, void* clk,
               const void* row_p, const void* row_r, void* stream) {
  if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
  fm_coll<<<grid_b(V, TB, nb), TB, 0, (cudaStream_t)stream>>>(
      V, b0, (int*)pred, (double*)ready, (double*)clk, (const int*)row_p,
      (const double*)row_r);
  return (int)cudaGetLastError();
}

}  // extern "C"
