// K11 fleet_materialize: a fleet's per-replica state, built on the card
// from the shared base arrays and each replica's compact payload.
//
// Replaces: simgrid_tpu/ops/lmm_batch.py `_materialize` (:390-407) and
// `_materialize_ew` (:375-388), the fleet's birth, and the admission of
// one replica into row b of a live fleet, `_admit_lane_state` (:409-437),
// `_admit_lane_tape` (:440-449), `_admit_lane_coll` (:453-461) and
// `_admit_lane_ew` (:463-470), with a collective fleet's birth rows
// (lmm_batch.py:1083-1089, B copies of the schedule's rows).  Birth and
// admission are one entry over a range of rows [b0, b0+nb): the whole
// fleet, or the one admitted row.
//
// Per replica r (fleet row b0+r), in f64, in the order of
// `derive_replica_arrays` (:298-317), every multiply one __dmul_rn:
//   cb    = base_cb * bw[r], then * lf where the slot is in li[r]
//   sz    = base_sizes * fs[r], rem = base_rem * fs[r],
//           then both * ff where the slot is in fi[r]
//   pen   = 0 where the slot is in di[r], else base_pen
//   th    = done_eps * sz (done_mode "rel") or done_eps ("abs")
// and the f64 -> dtype casts (__double2float_rn on a float32 fleet).
// Element weights: ewv where the slot is in ei[r], else the shared
// table (a SET).  The admitted tape row is the host's entries, padded
// to the fleet's tape width with (inf, C, 0) as the host pads it.
// A collective fleet's rows of predecessor counts and activation dates
// become the schedule's birth rows, their Kahan clock pairs (0, 0).
// Pad slots (C, V or E, last in every row) drop, as JAX's mode="drop".
//
// What bounds it on this card: memory.  Birth writes B rows of every
// output once; at config #4 with B = 8 the [B, E] weight table is most
// of it (121 MB in all: 0.036 ms at 3.35 TB/s).  An admission writes
// one row (27 MB read and written: 0.008 ms), near one launch's own
// latency, so any scratch pass or extra launch shows in its time.  On
// an NVIDIA H100 80GB HBM3 at 700 W (probes/k1_rounds.py `k11_*`) the
// five launches of a birth took 0.082 ms and the six of an admission
// 0.024; this design takes 0.056 and 0.016, one launch each.
//
// What the design does about it: one launch a call, no scratch.  The
// host packs every payload array of the call into one pinned buffer
// (fleet_payload.cuh), which this entry uploads in one copy on the
// call's stream before the launch.  Every slot list of a row is
// strictly increasing with its pads last (the wrapper refuses any
// other), so "is slot i overridden, and by which factor" is a search
// of the row, and nothing waits for a scatter.  The searches are a
// warp's: its lanes find, side by side, where its 32 slots begin in
// each of its rows (a binary search a row), and a row that holds none
// of them (nearly all: payloads are sparse) costs the warp a shuffle
// and a uniform branch; one search a thread a row was latency-bound
// (its dependent loads, row after row: 0.084 ms at birth).  One grid
// of parts, each a multiple of 32 threads so that every warp lies inside
// one part: the constraints [0, C); the flows [0, V) (sizes, remains,
// penalties, thresholds); the elements [0, E) when the fleet has
// per-replica weights; the tape row [0, T) at an admission; the DAG
// rows [0, V) and the clock pairs of a collective fleet.  A thread
// reads its slot's base values once, keeps them in registers and loops
// over the rows it writes (ROWS a block row of the grid), so every
// store of a warp is coalesced and every output byte written once, as
// a streaming store (`__stcs`: no output is read back by this launch).
// Fewer rows a thread would re-read the base arrays once a block row.

#include "common.cuh"
#include "fleet_payload.cuh"

namespace {

// Pointers of `fleet_materialize`, in the order of
// kernels/fleet_materialize.py; the weight, tape and collective ones are
// NULL when the call has no such part.
#define N_FM_PTRS 18

struct FmArgs {
  const double* base_cb;  // [C]
  const double* base_sz;  // [V]
  const double* base_rem;
  const double* base_pen;
  void* cb;               // [B, C] dtype, rows b0 .. b0+nb-1 written
  void* pen;              // [B, V]
  void* rem;
  void* th;
  const void* base_ew;    // [E] dtype
  void* ew;               // [B, E] dtype
  double* tt;             // [B, T]
  int* ts;
  void* tv;               // dtype
  const int* pred0;       // [V]
  const double* ready0;   // [V]
  int* pred;              // [B, V]
  double* ready;          // [B, V]
  double* clk;            // [B, 2]
  const unsigned char* pay;   // the uploaded payload
  long long off[FP_PARTS];    // byte offset of each part in it
  long long E;
  // the parts' ends in the grid's threads (each a multiple of 32)
  long long end_c, end_v, end_e, end_t, end_d;
  int C, V, n_t, n_live, sl, sf, sd, se, nb, b0, done_rel;
  double done_eps;
};

const int TB = 256;
// rows a thread writes (a block row of the grid); more rows take more
// block rows, so a small system with a wide fleet still fills the card.
// At most 16: a warp searches two payload rows of each in its lanes.
const int ROWS = 8;

template <typename X>
__device__ __forceinline__ const X* part(const FmArgs& a, int k) {
  return reinterpret_cast<const X*>(a.pay + a.off[k]);
}

// Position of slot i in a payload row of s slots (strictly increasing,
// pads >= every slot last), or -1.
__device__ __forceinline__ int find_slot(const int* __restrict__ row, int s,
                                         int i) {
  int lo = 0, hi = s;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < i)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < s && __ldg(row + lo) == i ? lo : -1;
}

// Where the warp's slots [w, w+32) begin in each of its rows: lane
// k < nr searches row r0 + k of `idx` (width s) for the first slot
// >= w and keeps its position and that slot (INT_MAX past the end),
// so the rows' searches run side by side, once a warp.
struct Start {
  int pos, slot;
};

__device__ __forceinline__ Start row_start(const int* __restrict__ idx, int s,
                                           int r0, int nr, int w, int k) {
  Start st{0, 0x7fffffff};
  if (k >= 0 && k < nr) {
    const int* row = idx + (long long)(r0 + k) * s;
    int lo = 0, hi = s;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (__ldg(row + mid) < w)
        lo = mid + 1;
      else
        hi = mid;
    }
    st.pos = lo;
    if (lo < s) st.slot = __ldg(row + lo);
  }
  return st;
}

// Position of slot i (a lane of the warp whose slots begin at w) in
// row r of `idx`, whose start lane k holds, or -1: a warp-uniform test
// that the row holds none of the warp's slots, else a search of the
// row's next 32 entries.
__device__ __forceinline__ int find_in_warp(const int* __restrict__ idx,
                                            int s, int r, Start st, int k,
                                            int w, int i) {
  int p = __shfl_sync(FULL_MASK, st.pos, k);
  int v = __shfl_sync(FULL_MASK, st.slot, k);
  if ((long long)v >= (long long)w + 32) return -1;
  int j = find_slot(idx + (long long)r * s + p, min(s - p, 32), i);
  return j < 0 ? -1 : p + j;
}

template <typename T>
__global__ void __launch_bounds__(TB) fm_fleet(FmArgs a) {
  long long g = blockIdx.x * (long long)TB + threadIdx.x;
  int lane = threadIdx.x & 31;
  int r0 = blockIdx.y * ROWS;
  int nr = min(a.nb - r0, ROWS);
  // the searched parts keep every lane to the end (their shuffles);
  // a lane past its part's end writes nothing
  if (g < a.end_c) {  // constraints: the bounds
    int i = (int)g, w = i - lane;
    bool in = i < a.C;
    const double* bw = part<double>(a, FP_BW);
    const int* li = part<int>(a, FP_LI);
    const double* lf = part<double>(a, FP_LF);
    T* cb = (T*)a.cb;
    Start st = row_start(li, a.sl, r0, nr, w, lane);
    double base = in ? a.base_cb[i] : 0.0;
    for (int k = 0; k < nr; ++k) {
      int r = r0 + k;
      double x = __dmul_rn(base, __ldg(bw + r));
      int j = find_in_warp(li, a.sl, r, st, k, w, i);
      if (j >= 0) x = __dmul_rn(x, __ldg(lf + (long long)r * a.sl + j));
      if (in) __stcs(cb + (long long)(a.b0 + r) * a.C + i, from_f64<T>(x));
    }
  } else if (g < a.end_v) {  // flows: remains, penalties, thresholds
    int i = (int)(g - a.end_c), w = i - lane;
    bool in = i < a.V;
    const double* fs = part<double>(a, FP_FS);
    const int* fi = part<int>(a, FP_FI);
    const double* ff = part<double>(a, FP_FF);
    const int* di = part<int>(a, FP_DI);
    T* pen = (T*)a.pen;
    T* rem = (T*)a.rem;
    T* th = (T*)a.th;
    // lanes 0-15 find the rows' flow factors, lanes 16-31 their dead
    // flows (ROWS <= 16)
    Start sf = row_start(fi, a.sf, r0, nr, w, lane);
    Start sd = row_start(di, a.sd, r0, nr, w, lane - 16);
    Start st{lane < 16 ? sf.pos : sd.pos, lane < 16 ? sf.slot : sd.slot};
    double bsz = 0.0, brem = 0.0, bpen = 0.0;
    if (in) {
      bsz = a.base_sz[i];
      brem = a.base_rem[i];
      bpen = a.base_pen[i];
    }
    for (int k = 0; k < nr; ++k) {
      int r = r0 + k;
      double f = __ldg(fs + r);
      double sz = __dmul_rn(bsz, f), rm = __dmul_rn(brem, f);
      int j = find_in_warp(fi, a.sf, r, st, k, w, i);
      if (j >= 0) {
        double x = __ldg(ff + (long long)r * a.sf + j);
        sz = __dmul_rn(sz, x);
        rm = __dmul_rn(rm, x);
      }
      bool dead = find_in_warp(di, a.sd, r, st, k + 16, w, i) >= 0;
      if (in) {
        long long o = (long long)(a.b0 + r) * a.V + i;
        __stcs(pen + o, from_f64<T>(dead ? 0.0 : bpen));
        __stcs(rem + o, from_f64<T>(rm));
        __stcs(th + o, from_f64<T>(a.done_rel ? __dmul_rn(a.done_eps, sz)
                                              : a.done_eps));
      }
    }
  } else if (g < a.end_e) {  // elements: the weights
    long long e = g - a.end_v;
    int i = (int)e, w = i - lane;
    bool in = e < a.E;
    const int* ei = part<int>(a, FP_EI);
    const T* ewv = part<T>(a, FP_EWV);
    T* ew = (T*)a.ew;
    Start st = row_start(ei, a.se, r0, nr, w, lane);
    T base = in ? ((const T*)a.base_ew)[e] : T(0);
    for (int k = 0; k < nr; ++k) {
      int r = r0 + k;
      int j = find_in_warp(ei, a.se, r, st, k, w, i);
      if (in)
        __stcs(ew + (long long)(a.b0 + r) * a.E + e,
               j >= 0 ? ewv[(long long)r * a.se + j] : base);
    }
  } else if (g < a.end_t) {  // the admitted tape row, padded here
    int j = (int)(g - a.end_e);
    if (j >= a.n_t) return;
    double t = inf_v<double>();
    int s = a.C;
    T v = T(0);
    if (j < a.n_live) {
      t = part<double>(a, FP_TT)[j];
      s = part<int>(a, FP_TS)[j];
      v = part<T>(a, FP_TV)[j];
    }
    for (int k = 0; k < nr; ++k) {
      long long o = (long long)(a.b0 + r0 + k) * a.n_t + j;
      a.tt[o] = t;
      a.ts[o] = s;
      ((T*)a.tv)[o] = v;
    }
  } else if (g < a.end_d) {  // a collective fleet's DAG-walk rows
    int i = (int)(g - a.end_t);
    if (i < 2)
      for (int k = 0; k < nr; ++k) a.clk[2LL * (a.b0 + r0 + k) + i] = 0.0;
    if (i >= a.V) return;
    int p = a.pred0[i];
    double t = a.ready0[i];
    for (int k = 0; k < nr; ++k) {
      long long o = (long long)(a.b0 + r0 + k) * a.V + i;
      a.pred[o] = p;
      a.ready[o] = t;
    }
  }
}

long long up32(long long n) { return (n + 31) / 32 * 32; }

}  // namespace

extern "C" {

// Rows [b0, b0+nb) of a fleet (birth: b0 = 0, nb = B; admission: nb = 1,
// b0 = the admitted row): the bounds, penalties, remains and thresholds,
// and, where given, the weights (E > 0), the tape row (T > 0: its first
// n_live entries from the payload, the rest padded with (inf, C, 0))
// and the collective rows (coll).  `host` holds the packed payload (pinned,
// `nbytes`), uploaded to `dev` on the stream before the launch; `off`
// gives each part's offset.
int fleet_materialize(int dbl, int nb, int b0, int C, int V, long long E,
                      int T, int n_live, int coll, int sl, int sf, int sd,
                      int se,
                      int done_rel, double done_eps, void** p, int n_ptrs,
                      const long long* off, int n_off, const void* host,
                      void* dev, long long nbytes, void* stream) {
  if (n_ptrs != N_FM_PTRS || n_off != FP_PARTS || nb < 1 || C < 0 ||
      V < 0 || E < 0 || E > 0x7fffffe0LL || T < 0 || n_live < 0 ||
      n_live > T || (nb + ROWS - 1) / ROWS > 65535 || (T > 0 && nb != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t rc = cudaMemcpyAsync(dev, host, (size_t)nbytes,
                                   cudaMemcpyHostToDevice, s);
  if (rc != cudaSuccess) return (int)rc;
  FmArgs a;
  a.base_cb = (const double*)p[0];
  a.base_sz = (const double*)p[1];
  a.base_rem = (const double*)p[2];
  a.base_pen = (const double*)p[3];
  a.cb = p[4];
  a.pen = p[5];
  a.rem = p[6];
  a.th = p[7];
  a.base_ew = p[8];
  a.ew = p[9];
  a.tt = (double*)p[10];
  a.ts = (int*)p[11];
  a.tv = p[12];
  a.pred0 = (const int*)p[13];
  a.ready0 = (const double*)p[14];
  a.pred = (int*)p[15];
  a.ready = (double*)p[16];
  a.clk = (double*)p[17];
  a.pay = (const unsigned char*)dev;
  for (int k = 0; k < FP_PARTS; ++k) a.off[k] = off[k];
  a.E = E;
  a.end_c = up32(C);
  a.end_v = a.end_c + up32(V);
  a.end_e = a.end_v + up32(E);
  a.end_t = a.end_e + up32(T);
  a.end_d = a.end_t + (coll ? up32(V > 2 ? V : 2) : 0);
  a.C = C;
  a.V = V;
  a.n_t = T;
  a.n_live = n_live;
  a.sl = sl;
  a.sf = sf;
  a.sd = sd;
  a.se = se;
  a.nb = nb;
  a.b0 = b0;
  a.done_rel = done_rel;
  a.done_eps = done_eps;
  if (a.end_d == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((a.end_d + TB - 1) / TB), (nb + ROWS - 1) / ROWS);
  if (dbl)
    fm_fleet<double><<<grid, TB, 0, s>>>(a);
  else
    fm_fleet<float><<<grid, TB, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
