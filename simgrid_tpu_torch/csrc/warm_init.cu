// K6 warm_init: the restart state of a warm-started selective solve.
//
// Replaces: simgrid_tpu/ops/lmm_warm.py `_warm_init` (:201-242).  From
// the resident masters, the previous converged solve (v_value,
// remaining, usage, in place in the fixpoint state) and the indexes of
// the modified constraints (mc_idx), it writes the state from which
// K1's rounds re-solve only the modified component:
//   c_mod       = the modified constraints;
//   v_mod       = variables with a live element (weight > 0) in one;
//   v_value     = the previous value where the variable is not in
//                 v_mod, enabled and has a live element, else the cold
//                 init where(isfinite(pen), pen, 0) * 0.0 (a multiply,
//                 so a negative penalty gives -0.0, as in JAX);
//   v_fixed     = pen < 0 in v_mod, fixed everywhere else;
//   remaining   = the bound in c_mod, else the previous value;
//   usage       = usage0 in c_mod (the in-order sum of w/pen, or the
//                 max for a FATPIPE row), else the previous value;
//   light       = c_mod & bound > bound*eps & usage0 > 0;
// and arms the control words as K1's init does (IT 0, ARMED, LIMIT,
// LIGHT counted).
//
// Its ELL arm (`warm_init_ell`) replaces `_warm_init_ell` (:157-198):
// the same state from the ELL tables, usage0 folded over the modified
// rows in XLA:CPU's row order (that of common.cuh's `warp_block_sum`,
// as K7's init folds it), and the carry's extra leg: cv_live of a modified row = enabled
// & not fixed now, an untouched row keeps its previous mask; it also
// writes v_mod and "has a live element" (v_has) and clears the chain's
// control words (HALF -1), as K7's init does.
//
// mc_idx comes sorted (non-decreasing), padded by repeating its last
// entry: ops/lmm_warm.py `modified_index` builds it so.  The entries
// take it on the host (`mc_host`, pinned) and upload it into the
// device buffer of their pointer array ahead of the launch; the
// wrapper (kernels/warm_init.py) checks its order there first and
// raises ValueError on a descending pair, so the kernels' trap on one
// is a backstop only.  The padding does not change the set.
//
// What bounds it on this card: latency.  Its bytes (each live element
// once through the variable rows, the modified rows' elements and
// penalties, the state vectors once: a few MB at the 100k-flow churn)
// take 1-2 us at 3.35 TB/s; the COO arm took four launches (20 us) and
// the ELL arm five (28 us) on an NVIDIA H100 80GB HBM3 at 700 W, most
// of it their launch latency, and the ELL arm's entry pass walked the
// whole [C, Wc] table with a byte store a live entry.  In one launch
// (12 us, 8 of them the kernel's own on that card) the pass over every
// variable's row, three dependent gathers a variable, sets the time.
//
// What the design does about it: one launch an arm, no clear pass, no
// scratch.  Because mc_idx is sorted, every question "is constraint c
// modified" is a binary search in it, so nothing waits for a mask: one
// grid holds three independent parts that read only inputs and write
// disjoint outputs:
//   * one thread a constraint: c_mod by search, light cleared where the
//     row is not modified;
//   * one warp a distinct modified row (mc_idx[i] != mc_idx[i - 1]):
//     the cold init (remaining, light, usage0 folded in element order,
//     or in XLA:CPU's row order in the ELL arm, as the cold inits fold
//     it; the gathers of FOLD_WINDOWS windows of 32 lanes in flight at
//     once, then the window's adds with shuffles that do not wait on
//     the sum, `fold_lanes`: the fold's latency, not its bytes, set the
//     time of this part); the ELL arm writes the row's cv_live as
//     its enabled mask (valid & penalty > 0): every live element of a
//     modified row belongs to a modified variable, which is unfixed
//     exactly where it is enabled, so the new fixed flags are not read;
//   * one thread a variable: v_mod and "has a live element" from its
//     own row (COO: v_ptr/v_idx; ELL: the variable-row tables vc_*,
//     which hold the same live elements as the cv_* rows), a search a
//     live element, then v_value and v_fixed.
// The light count goes through the launch's last block (common.cuh
// `last_block`, the ticket in ctrl slots 30-31), which arms the control
// words; no atomic counter is zeroed first.

#include "common.cuh"

#define N_PTRS 18

namespace {

// whether c is in the non-decreasing a[0, n)
__device__ __forceinline__ bool in_sorted(const int* __restrict__ a, int n,
                                          int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < c)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && __ldg(a + lo) == c;
}

// Windows of 32 lanes a modified row's fold loads before it adds them
#define FOLD_WINDOWS 4

// The left fold of the 32 lanes' x into acc in lane order, as a
// sequential loop adds them; every lane returns the same value.  The
// shuffles name constant lanes and do not wait on the sum, so they
// issue back to back and only the adds are serial.  Values must be
// non-negative: a lane's +0.0 then adds exactly nothing, so the sum is
// common.cuh's `warp_fold_into` (which skips such lanes) bit for bit.
template <typename T>
__device__ __forceinline__ T fold_lanes(T acc, T x) {
#pragma unroll
  for (int l = 0; l < 32; ++l) acc = add_rn(acc, __shfl_sync(FULL_MASK, x, l));
  return acc;
}

// The fixpoint's initial usage of constraint row c (lmm_jax.py:439-444,
// lmm_warm.py:224-229): over the row's elements (the row index lists
// the elements of positive weight in element order), w / penalty of
// those whose variable is enabled (penalty > 0), summed as a left fold
// from 0.0 in element order (SHARED) or their max (FATPIPE, `fat`).
// Called by all 32 lanes of one warp for one row (`fat` is the same in
// every lane); every lane returns the same value.  The warp loads
// FOLD_WINDOWS windows of 32 entries (their gathers all in flight) and
// then adds them one by one in element order, so the rounding is the
// scatter-add's in element order.
template <typename T>
__device__ __forceinline__ T row_usage0(const int* c_ptr, const int* c_idx,
                                        const int* e_var, const T* e_w,
                                        const T* pen, int c, int lane,
                                        bool fat) {
  int beg = c_ptr[c], end = c_ptr[c + 1];
  T use = T(0);
  for (int base = beg; base < end; base += 32 * FOLD_WINDOWS) {
    T x[FOLD_WINDOWS];
#pragma unroll
    for (int k = 0; k < FOLD_WINDOWS; ++k) {
      int j = base + 32 * k + lane;
      x[k] = T(0);
      if (j < end) {
        int e = c_idx[j];
        T w = e_w[e];
        T p = pen[e_var[e]];
        if (w > T(0) && p > T(0)) x[k] = div_rn(w, p);
      }
    }
#pragma unroll
    for (int k = 0; k < FOLD_WINDOWS; ++k) {
      if (base + 32 * k >= end) break;
      use = fat ? max_v(use, warp_max(x[k])) : fold_lanes(use, x[k]);
    }
  }
  return use;
}

// The modified row of the warp on item i of mc_idx, or -1 when the
// entry repeats the one before (padding or a duplicate): warp-uniform.
__device__ __forceinline__ int modified_row(const int* __restrict__ mc,
                                            int i) {
  int c = __ldg(mc + i);
  if (i == 0) return c;
  int p = __ldg(mc + i - 1);
  if (p > c) __trap();  // not sorted (the wrapper refuses it first)
  return p == c ? -1 : c;
}

// The parts of one grid: constraints [0, c_end), a warp a modified-row
// slot [c_end, m_end), variables [m_end, total); c_end and m_end are
// multiples of 32, so every warp lies inside one part.
struct Parts {
  long long c_end, m_end, total;
};

inline Parts parts_of(int C, int n_mc, int V) {
  Parts p;
  p.c_end = ((long long)C + 31) / 32 * 32;
  p.m_end = p.c_end + 32LL * n_mc;
  p.total = p.m_end + V;
  return p;
}

template <typename T>
struct WArgs {
  int V, C, n_mc;
  T eps;
  const T* pen;
  const int* e_var;
  const int* e_cnst;
  const T* e_w;
  const T* c_bound;
  const bool* c_fat;
  const int* c_ptr;
  const int* c_idx;
  const int* v_ptr;
  const int* v_idx;
  const int* mc_idx;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  bool* c_mod;
  int* ctrl;
};

template <typename T>
WArgs<T> make_args(int V, int C, int n_mc, double eps, void** p) {
  WArgs<T> a;
  a.V = V;
  a.C = C;
  a.n_mc = n_mc;
  a.eps = (T)eps;
  a.pen = (const T*)p[0];
  a.e_var = (const int*)p[1];
  a.e_cnst = (const int*)p[2];
  a.e_w = (const T*)p[3];
  a.c_bound = (const T*)p[4];
  a.c_fat = (const bool*)p[5];
  a.c_ptr = (const int*)p[6];
  a.c_idx = (const int*)p[7];
  a.v_ptr = (const int*)p[8];
  a.v_idx = (const int*)p[9];
  a.mc_idx = (const int*)p[10];
  a.v_value = (T*)p[11];
  a.v_fixed = (bool*)p[12];
  a.remaining = (T*)p[13];
  a.usage = (T*)p[14];
  a.light = (bool*)p[15];
  a.c_mod = (bool*)p[16];
  a.ctrl = (int*)p[17];
  return a;
}

// a modified row's cold init from its usage0; returns its light flag
template <typename T>
__device__ __forceinline__ bool cold_row(T* remaining, T* usage,
                                         bool* light, const T* c_bound,
                                         T eps, int c, T use) {
  T cb = c_bound[c];
  remaining[c] = cb;
  usage[c] = use;
  bool lt = (cb > mul_rn(cb, eps)) && (use > T(0));
  light[c] = lt;
  return lt;
}

// a variable's restart value and fixed flag
template <typename T>
__device__ __forceinline__ void restart_var(T* v_value, bool* v_fixed,
                                            const T* pen, int v, bool vm,
                                            bool has) {
  T p = pen[v];
  bool keep = !vm && p > T(0) && has;
  if (!keep) v_value[v] = mul_rn(finite_v(p) ? p : T(0), T(0));
  v_fixed[v] = vm ? p < T(0) : true;
}

template <typename T>
__global__ void wi_all(WArgs<T> a, Parts pt, int limit) {
  int lane = threadIdx.x & 31;
  int cnt = 0;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < pt.total; t += (long long)gridDim.x * blockDim.x) {
    if (t < pt.c_end) {
      int c = (int)t;
      if (c < a.C) {
        bool m = in_sorted(a.mc_idx, a.n_mc, c);
        a.c_mod[c] = m;
        if (!m) a.light[c] = false;
      }
    } else if (t < pt.m_end) {
      int c = modified_row(a.mc_idx, (int)((t - pt.c_end) >> 5));
      if (c < 0) continue;
      T use = row_usage0(a.c_ptr, a.c_idx, a.e_var, a.e_w, a.pen, c, lane,
                         a.c_fat[c]);
      if (lane == 0)
        cnt += cold_row(a.remaining, a.usage, a.light, a.c_bound, a.eps, c,
                        use);
    } else {
      int v = (int)(t - pt.m_end);
      int beg = a.v_ptr[v], end = a.v_ptr[v + 1];
      bool vm = false;
      for (int j = beg; j < end && !vm; ++j)
        vm = in_sorted(a.mc_idx, a.n_mc, a.e_cnst[a.v_idx[j]]);
      restart_var(a.v_value, a.v_fixed, a.pen, v, vm, end > beg);
    }
  }
  unsigned tot;
  if (last_block(ticket_of(a.ctrl), (unsigned)block_sum(cnt), &tot) &&
      threadIdx.x == 0) {
    int* c = a.ctrl;
    c[C_IT] = 0;
    c[C_LIGHT] = (int)tot;
    c[C_LIGHT_ACC] = 0;
    c[C_ARMED] = 1;
    c[C_LIMIT] = limit;
  }
}

const int TB = 256;

template <typename T>
int launch(WArgs<T> a, int limit, cudaStream_t st) {
  Parts pt = parts_of(a.C, a.n_mc, a.V);
  wi_all<T><<<grid_for(pt.total, TB), TB, 0, st>>>(a, pt, limit);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- ELL arm

#define N_PTRS_ELL 20

template <typename T>
struct EArgs {
  int V, C, Wc, Wv, n_mc;
  T eps;
  const T* pen;
  const int* cv_var;
  const T* cv_w;
  const bool* cv_valid;
  const int* vc_cnst;
  const bool* vc_valid;
  const T* vc_w;
  const T* c_bound;
  const bool* c_fat;
  const int* mc_idx;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  bool* cv_live;
  bool* c_mod;
  bool* v_mod;
  bool* v_has;
  int* ctrl;
};

template <typename T>
EArgs<T> make_eargs(int V, int C, int Wc, int Wv, int n_mc, double eps,
                    void** p) {
  EArgs<T> a;
  a.V = V;
  a.C = C;
  a.Wc = Wc;
  a.Wv = Wv;
  a.n_mc = n_mc;
  a.eps = (T)eps;
  a.pen = (const T*)p[0];
  a.cv_var = (const int*)p[1];
  a.cv_w = (const T*)p[2];
  a.cv_valid = (const bool*)p[3];
  a.vc_cnst = (const int*)p[4];
  a.vc_valid = (const bool*)p[5];
  a.vc_w = (const T*)p[6];
  a.c_bound = (const T*)p[7];
  a.c_fat = (const bool*)p[8];
  a.mc_idx = (const int*)p[9];
  a.v_value = (T*)p[10];
  a.v_fixed = (bool*)p[11];
  a.remaining = (T*)p[12];
  a.usage = (T*)p[13];
  a.light = (bool*)p[14];
  a.cv_live = (bool*)p[15];
  a.c_mod = (bool*)p[16];
  a.v_mod = (bool*)p[17];
  a.v_has = (bool*)p[18];
  a.ctrl = (int*)p[19];
  return a;
}

template <typename T>
__global__ void we_all(EArgs<T> a, Parts pt, int limit) {
  int lane = threadIdx.x & 31;
  int cnt = 0;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < pt.total; t += (long long)gridDim.x * blockDim.x) {
    if (t < pt.c_end) {
      int c = (int)t;
      if (c < a.C) {
        bool m = in_sorted(a.mc_idx, a.n_mc, c);
        a.c_mod[c] = m;
        if (!m) a.light[c] = false;
      }
    } else if (t < pt.m_end) {
      int c = modified_row(a.mc_idx, (int)((t - pt.c_end) >> 5));
      if (c < 0) continue;
      // XLA:CPU's row order (common.cuh `warp_block_sum`): each window
      // of 32 lanes from -row_low(Wc) folded from 0.0, the partials
      // folded left to right; FOLD_WINDOWS windows loaded at once
      T usum = T(0), umax = T(0);
      for (int base = -row_low(a.Wc); base < a.Wc;
           base += 32 * FOLD_WINDOWS) {
        T x[FOLD_WINDOWS];
#pragma unroll
        for (int k = 0; k < FOLD_WINDOWS; ++k) {
          int j = base + 32 * k + lane;
          x[k] = T(0);
          if (j >= 0 && j < a.Wc) {
            long long idx = (long long)c * a.Wc + j;
            T p = a.pen[a.cv_var[idx]];
            bool ev = a.cv_valid[idx] && p > T(0);
            if (ev) x[k] = div_rn(a.cv_w[idx], p);
            a.cv_live[idx] = ev;
          }
        }
#pragma unroll
        for (int k = 0; k < FOLD_WINDOWS; ++k) {
          if (base + 32 * k >= a.Wc) break;
          usum = add_rn(usum, fold_lanes(T(0), x[k]));
          umax = max_v(umax, warp_max(x[k]));
        }
      }
      if (lane == 0)
        cnt += cold_row(a.remaining, a.usage, a.light, a.c_bound, a.eps, c,
                        a.c_fat[c] ? umax : usum);
    } else {
      int v = (int)(t - pt.m_end);
      bool has = false, vm = false;
      for (int j = 0; j < a.Wv && !vm; ++j) {
        long long idx = (long long)v * a.Wv + j;
        if (a.vc_valid[idx] && a.vc_w[idx] > T(0)) {
          has = true;
          vm = in_sorted(a.mc_idx, a.n_mc, a.vc_cnst[idx]);
        }
      }
      a.v_mod[v] = vm;
      a.v_has[v] = has;
      restart_var(a.v_value, a.v_fixed, a.pen, v, vm, has);
    }
  }
  unsigned tot;
  if (last_block(ticket_of(a.ctrl), (unsigned)block_sum(cnt), &tot) &&
      threadIdx.x == 0) {
    int* c = a.ctrl;
    c[C_IT] = 0;
    c[C_LIGHT] = (int)tot;
    c[C_LIGHT_ACC] = 0;
    c[C_ARMED] = 1;
    c[C_LIMIT] = limit;
    c[C_HALF] = -1;
    c[C_VLIVE] = 0;
    c[C_VLIVE_ACC] = 0;
    c[C_OVERFLOW] = 0;
    c[C_NFIXED_ACC] = 0;
  }
}

template <typename T>
int launch_ell(EArgs<T> a, int limit, cudaStream_t st) {
  Parts pt = parts_of(a.C, a.n_mc, a.V);
  we_all<T><<<grid_for(pt.total, TB), TB, 0, st>>>(a, pt, limit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warm_init_ell(int dbl, int V, int C, int Wc, int Wv,
                             int n_mc, void** ptrs, int n_ptrs, double eps,
                             int limit, const void* mc_host, void* stream) {
  if (n_ptrs != N_PTRS_ELL || n_mc <= 0 || Wc <= 0 || Wv <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemcpyAsync(ptrs[9], mc_host, sizeof(int) * n_mc,
                                   cudaMemcpyHostToDevice, st);
  if (rc != cudaSuccess) return (int)rc;
  if (dbl)
    return launch_ell(make_eargs<double>(V, C, Wc, Wv, n_mc, eps, ptrs),
                      limit, st);
  return launch_ell(make_eargs<float>(V, C, Wc, Wv, n_mc, eps, ptrs), limit,
                    st);
}

extern "C" int warm_init(int dbl, int V, int C, int n_mc, void** ptrs,
                         int n_ptrs, double eps, int limit,
                         const void* mc_host, void* stream) {
  if (n_ptrs != N_PTRS || n_mc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t rc = cudaMemcpyAsync(ptrs[10], mc_host, sizeof(int) * n_mc,
                                   cudaMemcpyHostToDevice, st);
  if (rc != cudaSuccess) return (int)rc;
  if (dbl)
    return launch(make_args<double>(V, C, n_mc, eps, ptrs), limit, st);
  return launch(make_args<float>(V, C, n_mc, eps, ptrs), limit, st);
}
