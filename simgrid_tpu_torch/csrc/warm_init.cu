// K6 warm_init: the restart state of a warm-started selective solve.
//
// Replaces: simgrid_tpu/ops/lmm_warm.py `_warm_init` (:201-242).  From
// the resident masters, the previous converged solve (v_value,
// remaining, usage, in place in the fixpoint state) and the indexes of
// the modified constraints (mc_idx, padded by repeating an entry), it
// writes the state from which K1's rounds re-solve only the modified
// component:
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
// the same state from the ELL masters (cv_var/cv_w/cv_valid [C, Wc]):
// v_mod and "has a live element" by one thread a table entry writing
// `true` (an order-free OR), usage0 folded over the modified rows in
// XLA:CPU's row order (`warp_block_sum` of common.cuh, as K7's init), and the carry's
// extra leg: cv_live of a modified row = enabled & not fixed now, an
// untouched row keeps its previous mask.  Its control words also clear
// the chain's (HALF -1), as K7's init does.
//
// What bounds it on this card: memory.  It reads each live element's
// constraint once through the variable row index and, for the modified
// rows only, each element's weight and variable penalty through the
// constraint row index; the state vectors are read and written once:
// a few MB at the 100k-flow churn, a few microseconds at 3.35 TB/s,
// below the four launches' latency.
//
// What the design does about it: the "any" reductions (v_mod, has a
// live element) are one walk of a variable's row by its own thread,
// order-free; usage0 is the shared in-order row fold of common.cuh
// (`row_usage0`, one warp a row, no atomics), the same code K1's init
// runs, so a modified row's usage rounds exactly as a cold init's.

#include "common.cuh"

#define N_PTRS 18

namespace {

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

// clear the modified mask; arm the control words
template <typename T>
__global__ void wi_clear(WArgs<T> a, int limit) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ctrl[C_IT] = 0;
    a.ctrl[C_LIGHT] = 0;
    a.ctrl[C_LIGHT_ACC] = 0;
    a.ctrl[C_ARMED] = 1;
    a.ctrl[C_LIMIT] = limit;
  }
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < a.C;
       c += gridDim.x * blockDim.x)
    a.c_mod[c] = false;
}

template <typename T>
__global__ void wi_mark(WArgs<T> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n_mc;
       i += gridDim.x * blockDim.x)
    a.c_mod[a.mc_idx[i]] = true;
}

// one thread a variable: v_mod and "has a live element" from its row,
// then its value and fixed flag
template <typename T>
__global__ void wi_var(WArgs<T> a) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < a.V;
       v += gridDim.x * blockDim.x) {
    int beg = a.v_ptr[v], end = a.v_ptr[v + 1];
    bool vm = false;
    for (int j = beg; j < end && !vm; ++j) vm = a.c_mod[a.e_cnst[a.v_idx[j]]];
    T p = a.pen[v];
    bool keep = !vm && p > T(0) && end > beg;
    if (!keep) a.v_value[v] = mul_rn(finite_v(p) ? p : T(0), T(0));
    a.v_fixed[v] = vm ? p < T(0) : true;
  }
}

// one warp a constraint: the cold init of the modified rows
template <typename T>
__global__ void wi_cnst(WArgs<T> a) {
  int lane = threadIdx.x & 31;
  int warps = (gridDim.x * blockDim.x) >> 5;
  int cnt = 0;
  for (int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < a.C;
       c += warps) {
    if (!a.c_mod[c]) {
      if (lane == 0) a.light[c] = false;
      continue;
    }
    T use = row_usage0(a.c_ptr, a.c_idx, a.e_var, a.e_w, a.pen, c, lane,
                       a.c_fat[c]);
    if (lane == 0) {
      T cb = a.c_bound[c];
      a.remaining[c] = cb;
      a.usage[c] = use;
      bool lt = (cb > mul_rn(cb, a.eps)) && (use > T(0));
      a.light[c] = lt;
      cnt += lt;
    }
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(a.ctrl + C_LIGHT, tot);
}

const int TB = 256;

template <typename T>
int launch(WArgs<T> a, int limit, cudaStream_t st) {
  wi_clear<T><<<grid_for(a.C, TB), TB, 0, st>>>(a, limit);
  wi_mark<T><<<grid_for(a.n_mc, TB), TB, 0, st>>>(a);
  wi_var<T><<<grid_for(a.V, TB), TB, 0, st>>>(a);
  wi_cnst<T><<<grid_for((long long)a.C * 32, TB), TB, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- ELL arm

#define N_PTRS_ELL 17

template <typename T>
struct EArgs {
  int V, C, Wc, n_mc;
  T eps;
  const T* pen;
  const int* cv_var;
  const T* cv_w;
  const bool* cv_valid;
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
EArgs<T> make_eargs(int V, int C, int Wc, int n_mc, double eps, void** p) {
  EArgs<T> a;
  a.V = V;
  a.C = C;
  a.Wc = Wc;
  a.n_mc = n_mc;
  a.eps = (T)eps;
  a.pen = (const T*)p[0];
  a.cv_var = (const int*)p[1];
  a.cv_w = (const T*)p[2];
  a.cv_valid = (const bool*)p[3];
  a.c_bound = (const T*)p[4];
  a.c_fat = (const bool*)p[5];
  a.mc_idx = (const int*)p[6];
  a.v_value = (T*)p[7];
  a.v_fixed = (bool*)p[8];
  a.remaining = (T*)p[9];
  a.usage = (T*)p[10];
  a.light = (bool*)p[11];
  a.cv_live = (bool*)p[12];
  a.c_mod = (bool*)p[13];
  a.v_mod = (bool*)p[14];
  a.v_has = (bool*)p[15];
  a.ctrl = (int*)p[16];
  return a;
}

template <typename T>
__global__ void we_clear(EArgs<T> a, int limit) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* c = a.ctrl;
    c[C_IT] = 0;
    c[C_LIGHT] = 0;
    c[C_LIGHT_ACC] = 0;
    c[C_ARMED] = 1;
    c[C_LIMIT] = limit;
    c[C_HALF] = -1;
    c[C_VLIVE] = 0;
    c[C_VLIVE_ACC] = 0;
    c[C_OVERFLOW] = 0;
    c[C_NFIXED_ACC] = 0;
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.C || i < a.V;
       i += gridDim.x * blockDim.x) {
    if (i < a.C) a.c_mod[i] = false;
    if (i < a.V) {
      a.v_mod[i] = false;
      a.v_has[i] = false;
    }
  }
}

template <typename T>
__global__ void we_mark(EArgs<T> a) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n_mc;
       i += gridDim.x * blockDim.x)
    a.c_mod[a.mc_idx[i]] = true;
}

// one thread a table entry: a live entry (valid, weight > 0) marks its
// variable as having one, and as modified when its row is
template <typename T>
__global__ void we_elem(EArgs<T> a) {
  long long n = (long long)a.C * a.Wc;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    if (a.cv_valid[i] && a.cv_w[i] > T(0)) {
      int v = a.cv_var[i];
      a.v_has[v] = true;
      if (a.c_mod[i / a.Wc]) a.v_mod[v] = true;
    }
  }
}

template <typename T>
__global__ void we_var(EArgs<T> a) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < a.V;
       v += gridDim.x * blockDim.x) {
    T p = a.pen[v];
    bool vm = a.v_mod[v];
    bool keep = !vm && p > T(0) && a.v_has[v];
    if (!keep) a.v_value[v] = mul_rn(finite_v(p) ? p : T(0), T(0));
    a.v_fixed[v] = vm ? p < T(0) : true;
  }
}

// one warp a modified row: the cold init and the re-derived cv_live
template <typename T>
__global__ void we_cnst(EArgs<T> a) {
  int lane = threadIdx.x & 31;
  int warps = (gridDim.x * blockDim.x) >> 5;
  int cnt = 0;
  for (int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < a.C;
       c += warps) {
    if (!a.c_mod[c]) {
      if (lane == 0) a.light[c] = false;
      continue;
    }
    T usum = T(0), umax = T(0);
    for (int base = 0; base < a.Wc; base += 32) {
      int j = base + lane;
      T x = T(0);
      if (j < a.Wc) {
        long long idx = (long long)c * a.Wc + j;
        int v = a.cv_var[idx];
        T p = a.pen[v];
        bool ev = a.cv_valid[idx] && p > T(0);
        if (ev) x = div_rn(a.cv_w[idx], p);
        a.cv_live[idx] = ev && !a.v_fixed[v];
      }
      usum = add_rn(usum, warp_block_sum(x));
      umax = max_v(umax, warp_max(x));
    }
    if (lane == 0) {
      T use = a.c_fat[c] ? umax : usum;
      T cb = a.c_bound[c];
      a.remaining[c] = cb;
      a.usage[c] = use;
      bool lt = (cb > mul_rn(cb, a.eps)) && (use > T(0));
      a.light[c] = lt;
      cnt += lt;
    }
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(a.ctrl + C_LIGHT, tot);
}

template <typename T>
int launch_ell(EArgs<T> a, int limit, cudaStream_t st) {
  int g = grid_for(a.C > a.V ? a.C : a.V, TB);
  we_clear<T><<<g, TB, 0, st>>>(a, limit);
  we_mark<T><<<grid_for(a.n_mc, TB), TB, 0, st>>>(a);
  we_elem<T><<<grid_for((long long)a.C * a.Wc, TB), TB, 0, st>>>(a);
  we_var<T><<<grid_for(a.V, TB), TB, 0, st>>>(a);
  we_cnst<T><<<grid_for((long long)a.C * 32, TB), TB, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warm_init_ell(int dbl, int V, int C, int Wc, int n_mc,
                             void** ptrs, int n_ptrs, double eps, int limit,
                             void* stream) {
  if (n_ptrs != N_PTRS_ELL || n_mc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_ell(make_eargs<double>(V, C, Wc, n_mc, eps, ptrs), limit,
                      st);
  return launch_ell(make_eargs<float>(V, C, Wc, n_mc, eps, ptrs), limit, st);
}

extern "C" int warm_init(int dbl, int V, int C, int n_mc, void** ptrs,
                         int n_ptrs, double eps, int limit, void* stream) {
  if (n_ptrs != N_PTRS || n_mc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch(make_args<double>(V, C, n_mc, eps, ptrs), limit, st);
  return launch(make_args<float>(V, C, n_mc, eps, ptrs), limit, st);
}
