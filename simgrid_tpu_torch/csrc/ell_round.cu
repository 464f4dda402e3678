// K7 ell_round: the ELL fixpoint's init and one round on the
// constraint-row tables.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `fixpoint_ell` (:198-388) as
// `_solve_ell_chunk` (:944-966) runs it: the None-carry init (:219-241;
// `ell_init` below), and one `body_local` round (:325-367, which always
// carries the bound-first rule) or one `body_global` round (:301-323,
// ARM_GLOBAL), each followed by `apply_fixes` (:252-299, with the
// FATPIPE branch when ARM_FATPIPE is set) (`ell_round`).  The bound-free
// local round of a system with `vc_w` is K8's.
//
// Tables: cv_var/cv_w/cv_valid [C, Wc] (a constraint's elements in
// stable element order), vc_cnst/vc_valid [V, Wv] (a variable's), both
// flat, row-major.  The carry's extra leg cv_live [C, Wc] is the
// constraint-row liveness mask apply_fixes leaves for the next round.
//
// What bounds it on this card: memory.  A local round walks the cv
// table four times and the vc table four times (nmin, low bounds, mb_v,
// levels); at the headline's shapes (C 16,384 x Wc 64, V 131,072 x Wv 4)
// that is some 60 MB of table and gathered state a round, about 18 us at
// 3.35 TB/s.  A round is a chain of grid-wide dependencies, so it is ten
// launches (six in global order); at small live sets the launches, not
// the bytes, set its time.
//
// What the design does about it:
// * one thread per variable row (Wv is route-length short) and one warp
//   per constraint row (Wc runs to 512), lanes across the row, so the
//   cv table is read coalesced;
// * every row sum the JAX program takes along axis 1 (usage0, d_rem,
//   d_use) folds in XLA:CPU's order: each 32-lane block left to right
//   from 0.0 (the warp loads the block and adds lane by lane), then the
//   block partials left to right (`warp_block_sum` in common.cuh); no
//   atomics feed a sum;
// * mins, maxes and ORs are order-free (warp shuffles); the global
//   order's two grid-wide minima are one unsigned atomicMin per block on
//   the bits of a non-negative float;
// * the state and round counter stay on the device and every launch
//   first reads the control words, so K16's loop runs rounds with no
//   host in between.

#include "common.cuh"

#define ARM_FATPIPE 2
#define ARM_GLOBAL 4
#define N_PTRS 26

namespace {

template <typename T>
struct ESys {
  int V, C, Wc, Wv;
  T eps;
  const T* pen;
  const T* vb;
  const int* cv_var;
  const T* cv_w;
  const bool* cv_valid;
  const int* vc_cnst;
  const bool* vc_valid;
  const T* c_bound;
  const bool* c_fat;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  bool* cv_live;
  T* nmin_v;
  bool* proc;
  bool* fix_now;
  bool* low_v;
  T* mb_v;
  T* mb_c;
  bool* blocked_c;
  T* rou;
  unsigned long long* min_usage;
  unsigned long long* min_bound;
  int* ctrl;
};

template <typename T>
ESys<T> make_sys(int V, int C, int Wc, int Wv, double eps, void** p) {
  ESys<T> s;
  s.V = V;
  s.C = C;
  s.Wc = Wc;
  s.Wv = Wv;
  s.eps = (T)eps;
  s.pen = (const T*)p[0];
  s.vb = (const T*)p[1];
  s.cv_var = (const int*)p[2];
  s.cv_w = (const T*)p[3];
  s.cv_valid = (const bool*)p[4];
  s.vc_cnst = (const int*)p[5];
  s.vc_valid = (const bool*)p[6];
  s.c_bound = (const T*)p[7];
  s.c_fat = (const bool*)p[8];
  s.v_value = (T*)p[9];
  s.v_fixed = (bool*)p[10];
  s.remaining = (T*)p[11];
  s.usage = (T*)p[12];
  s.light = (bool*)p[13];
  s.cv_live = (bool*)p[14];
  s.nmin_v = (T*)p[15];
  s.proc = (bool*)p[16];
  s.fix_now = (bool*)p[17];
  s.low_v = (bool*)p[18];
  s.mb_v = (T*)p[19];
  s.mb_c = (T*)p[20];
  s.blocked_c = (bool*)p[21];
  s.rou = (T*)p[22];
  s.min_usage = (unsigned long long*)p[23];
  s.min_bound = (unsigned long long*)p[24];
  s.ctrl = (int*)p[25];
  return s;
}

// the guard of every round: armed, light left, limit not spent, and (in
// a chain stage) more live variables than the stage keeps
__device__ __forceinline__ bool ell_go(const int* ctrl) {
  return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
         ctrl[C_IT] < ctrl[C_LIMIT] && ctrl[C_VLIVE] > ctrl[C_HALF];
}

template <typename T>
__device__ __forceinline__ bool var_live(const ESys<T>& s, int v) {
  return s.pen[v] > T(0) && !s.v_fixed[v];
}

// rou of a constraint: remaining / usage while light, else inf
template <typename T>
__device__ __forceinline__ T rou_of(const ESys<T>& s, int c) {
  return s.light[c] ? div_rn(s.remaining[c], s.usage[c]) : inf_v<T>();
}

// w / penalty of an enabled element of a cv row (0 otherwise)
template <typename T>
__device__ __forceinline__ T upen_of(const ESys<T>& s, int idx, int v,
                                     bool* evalid) {
  T p = s.pen[v];
  *evalid = s.cv_valid[idx] && p > T(0);
  return *evalid ? div_rn(s.cv_w[idx], p) : T(0);
}

#define FOR_VARS(v) \
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < s.V; \
       v += gridDim.x * blockDim.x)

#define FOR_CNST_WARPS(c)                                            \
  int lane = threadIdx.x & 31;                                       \
  int warps = (gridDim.x * blockDim.x) >> 5;                         \
  for (int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < s.C; \
       c += warps)

// ---------------------------------------------------------------- init

template <typename T>
__global__ void ei_var(ESys<T> s, int limit) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int* c = s.ctrl;
    c[C_ARMED] = 1;
    c[C_IT] = 0;
    c[C_LIGHT] = 0;
    c[C_LIGHT_ACC] = 0;
    c[C_LIMIT] = limit;
    c[C_HALF] = -1;
    c[C_VLIVE] = 0;
    c[C_VLIVE_ACC] = 0;
    c[C_OVERFLOW] = 0;
    c[C_NFIXED_ACC] = 0;
  }
  FOR_VARS(v) {
    T p = s.pen[v];
    s.v_value[v] = mul_rn(finite_v(p) ? p : T(0), T(0));
    s.v_fixed[v] = p < T(0);
  }
}

// usage0 (the 32-block fold of w/penalty, or the max on a FATPIPE row),
// remaining0, light0 and cv_live0 (an enabled element whose variable is
// not fixed at init, i.e. penalty > 0)
template <typename T>
__global__ void ei_cnst(ESys<T> s) {
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    T usum = T(0), umax = T(0);
    for (int base = 0; base < s.Wc; base += 32) {
      int j = base + lane;
      T x = T(0);
      if (j < s.Wc) {
        int idx = c * s.Wc + j;
        bool ev;
        x = upen_of(s, idx, s.cv_var[idx], &ev);
        s.cv_live[idx] = ev;
      }
      usum = add_rn(usum, warp_block_sum(x));
      umax = max_v(umax, warp_max(x));
    }
    if (lane == 0) {
      T use = s.c_fat[c] ? umax : usum;
      T cb = s.c_bound[c];
      s.remaining[c] = cb;
      s.usage[c] = use;
      bool lt = (cb > mul_rn(cb, s.eps)) && (use > T(0));
      s.light[c] = lt;
      cnt += lt;
    }
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_LIGHT, tot);
}

// ---------------------------------------------------------- local order

// L1: nmin_v = min rou over the variable's live row entries
template <typename T>
__global__ void l_nmin(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v))
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) m = min_v(m, rou_of(s, s.vc_cnst[idx]));
      }
    s.nmin_v[v] = m;
  }
}

// L2: nmin_c over the row's cv_live entries; processable
template <typename T>
__global__ void l_proc(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    for (int j = lane; j < s.Wc; j += 32) {
      int idx = c * s.Wc + j;
      if (s.cv_live[idx]) m = min_v(m, s.nmin_v[s.cv_var[idx]]);
    }
    m = warp_min(m);
    if (lane == 0) s.proc[c] = s.light[c] && rou_of(s, c) <= m;
  }
}

// L3: low_v = saturated, bounded, bound * penalty below nmin_v
template <typename T>
__global__ void l_low(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_VARS(v) {
    bool sat = false;
    if (var_live(s, v))
      for (int l = 0; l < s.Wv && !sat; ++l) {
        int idx = v * s.Wv + l;
        sat = s.vc_valid[idx] && s.proc[s.vc_cnst[idx]];
      }
    s.low_v[v] = sat && s.vb[v] > T(0) &&
                 mul_rn(s.vb[v], s.pen[v]) < s.nmin_v[v];
  }
}

// L4: mb_c = min bound * penalty over the row's live low-bound entries
template <typename T>
__global__ void l_mbc(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    for (int j = lane; j < s.Wc; j += 32) {
      int idx = c * s.Wc + j;
      int v = s.cv_var[idx];
      if (s.cv_live[idx] && s.low_v[v]) m = min_v(m, mul_rn(s.vb[v], s.pen[v]));
    }
    m = warp_min(m);
    if (lane == 0) s.mb_c[c] = s.proc[c] ? m : inf_v<T>();
  }
}

// L5: mb_v = min mb_c over the variable's processable live entries
template <typename T>
__global__ void l_mbv(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v))
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) {
          int c = s.vc_cnst[idx];
          if (s.proc[c]) m = min_v(m, s.mb_c[c]);
        }
      }
    s.mb_v[v] = m;
  }
}

// L6: a processable row is blocked when a live entry has a finite mb_v
template <typename T>
__global__ void l_blk(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    bool b = false;
    if (s.proc[c])
      for (int j = lane; j < s.Wc; j += 32) {
        int idx = c * s.Wc + j;
        if (s.cv_live[idx] && finite_v(s.mb_v[s.cv_var[idx]])) b = true;
      }
    b = __any_sync(FULL_MASK, b);
    if (lane == 0) s.blocked_c[c] = b;
  }
}

// L7: levels over processable unblocked rows; bound fixes first
template <typename T>
__global__ void l_fix(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  FOR_VARS(v) {
    T p = s.pen[v];
    T m = inf_v<T>();
    bool live = var_live(s, v);
    if (live)
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) {
          int c = s.vc_cnst[idx];
          if (s.proc[c] && !s.blocked_c[c]) m = min_v(m, rou_of(s, c));
        }
      }
    bool fix_bound = false;
    if (s.low_v[v]) {
      T d = sub_rn(mul_rn(s.vb[v], p), s.mb_v[v]);
      fix_bound = fabs(d) < s.eps;
    }
    bool fx = false;
    if (fix_bound) {
      s.v_value[v] = s.vb[v];
      fx = true;
    } else if (finite_v(m) && !s.v_fixed[v]) {
      s.v_value[v] = div_rn(m, p > T(0) ? p : T(1));
      fx = true;
    }
    if (fx) s.v_fixed[v] = true;
    s.fix_now[v] = fx;
  }
}

// --------------------------------------------------------- global order

template <typename T>
__global__ void g_reset(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  *s.min_usage = key_of(inf_v<T>());
  *s.min_bound = key_of(inf_v<T>());
}

template <typename T>
__global__ void g_rou(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  T m = inf_v<T>();
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < s.C;
       c += gridDim.x * blockDim.x) {
    T r = rou_of(s, c);
    s.rou[c] = r;
    m = min_v(m, r);
  }
  block_min_to(m, s.min_usage);
}

// saturated variables (a live entry in a light row at the min) into
// low_v; the grid-wide min of bound * penalty below the min over them
template <typename T>
__global__ void g_sat(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  T mu = from_key<T>(*s.min_usage);
  T mb = inf_v<T>();
  FOR_VARS(v) {
    bool sat = false;
    if (var_live(s, v))
      for (int l = 0; l < s.Wv && !sat; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) {
          int c = s.vc_cnst[idx];
          sat = s.light[c] && s.rou[c] == mu;
        }
      }
    s.low_v[v] = sat;
    if (sat && s.vb[v] > T(0)) {
      T bp = mul_rn(s.vb[v], s.pen[v]);
      if (bp < mu) mb = min_v(mb, bp);
    }
  }
  block_min_to(mb, s.min_bound);
}

template <typename T>
__global__ void g_fix(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  T mu = from_key<T>(*s.min_usage);
  T mb = from_key<T>(*s.min_bound);
  bool use_bounds = finite_v(mb);
  FOR_VARS(v) {
    bool fx = false;
    if (s.low_v[v]) {
      T p = s.pen[v];
      T val;
      if (use_bounds) {
        fx = fabs(sub_rn(mul_rn(s.vb[v], p), mb)) < s.eps;
        val = s.vb[v];
      } else {
        fx = true;
        val = div_rn(mu, p);
      }
      if (fx) {
        s.v_value[v] = val;
        s.v_fixed[v] = true;
      }
    }
    s.fix_now[v] = fx;
  }
}

// ---------------------------------------------------------- apply_fixes

// Over each row: cv_fix = cv_live (at round start) & fixed now; d_rem
// and d_use folded in XLA's row order; the new liveness mask; the
// FATPIPE max over still-live entries; then the clamps and light-set
// pruning, counting the light set.
template <typename T, bool FAT>
__global__ void a_apply(ESys<T> s) {
  if (!ell_go(s.ctrl)) return;
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    T d_rem = T(0), d_use = T(0), umax = T(0);
    bool touched = false, has_live = false;
    for (int base = 0; base < s.Wc; base += 32) {
      int j = base + lane;
      T xr = T(0), xu = T(0), xl = T(0);
      bool fx = false, lv = false;
      if (j < s.Wc) {
        int idx = c * s.Wc + j;
        int v = s.cv_var[idx];
        bool ev;
        T up = upen_of(s, idx, v, &ev);
        bool g_fixed = s.v_fixed[v];
        fx = s.cv_live[idx] && g_fixed;
        lv = ev && !g_fixed;
        s.cv_live[idx] = lv;
        if (fx) {
          xr = mul_rn(s.cv_w[idx], s.v_value[v]);
          xu = up;
        }
        if (lv) xl = up;
      }
      d_rem = add_rn(d_rem, warp_block_sum(xr));
      d_use = add_rn(d_use, warp_block_sum(xu));
      if (__any_sync(FULL_MASK, fx)) touched = true;
      if (__any_sync(FULL_MASK, lv)) has_live = true;
      if (FAT) umax = max_v(umax, warp_max(xl));
    }
    if (lane == 0) {
      T ce = mul_rn(s.c_bound[c], s.eps);
      T rem = s.remaining[c], use = s.usage[c];
      if (touched) {
        T nr = sub_rn(rem, d_rem);
        if (nr < ce) nr = T(0);
        T nu = sub_rn(use, d_use);
        if (nu < s.eps) nu = T(0);
        if (FAT && s.c_fat[c]) {
          use = umax;   // a FATPIPE row keeps its remaining
        } else {
          rem = nr;
          use = nu;
        }
        s.remaining[c] = rem;
        s.usage[c] = use;
      }
      bool drop = touched && (!(use > s.eps) || !(rem > ce));
      bool lt = s.light[c] && !drop && has_live;
      s.light[c] = lt;
      cnt += lt;
    }
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_LIGHT_ACC, tot);
}

__global__ void e_commit(int* ctrl) {
  if (!ell_go(ctrl)) return;
  ctrl[C_LIGHT] = ctrl[C_LIGHT_ACC];
  ctrl[C_LIGHT_ACC] = 0;
  ctrl[C_IT] += 1;
}

const int TB = 256;

template <typename T>
int launch_init(ESys<T> s, int limit, cudaStream_t st) {
  ei_var<T><<<grid_for(s.V, TB), TB, 0, st>>>(s, limit);
  ei_cnst<T><<<grid_for((long long)s.C * 32, TB), TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_round(ESys<T> s, int flags, cudaStream_t st) {
  int gv = grid_for(s.V, TB), gc = grid_for((long long)s.C * 32, TB);
  if (flags & ARM_GLOBAL) {
    g_reset<T><<<1, 1, 0, st>>>(s);
    g_rou<T><<<grid_for(s.C, TB), TB, 0, st>>>(s);
    g_sat<T><<<gv, TB, 0, st>>>(s);
    g_fix<T><<<gv, TB, 0, st>>>(s);
  } else {
    l_nmin<T><<<gv, TB, 0, st>>>(s);
    l_proc<T><<<gc, TB, 0, st>>>(s);
    l_low<T><<<gv, TB, 0, st>>>(s);
    l_mbc<T><<<gc, TB, 0, st>>>(s);
    l_mbv<T><<<gv, TB, 0, st>>>(s);
    l_blk<T><<<gc, TB, 0, st>>>(s);
    l_fix<T><<<gv, TB, 0, st>>>(s);
  }
  if (flags & ARM_FATPIPE)
    a_apply<T, true><<<gc, TB, 0, st>>>(s);
  else
    a_apply<T, false><<<gc, TB, 0, st>>>(s);
  e_commit<<<1, 1, 0, st>>>(s.ctrl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ell_init(int dbl, int V, int C, int Wc, int Wv, void** ptrs, int n_ptrs,
             double eps, int limit, void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_init(make_sys<double>(V, C, Wc, Wv, eps, ptrs), limit, st);
  return launch_init(make_sys<float>(V, C, Wc, Wv, eps, ptrs), limit, st);
}

int ell_round(int dbl, int V, int C, int Wc, int Wv, int flags, void** ptrs,
              int n_ptrs, double eps, void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_round(make_sys<double>(V, C, Wc, Wv, eps, ptrs), flags, st);
  return launch_round(make_sys<float>(V, C, Wc, Wv, eps, ptrs), flags, st);
}

}  // extern "C"
