// K1 lmm_round: the max-min fixpoint's init and one saturation round.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `fixpoint` in every arm the port
// runs: the init at lmm_jax.py:436-455 with the FATPIPE usage max of
// :441-444 (`lmm_init` below); one `body_local` round (:556-587), with
// the bound-first rule of :589-619 when ARM_BOUNDS is set, or one
// `body_global` round (:520-554, with or without bounds) when
// ARM_GLOBAL is set; each followed by `apply_fixes` (:469-518, with the
// FATPIPE branch of :490-497 when ARM_FATPIPE is set) (`lmm_round`).
// The flags are the JAX program's static arguments; the host decides
// them exactly as the JAX caller does.
//
// What bounds it on this card: memory.  A local round walks each row
// index twice (two passes over variables, two over constraints; the
// bound arm adds two of each) and gathers per-element data through the
// element index: about 4 x nnz x (4 B index + 4 B slot + 8 B weight +
// 8 B neighbour state) plus the state vectors, i.e. tens of MB at
// config #4 (1.24-1.28M elements), which is tens of microseconds at
// 3.35 TB/s.  A round is also a chain of grid-wide dependencies
// (neighbourhood min -> processable -> [low bounds -> mb_c -> mb_v ->
// blocked] -> levels -> sums), so it is five launches (nine with
// bounds, six in global order); at small live sets launch latency, not
// bytes, sets its time.
//
// What the design does about it:
// * one thread per variable row (rows are route-length short) and one
//   warp per constraint row (rows run to thousands of flows), so loads
//   are spread over lanes and long rows do not serialise a thread;
// * every sum that the JAX program takes with `.at[].add` (usage0,
//   d_rem, d_use) is a left fold in row order from 0.0: the warp loads
//   32 entries at once and then adds them one by one in lane order,
//   skipping lanes whose contribution is exactly 0.0 (an exact no-op on
//   the non-negative partial sums).  No atomics feed a sum;
// * mins, maxes and ORs are order-free and use warp shuffles; the
//   global order's two grid-wide minima (min rou, min bound) are one
//   unsigned atomicMin per block on the bits of a non-negative float,
//   which is exact; rou is computed once per round into a buffer and
//   the saturated test compares that stored value;
// * `v_bound * penalty` is one rounded product (__dmul_rn), the bound
//   test |bp - mb| < eps is absolute, as in JAX;
// * the fixpoint state and the round counter stay on the device, and
//   every launch first reads the control words and returns at once when
//   the fixpoint has converged or its round limit is spent, so the host
//   queues rounds without waiting on the device.

// The replica axis (a fleet of B scenarios, simgrid_tpu/ops/lmm_batch.py
// `_batch_superstep_program`, `_batch_fused_fresh`/`_cont` and
// lmm_jax.py `_solve_kernel_chunk_batched[_fresh]`, the solo programs
// vmapped over the replicas): blockIdx.y picks the replica, and `rep`
// moves every per-replica pointer to its row (penalties, bounds, the
// fixpoint state and scratch, the two minima, the control words; the
// element weights and rate bounds when they are per replica).  The
// element list, both row indexes and the FATPIPE flags are shared.  A
// replica's rows fold in exactly the solo warp-lane order, and its
// guards read its own control words, so a replica equals its solo run
// by bits and one launch serves the whole fleet.  B = 1 is the solo
// launch, with the solo grid.

#include "common.cuh"

#define ARM_BOUNDS 1
#define ARM_FATPIPE 2
#define ARM_GLOBAL 4
#define N_PTRS 28

namespace {

// Every buffer of the fixpoint, in the order of kernels/lmm_round.py
// `_ptrs`; unused arms' pointers are NULL.
template <typename T>
struct Sys {
  int V, C, flags;
  T eps;
  // the replica axis: per-replica strides (in elements) of the element
  // weights, bounds and rate bounds (0: shared by every replica)
  long long s_ew;
  int s_cb, s_vb;
  const T* pen;
  const T* vb;
  const int* e_var;
  const int* e_cnst;
  const T* e_w;
  const T* c_bound;
  const bool* c_fat;
  const int* c_ptr;
  const int* c_idx;
  const int* v_ptr;
  const int* v_idx;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  T* nmin_v;
  bool* proc;
  bool* fix_now;
  bool* low_v;
  T* mb_v;
  T* level2_v;
  T* mb_c;
  bool* blocked_c;
  T* rou;
  unsigned long long* min_usage;
  unsigned long long* min_bound;
  int* ctrl;
};

template <typename T>
Sys<T> make_sys(int V, int C, int flags, double eps, void** p,
                long long s_ew, int s_cb, int s_vb) {
  Sys<T> s;
  s.V = V;
  s.C = C;
  s.flags = flags;
  s.eps = (T)eps;
  s.s_ew = s_ew;
  s.s_cb = s_cb;
  s.s_vb = s_vb;
  s.pen = (const T*)p[0];
  s.vb = (const T*)p[1];
  s.e_var = (const int*)p[2];
  s.e_cnst = (const int*)p[3];
  s.e_w = (const T*)p[4];
  s.c_bound = (const T*)p[5];
  s.c_fat = (const bool*)p[6];
  s.c_ptr = (const int*)p[7];
  s.c_idx = (const int*)p[8];
  s.v_ptr = (const int*)p[9];
  s.v_idx = (const int*)p[10];
  s.v_value = (T*)p[11];
  s.v_fixed = (bool*)p[12];
  s.remaining = (T*)p[13];
  s.usage = (T*)p[14];
  s.light = (bool*)p[15];
  s.nmin_v = (T*)p[16];
  s.proc = (bool*)p[17];
  s.fix_now = (bool*)p[18];
  s.low_v = (bool*)p[19];
  s.mb_v = (T*)p[20];
  s.level2_v = (T*)p[21];
  s.mb_c = (T*)p[22];
  s.blocked_c = (bool*)p[23];
  s.rou = (T*)p[24];
  s.min_usage = (unsigned long long*)p[25];
  s.min_bound = (unsigned long long*)p[26];
  s.ctrl = (int*)p[27];
  return s;
}

// Replica blockIdx.y of a fleet: its penalties, bounds, weights (when
// per replica), fixpoint state, scratch, minima and control words.  The
// element list, row indexes and FATPIPE flags are shared.
template <typename T>
__device__ __forceinline__ Sys<T> rep(Sys<T> s) {
  long long b = blockIdx.y;
  if (b == 0) return s;
  long long bv = b * s.V, bc = b * s.C;
  s.pen += bv;
  if (s.vb) s.vb += b * s.s_vb;
  s.e_w += b * s.s_ew;
  s.c_bound += b * s.s_cb;
  s.v_value += bv;
  s.v_fixed += bv;
  s.nmin_v += bv;
  s.fix_now += bv;
  s.low_v += bv;
  s.mb_v += bv;
  s.level2_v += bv;
  s.remaining += bc;
  s.usage += bc;
  s.light += bc;
  s.proc += bc;
  s.mb_c += bc;
  s.blocked_c += bc;
  s.rou += bc;
  s.min_usage += b;
  s.min_bound += b;
  s.ctrl += b * N_CTRL;
  return s;
}

__device__ __forceinline__ bool round_go(const int* ctrl) {
  return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
         ctrl[C_IT] < ctrl[C_LIMIT];
}

// a live variable: enabled (penalty > 0) and not fixed yet
template <typename T>
__device__ __forceinline__ bool var_live(const Sys<T>& s, int v) {
  return s.pen[v] > T(0) && !s.v_fixed[v];
}

template <typename T>
__device__ __forceinline__ T rou_of(const Sys<T>& s, int c) {
  return div_rn(s.remaining[c], s.usage[c]);
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
__global__ void init_var(Sys<T> s0, int gated, int limit) {
  Sys<T> s = rep(s0);
  int* ctrl = s.ctrl;
  int go = gated ? ctrl[C_SS_ACTIVE] : 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctrl[C_ARMED] = go;
    if (go) {
      ctrl[C_IT] = 0;
      ctrl[C_LIGHT] = 0;
      ctrl[C_LIGHT_ACC] = 0;
      int lim = limit;
      if (gated) {
        lim = ctrl[C_SS_BUDGET] - ctrl[C_SS_ROUNDS];
        if (lim > MAX_ROUNDS) lim = MAX_ROUNDS;
      }
      ctrl[C_LIMIT] = lim;
    }
  }
  if (!go) return;
  FOR_VARS(v) {
    T p = s.pen[v];
    // parked variables carry penalty inf; inf*0 is NaN, so sanitise
    T base = finite_v(p) ? p : T(0);
    s.v_value[v] = mul_rn(base, T(0));
    s.v_fixed[v] = p < T(0);
  }
}

// usage0: in-order sum of w/penalty for SHARED rows, max for FATPIPE rows
template <typename T>
__global__ void init_cnst(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!s.ctrl[C_ARMED]) return;
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    bool fat = (s.flags & ARM_FATPIPE) && s.c_fat[c];
    T use = row_usage0(s.c_ptr, s.c_idx, s.e_var, s.e_w, s.pen, c, lane,
                       fat);
    if (lane == 0) {
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

// Pass A: nmin_v = min rou over the variable's live elements.
template <typename T>
__global__ void round_a(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v)) {
      for (int j = s.v_ptr[v], end = s.v_ptr[v + 1]; j < end; ++j) {
        int e = s.v_idx[j];
        if (s.e_w[e] > T(0)) {
          int c = s.e_cnst[e];
          if (s.light[c]) m = min_v(m, rou_of(s, c));
        }
      }
    }
    s.nmin_v[v] = m;
  }
}

// Pass B: a light constraint is processable when its rou is at most
// the two-hop neighbourhood min.
template <typename T>
__global__ void round_b(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    for (int j = s.c_ptr[c] + lane, end = s.c_ptr[c + 1]; j < end;
         j += 32) {
      int e = s.c_idx[j];
      int v = s.e_var[e];
      if (s.e_w[e] > T(0) && var_live(s, v)) m = min_v(m, s.nmin_v[v]);
    }
    m = warp_min(m);
    if (lane == 0) {
      bool lt = s.light[c];
      T rou = lt ? rou_of(s, c) : inf_v<T>();
      s.proc[c] = lt && rou <= m;
    }
  }
}

// Bound pass 1: low_v = saturated (touches a processable constraint),
// bounded, and bound * penalty below its level nmin_v.
template <typename T>
__global__ void bnd_low(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_VARS(v) {
    bool lv = false;
    if (var_live(s, v) && s.vb[v] > T(0)) {
      bool sat = false;
      for (int j = s.v_ptr[v], end = s.v_ptr[v + 1]; j < end && !sat;
           ++j) {
        int e = s.v_idx[j];
        sat = s.e_w[e] > T(0) && s.proc[s.e_cnst[e]];
      }
      lv = sat && mul_rn(s.vb[v], s.pen[v]) < s.nmin_v[v];
    }
    s.low_v[v] = lv;
  }
}

// Bound pass 2: mb_c = min bound * penalty over the constraint's live
// low-bound variables, inf unless the constraint is processable.
template <typename T>
__global__ void bnd_mbc(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    for (int j = s.c_ptr[c] + lane, end = s.c_ptr[c + 1]; j < end;
         j += 32) {
      int e = s.c_idx[j];
      int v = s.e_var[e];
      if (s.e_w[e] > T(0) && var_live(s, v) && s.low_v[v])
        m = min_v(m, mul_rn(s.vb[v], s.pen[v]));
    }
    m = warp_min(m);
    if (lane == 0) s.mb_c[c] = s.proc[c] ? m : inf_v<T>();
  }
}

// Bound pass 3: mb_v = min mb_c over the variable's processable
// constraints.
template <typename T>
__global__ void bnd_mbv(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v)) {
      for (int j = s.v_ptr[v], end = s.v_ptr[v + 1]; j < end; ++j) {
        int e = s.v_idx[j];
        if (s.e_w[e] > T(0)) {
          int c = s.e_cnst[e];
          if (s.proc[c]) m = min_v(m, s.mb_c[c]);
        }
      }
    }
    s.mb_v[v] = m;
  }
}

// Bound pass 4: a processable constraint is blocked when one of its
// live variables has a finite mb_v (it waits for the bound fixes).
template <typename T>
__global__ void bnd_blk(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    bool pc = s.proc[c];
    bool b = false;
    if (pc) {
      for (int j = s.c_ptr[c] + lane, end = s.c_ptr[c + 1]; j < end;
           j += 32) {
        int e = s.c_idx[j];
        int v = s.e_var[e];
        if (s.e_w[e] > T(0) && var_live(s, v) && finite_v(s.mb_v[v]))
          b = true;
      }
    }
    b = __any_sync(FULL_MASK, b);
    if (lane == 0) s.blocked_c[c] = b;
  }
}

// Pass C: a live variable touching a processable (unblocked) constraint
// is fixed at its minimal such rou over its penalty; with bounds, a
// low-bound variable at its constraint's minimal bound is fixed at its
// bound first.
template <typename T>
__global__ void round_c(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  bool bounds = s.flags & ARM_BOUNDS;
  FOR_VARS(v) {
    bool fx = false;
    T p = s.pen[v];
    T m = inf_v<T>();
    if (p > T(0) && !s.v_fixed[v]) {
      for (int j = s.v_ptr[v], end = s.v_ptr[v + 1]; j < end; ++j) {
        int e = s.v_idx[j];
        if (s.e_w[e] > T(0)) {
          int c = s.e_cnst[e];
          if (s.proc[c] && !(bounds && s.blocked_c[c]))
            m = min_v(m, rou_of(s, c));
        }
      }
      bool fix_bound = false;
      if (bounds && s.low_v[v]) {
        T d = sub_rn(mul_rn(s.vb[v], p), s.mb_v[v]);
        fix_bound = fabs(d) < s.eps;
      }
      if (fix_bound) {
        s.v_value[v] = s.vb[v];
        s.v_fixed[v] = true;
        fx = true;
      } else if (finite_v(m)) {
        s.v_value[v] = div_rn(m, p);
        s.v_fixed[v] = true;
        fx = true;
      }
    }
    if (bounds) s.level2_v[v] = m;
    s.fix_now[v] = fx;
  }
}

// --------------------------------------------------------- global order

template <typename T>
__global__ void glob_reset(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  *s.min_usage = key_of(inf_v<T>());
  *s.min_bound = key_of(inf_v<T>());
}

// rou of every constraint, stored once, and its grid-wide min
template <typename T>
__global__ void glob_rou(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  T m = inf_v<T>();
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < s.C;
       c += gridDim.x * blockDim.x) {
    T r = s.light[c] ? rou_of(s, c) : inf_v<T>();
    s.rou[c] = r;
    m = min_v(m, r);
  }
  block_min_to(m, s.min_usage);
}

// saturated variables: a live element in a light constraint whose
// stored rou equals the min.  Bound-free: fix them at min/penalty.
// With bounds: record v_sat (in low_v) and the grid-wide min of
// bound * penalty over saturated bounded variables below the min.
template <typename T>
__global__ void glob_sat(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  bool bounds = s.flags & ARM_BOUNDS;
  T mu = from_key<T>(*s.min_usage);
  T mb = inf_v<T>();
  FOR_VARS(v) {
    bool sat = false;
    T p = s.pen[v];
    if (p > T(0) && !s.v_fixed[v]) {
      for (int j = s.v_ptr[v], end = s.v_ptr[v + 1]; j < end && !sat;
           ++j) {
        int e = s.v_idx[j];
        if (s.e_w[e] > T(0)) {
          int c = s.e_cnst[e];
          sat = s.light[c] && s.rou[c] == mu;
        }
      }
    }
    if (!bounds) {
      if (sat) {
        s.v_value[v] = div_rn(mu, p);
        s.v_fixed[v] = true;
      }
      s.fix_now[v] = sat;
      continue;
    }
    s.low_v[v] = sat;
    if (sat && s.vb[v] > T(0)) {
      T bp = mul_rn(s.vb[v], p);
      if (bp < mu) mb = min_v(mb, bp);
    }
  }
  if (bounds) block_min_to(mb, s.min_bound);
}

// with bounds: when some saturated bound sits below the min, fix only
// the variables at the smallest such bound, at their bound; otherwise
// every saturated variable at min/penalty
template <typename T>
__global__ void glob_fix(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
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

// Pass D: in-order d_rem / d_use sums of the fixed variables, eps
// clamps, the FATPIPE usage max over still-live elements, light-set
// pruning; counts the light set.  The FATPIPE arm is a template
// argument: this is the round's hottest pass, and the SHARED-only
// loop must not carry the max's branch.
template <typename T, bool FAT>
__global__ void round_d(Sys<T> s0) {
  Sys<T> s = rep(s0);
  if (!round_go(s.ctrl)) return;
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    int beg = s.c_ptr[c], end = s.c_ptr[c + 1];
    bool fat = FAT && s.c_fat[c];
    T d_rem = T(0), d_use = T(0), umax = T(0);
    bool touched = false, has_live = false;
    for (int base = beg; base < end; base += 32) {
      int j = base + lane;
      T xr = T(0), xu = T(0);
      bool fx = false, lv = false;
      if (j < end) {
        int e = s.c_idx[j];
        int v = s.e_var[e];
        T w = s.e_w[e];
        T p = s.pen[v];
        bool valid = w > T(0) && p > T(0);
        fx = valid && s.fix_now[v];
        lv = valid && !s.v_fixed[v];
        // the division only where a sum or the FATPIPE max reads it
        if (fx || (fat && lv)) xu = div_rn(w, p);
        if (fx) xr = mul_rn(w, s.v_value[v]);
      }
      unsigned m = __ballot_sync(FULL_MASK, fx);
      if (m) touched = true;
      while (m) {
        int l = __ffs(m) - 1;
        m &= m - 1;
        d_rem = add_rn(d_rem, __shfl_sync(FULL_MASK, xr, l));
        d_use = add_rn(d_use, __shfl_sync(FULL_MASK, xu, l));
      }
      if (fat) umax = max_v(umax, warp_max(lv ? xu : T(0)));
      if (__any_sync(FULL_MASK, lv)) has_live = true;
    }
    if (lane == 0) {
      T ce = mul_rn(s.c_bound[c], s.eps);
      T rem = s.remaining[c], use = s.usage[c];
      if (touched) {
        T nr = sub_rn(rem, d_rem);
        if (nr < ce) nr = T(0);
        T nu = sub_rn(use, d_use);
        if (nu < s.eps) nu = T(0);
        if (fat) {
          // a FATPIPE row keeps its remaining (lmm_jax.py:496)
          use = umax;
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

__global__ void round_e(int* ctrl) {
  ctrl += (long long)blockIdx.y * N_CTRL;
  if (!round_go(ctrl)) return;
  ctrl[C_LIGHT] = ctrl[C_LIGHT_ACC];
  ctrl[C_LIGHT_ACC] = 0;
  ctrl[C_IT] += 1;
}

const int TB = 256;

template <typename T>
int launch_init(Sys<T> s, int B, int gated, int limit, cudaStream_t st) {
  init_var<T><<<grid_b(s.V, TB, B), TB, 0, st>>>(s, gated, limit);
  init_cnst<T><<<grid_b((long long)s.C * 32, TB, B), TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_round(Sys<T> s, int B, cudaStream_t st) {
  dim3 gv = grid_b(s.V, TB, B), gc = grid_b((long long)s.C * 32, TB, B);
  if (s.flags & ARM_GLOBAL) {
    glob_reset<T><<<grid_r(B), 1, 0, st>>>(s);
    glob_rou<T><<<grid_b(s.C, TB, B), TB, 0, st>>>(s);
    glob_sat<T><<<gv, TB, 0, st>>>(s);
    if (s.flags & ARM_BOUNDS) glob_fix<T><<<gv, TB, 0, st>>>(s);
  } else {
    round_a<T><<<gv, TB, 0, st>>>(s);
    round_b<T><<<gc, TB, 0, st>>>(s);
    if (s.flags & ARM_BOUNDS) {
      bnd_low<T><<<gv, TB, 0, st>>>(s);
      bnd_mbc<T><<<gc, TB, 0, st>>>(s);
      bnd_mbv<T><<<gv, TB, 0, st>>>(s);
      bnd_blk<T><<<gc, TB, 0, st>>>(s);
    }
    round_c<T><<<gv, TB, 0, st>>>(s);
  }
  if (s.flags & ARM_FATPIPE)
    round_d<T, true><<<gc, TB, 0, st>>>(s);
  else
    round_d<T, false><<<gc, TB, 0, st>>>(s);
  round_e<<<grid_r(B), 1, 0, st>>>(s.ctrl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B replicas in one launch (blockIdx.y); s_ew, s_cb and s_vb are the
// per-replica strides of e_w, c_bound and vb (0: shared).
int lmm_init(int dbl, int B, int V, int C, int flags, void** ptrs,
             int n_ptrs, double eps, int gated, int limit, long long s_ew,
             int s_cb, int s_vb, void* stream) {
  if (n_ptrs != N_PTRS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_init(
        make_sys<double>(V, C, flags, eps, ptrs, s_ew, s_cb, s_vb), B,
        gated, limit, st);
  return launch_init(make_sys<float>(V, C, flags, eps, ptrs, s_ew, s_cb, s_vb),
                     B, gated, limit, st);
}

int lmm_round(int dbl, int B, int V, int C, int flags, void** ptrs,
              int n_ptrs, double eps, long long s_ew, int s_cb, int s_vb,
              void* stream) {
  if (n_ptrs != N_PTRS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_round(
        make_sys<double>(V, C, flags, eps, ptrs, s_ew, s_cb, s_vb), B, st);
  return launch_round(make_sys<float>(V, C, flags, eps, ptrs, s_ew, s_cb, s_vb),
                      B, st);
}

}  // extern "C"
