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
// What bounds it on this card: latency, then memory.  A local round
// walks the cv table four times and the vc table four times (nmin, low
// bounds, mb_v, levels); at the headline's shapes (C 16,384 x Wc 64, V
// 131,072 x Wv 4) that is some 60 MB of table and gathered state a
// round, about 18 us at 3.35 TB/s.  A round is a chain of grid-wide
// dependencies, eight passes in local order and four in global order;
// at small live sets the launches, not the bytes, set its time.
//
// What the design does about it:
// * one thread per variable row (Wv is route-length short) and one warp
//   per constraint row (Wc runs to 512), lanes across the row, so the
//   cv table is read coalesced;
// * what a solve keeps fixed is computed once a chunk, not once a
//   round: `ell_prep` (a K16 step at the head of the chunk's graph,
//   outside its round loop) writes each cv entry's w / penalty into
//   `cv_upen` (0 where the entry is not enabled) and whether it is
//   enabled into `cv_ev` (the penalties do not change within a solve),
//   and each constraint's level rou = remaining
//   / usage (inf when not light) into `rou`; the init writes all three
//   too (from the values it computes anyway), and a_apply's row leader rewrites it whenever it updates a row
//   (the same division, so the same bits), so the variable passes read
//   one stored level an entry where they divided before;
// * every pass after a round's first is a programmatic dependent launch
//   (`launch_dependent`; it waits for the pass before it in
//   `pdl_wait`, with no explicit trigger);
// * the bound passes skip when no bound binds: l_low counts the round's
//   low_v rows into NLOW, and with none l_mbc, l_mbv and l_blk return at
//   once and l_fix takes mb_v as inf and blocked_c as false without
//   reading them (exactly what the JAX round computes when no low_v row
//   exists: lmm_jax.py:341-352);
// * a_apply ends the round itself: its blocks' light counts travel in
//   one 64-bit ticket word (no fence), and the block that takes the last
//   ticket sets LIGHT, bumps IT, clears NLOW and the global order's two
//   minima for the next round and, captured as the body of a K16 loop
//   built with `Loop(..., ends=True)`, counts the iteration and sets the
//   WHILE node's condition (`end_iteration`), so the body has no
//   one-thread commit and no `loop_cond` node;
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
#define N_PTRS 28

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
  T* cv_upen;
  bool* cv_ev;
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
  s.cv_upen = (T*)p[26];
  s.cv_ev = (bool*)p[27];
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
__device__ __forceinline__ T rou_new(bool lt, T rem, T use) {
  return lt ? div_rn(rem, use) : inf_v<T>();
}

// w / penalty of an enabled element of a cv row (0 otherwise), from the
// penalties (ell_prep, the init)
template <typename T>
__device__ __forceinline__ T upen_from_pen(const ESys<T>& s, int idx,
                                           bool* evalid) {
  T p = s.pen[s.cv_var[idx]];
  *evalid = s.cv_valid[idx] && p > T(0);
  return *evalid ? div_rn(s.cv_w[idx], p) : T(0);
}

// the round's reset of what it accumulates: the low-bound count and the
// global order's two minima
template <typename T>
__device__ __forceinline__ void reset_round(const ESys<T>& s) {
  s.ctrl[C_NLOW] = 0;
  *s.min_usage = key_of(inf_v<T>());
  *s.min_bound = key_of(inf_v<T>());
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
    reset_round(s);
  }
  FOR_VARS(v) {
    T p = s.pen[v];
    s.v_value[v] = mul_rn(finite_v(p) ? p : T(0), T(0));
    s.v_fixed[v] = p < T(0);
  }
}

// usage0 (the 32-block fold of w/penalty, or the max on a FATPIPE row),
// remaining0, light0, rou0, cv_live0 (an enabled element whose variable
// is not fixed at init, i.e. penalty > 0) and the w / penalty and
// enabled tables, so that a round may follow the init at once
template <typename T>
__global__ void ei_cnst(ESys<T> s) {
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    T usum = T(0), umax = T(0);
    for (int base = -row_low(s.Wc); base < s.Wc; base += 32) {
      int j = base + lane;
      T x = T(0);
      if (j >= 0 && j < s.Wc) {
        int idx = c * s.Wc + j;
        bool ev;
        x = upen_from_pen(s, idx, &ev);
        s.cv_live[idx] = ev;
        s.cv_upen[idx] = x;
        s.cv_ev[idx] = ev;
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
      s.rou[c] = rou_new(lt, cb, use);
      cnt += lt;
    }
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_LIGHT, tot);
}

// the chunk's prep: rou from the state, the w / penalty and enabled
// tables, and the round's accumulators cleared
template <typename T>
__global__ void ep_prep(ESys<T> s) {
  if (blockIdx.x == 0 && threadIdx.x == 0) reset_round(s);
  long long n = (long long)s.C * s.Wc;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n || i < s.C; i += (long long)gridDim.x * blockDim.x) {
    if (i < s.C)
      s.rou[i] = rou_new(s.light[i], s.remaining[i], s.usage[i]);
    if (i < n) {
      bool ev;
      s.cv_upen[i] = upen_from_pen(s, (int)i, &ev);
      s.cv_ev[i] = ev;
    }
  }
}

// ---------------------------------------------------------- local order

// L1: nmin_v = min rou over the variable's live row entries
template <typename T>
__global__ void l_nmin(ESys<T> s) {
  pdl_wait();
  if (!ell_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v))
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) m = min_v(m, s.rou[s.vc_cnst[idx]]);
      }
    s.nmin_v[v] = m;
  }
}

// L2: nmin_c over the row's cv_live entries; processable (no walk for
// a row that is not light)
template <typename T>
__global__ void l_proc(ESys<T> s) {
  pdl_wait();
  if (!ell_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    bool lt = s.light[c];
    T m = inf_v<T>();
    if (lt)
      for (int j = lane; j < s.Wc; j += 32) {
        int idx = c * s.Wc + j;
        if (s.cv_live[idx]) m = min_v(m, s.nmin_v[s.cv_var[idx]]);
      }
    m = warp_min(m);
    if (lane == 0) s.proc[c] = lt && s.rou[c] <= m;
  }
}

// L3: low_v = saturated, bounded, bound * penalty below nmin_v; the
// round's low_v rows counted into NLOW
template <typename T>
__global__ void l_low(ESys<T> s) {
  pdl_wait();
  if (!ell_go(s.ctrl)) return;
  int cnt = 0;
  FOR_VARS(v) {
    bool sat = false;
    if (var_live(s, v))
      for (int l = 0; l < s.Wv && !sat; ++l) {
        int idx = v * s.Wv + l;
        sat = s.vc_valid[idx] && s.proc[s.vc_cnst[idx]];
      }
    bool low = sat && s.vb[v] > T(0) &&
               mul_rn(s.vb[v], s.pen[v]) < s.nmin_v[v];
    s.low_v[v] = low;
    cnt += low;
  }
  int tot = block_sum(cnt);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_NLOW, tot);
}

// the bound passes run only in a round with a low_v row
__device__ __forceinline__ bool bounds_go(const int* ctrl) {
  return ell_go(ctrl) && ctrl[C_NLOW] > 0;
}

// L4: mb_c = min bound * penalty over the row's live low-bound entries
// (no walk for a row that is not processable)
template <typename T>
__global__ void l_mbc(ESys<T> s) {
  pdl_wait();
  if (!bounds_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    if (s.proc[c])
      for (int j = lane; j < s.Wc; j += 32) {
        int idx = c * s.Wc + j;
        int v = s.cv_var[idx];
        if (s.cv_live[idx] && s.low_v[v])
          m = min_v(m, mul_rn(s.vb[v], s.pen[v]));
      }
    m = warp_min(m);
    if (lane == 0) s.mb_c[c] = m;
  }
}

// L5: mb_v = min mb_c over the variable's processable live entries
template <typename T>
__global__ void l_mbv(ESys<T> s) {
  pdl_wait();
  if (!bounds_go(s.ctrl)) return;
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
  pdl_wait();
  if (!bounds_go(s.ctrl)) return;
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

// L7: levels over processable unblocked rows; bound fixes first (with
// no low_v row this round: no row blocked, no bound fix)
template <typename T>
__global__ void l_fix(ESys<T> s) {
  pdl_wait();
  if (!ell_go(s.ctrl)) return;
  bool bounds = s.ctrl[C_NLOW] > 0;
  FOR_VARS(v) {
    T p = s.pen[v];
    T m = inf_v<T>();
    bool live = var_live(s, v);
    if (live)
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) {
          int c = s.vc_cnst[idx];
          if (s.proc[c] && !(bounds && s.blocked_c[c]))
            m = min_v(m, s.rou[c]);
        }
      }
    bool fix_bound = false;
    if (bounds && s.low_v[v]) {
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

// the min of the stored levels (the previous round's end, the prep or
// the init cleared both minima)
template <typename T>
__global__ void g_rou(ESys<T> s) {
  pdl_wait();
  if (!ell_go(s.ctrl)) return;
  T m = inf_v<T>();
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < s.C;
       c += gridDim.x * blockDim.x)
    m = min_v(m, s.rou[c]);
  block_min_to(m, s.min_usage);
}

// saturated variables (a live entry in a light row at the min) into
// low_v; the grid-wide min of bound * penalty below the min over them
template <typename T>
__global__ void g_sat(ESys<T> s) {
  pdl_wait();
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
  pdl_wait();
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
// FATPIPE max over still-live entries; then the clamps, light-set
// pruning and the row's level, counting the light set.  The block that
// takes the last ticket ends the round (file comment).
template <typename T, bool FAT>
__global__ void a_apply(ESys<T> s, LoopEnd le) {
  pdl_wait();
  if (!ell_go(s.ctrl)) {
    if (le.h && blockIdx.x == 0 && threadIdx.x == 0)
      cudaGraphSetConditional(le.h, 0u);
    return;
  }
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    T d_rem = T(0), d_use = T(0), umax = T(0);
    bool touched = false, has_live = false;
    bool frow = FAT && s.c_fat[c];  // only a FATPIPE row takes the max
    for (int base = -row_low(s.Wc); base < s.Wc; base += 32) {
      int j = base + lane;
      T xr = T(0), xu = T(0), xl = T(0);
      bool fx = false, lv = false;
      if (j >= 0 && j < s.Wc) {
        int idx = c * s.Wc + j;
        int v = s.cv_var[idx];
        bool g_fixed = s.v_fixed[v];
        fx = s.cv_live[idx] && g_fixed;
        lv = s.cv_ev[idx] && !g_fixed;
        s.cv_live[idx] = lv;
        if (fx) {
          xr = mul_rn(s.cv_w[idx], s.v_value[v]);
          xu = s.cv_upen[idx];
        }
        if (frow && lv) xl = s.cv_upen[idx];
      }
      d_rem = add_rn(d_rem, warp_block_sum(xr));
      d_use = add_rn(d_use, warp_block_sum(xu));
      if (__any_sync(FULL_MASK, fx)) touched = true;
      if (__any_sync(FULL_MASK, lv)) has_live = true;
      if (frow) umax = max_v(umax, warp_max(xl));
    }
    if (lane == 0) {
      T ce = mul_rn(s.c_bound[c], s.eps);
      T rem = s.remaining[c], use = s.usage[c];
      if (touched) {
        T nr = sub_rn(rem, d_rem);
        if (nr < ce) nr = T(0);
        T nu = sub_rn(use, d_use);
        if (nu < s.eps) nu = T(0);
        if (frow) {
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
      s.rou[c] = rou_new(lt, rem, use);
      cnt += lt;
    }
  }
  // the round's end: one 64-bit ticket, 1 << 32 a block plus its light
  // rows; the last block's thread 0 holds the light count
  int tot = block_sum(cnt);  // valid in thread 0
  if (threadIdx.x != 0) return;
  unsigned long long* ticket = ticket_of(s.ctrl);
  unsigned long long old = atomicAdd(ticket, (1ULL << 32) | (unsigned)tot);
  if ((unsigned)(old >> 32) != gridDim.x - 1) return;
  *ticket = 0ULL;
  int* ctrl = s.ctrl;
  ctrl[C_LIGHT] = (int)((unsigned)old + (unsigned)tot);
  ctrl[C_IT] += 1;
  reset_round(s);
  if (le.h) end_iteration(le, ell_go(ctrl));
}

const int TB = 256;

template <typename T>
int launch_init(ESys<T> s, int limit, cudaStream_t st) {
  ei_var<T><<<grid_for(s.V, TB), TB, 0, st>>>(s, limit);
  ei_cnst<T><<<grid_for((long long)s.C * 32, TB), TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_prep(ESys<T> s, cudaStream_t st) {
  long long n = (long long)s.C * s.Wc;
  int g = grid_for(n > s.C ? n : s.C, TB);
  ep_prep<T><<<g, TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_round(ESys<T> s, int flags, LoopEnd le, cudaStream_t st) {
  dim3 gv(grid_for(s.V, TB)), gc(grid_for((long long)s.C * 32, TB));
  cudaError_t e = cudaSuccess;
  if (flags & ARM_GLOBAL) {
    g_rou<T><<<grid_for(s.C, TB), TB, 0, st>>>(s);
    e = launch_dependent(g_sat<T>, gv, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(g_fix<T>, gv, TB, st, s);
  } else {
    l_nmin<T><<<gv, TB, 0, st>>>(s);
    e = launch_dependent(l_proc<T>, gc, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(l_low<T>, gv, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(l_mbc<T>, gc, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(l_mbv<T>, gv, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(l_blk<T>, gc, TB, st, s);
    if (e == cudaSuccess) e = launch_dependent(l_fix<T>, gv, TB, st, s);
  }
  if (e == cudaSuccess)
    e = (flags & ARM_FATPIPE)
            ? launch_dependent(a_apply<T, true>, gc, TB, st, s, le)
            : launch_dependent(a_apply<T, false>, gc, TB, st, s, le);
  if (e != cudaSuccess) return (int)e;
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

// rou from the state, the w / penalty table and the round's
// accumulators cleared: before the first round of a chunk
int ell_prep(int dbl, int V, int C, int Wc, int Wv, void** ptrs, int n_ptrs,
             void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) return launch_prep(make_sys<double>(V, C, Wc, Wv, 0.0, ptrs), st);
  return launch_prep(make_sys<float>(V, C, Wc, Wv, 0.0, ptrs), st);
}

// One round; cnt, tally, cap and handle: the K16 loop whose body this
// round ends (handle 0: none).
int ell_round(int dbl, int V, int C, int Wc, int Wv, int flags, void** ptrs,
              int n_ptrs, double eps, void* cnt, void* tally, int cap,
              unsigned long long handle, void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LoopEnd le{(int*)cnt, (int*)tally, cap,
             (cudaGraphConditionalHandle)handle};
  if (dbl)
    return launch_round(make_sys<double>(V, C, Wc, Wv, eps, ptrs), flags,
                        le, st);
  return launch_round(make_sys<float>(V, C, Wc, Wv, eps, ptrs), flags, le,
                      st);
}

}  // extern "C"
