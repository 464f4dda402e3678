// K8 vc_round: the bound-free local round on the variable-row tables.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `_vc_round_body` (:629-703), the
// round `fixpoint_ell` runs as `body_local_vc` for a local, bound-free
// system and the compaction chain runs in its stages and finisher.
//
// Tables: vc_cnst/vc_w/vc_valid [V, Wv] flat, row-major, and the
// constraint index over them (vcx_ptr [C+1], vcx_idx: each constraint's
// valid entries as flat positions v * Wv + lane, increasing).
//
// The JAX round sums per constraint with scatter-adds over [V, Wv],
// which XLA:CPU applies in update order (row-major, from 0.0).  Here a
// warp walks a constraint's index entries 32 at a time and folds them
// into its running sums lane by lane (`warp_fold_into`), so every sum
// adds the same values in the same order; no f64 atomics.  The
// scatter-min (nmin_c) and scatter-max (the FATPIPE usage) are
// order-free and read the same index.
//
// The round also counts the variables still live after it (enabled and
// not fixed) into VLIVE, and its guard requires VLIVE > HALF: a chain
// stage (K9 arms HALF and LIMIT, K16 loops while the guard holds) runs
// its rounds without a host sync and they stop once the live set fits
// the next stage.
//
// What bounds it on this card: memory, then launches.  A round reads
// the vc table twice through the rows (nmin, levels) and twice through
// the index (nmin_c, sums): at the headline's V 131,072 x Wv 4 some
// 10 MB, about 3 us at 3.35 TB/s, below the five launches' latency.
//
// What the design does about it: one thread per variable row, one warp
// per constraint's index segment; rou is recomputed from remaining and
// usage where it is read (the same division, so the same bits) instead
// of a pass of its own.

#include "common.cuh"

#define N_PTRS 17

namespace {

template <typename T>
struct VSys {
  int V, C, Wv, fat;
  T eps;
  const T* pen;
  const int* vc_cnst;
  const T* vc_w;
  const bool* vc_valid;
  const T* c_bound;
  const bool* c_fat;
  const int* vcx_ptr;
  const int* vcx_idx;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  T* nmin_v;
  bool* proc;
  bool* fix_now;
  int* ctrl;
};

template <typename T>
VSys<T> make_sys(int V, int C, int Wv, int fat, double eps, void** p) {
  VSys<T> s;
  s.V = V;
  s.C = C;
  s.Wv = Wv;
  s.fat = fat;
  s.eps = (T)eps;
  s.pen = (const T*)p[0];
  s.vc_cnst = (const int*)p[1];
  s.vc_w = (const T*)p[2];
  s.vc_valid = (const bool*)p[3];
  s.c_bound = (const T*)p[4];
  s.c_fat = (const bool*)p[5];
  s.vcx_ptr = (const int*)p[6];
  s.vcx_idx = (const int*)p[7];
  s.v_value = (T*)p[8];
  s.v_fixed = (bool*)p[9];
  s.remaining = (T*)p[10];
  s.usage = (T*)p[11];
  s.light = (bool*)p[12];
  s.nmin_v = (T*)p[13];
  s.proc = (bool*)p[14];
  s.fix_now = (bool*)p[15];
  s.ctrl = (int*)p[16];
  return s;
}

__device__ __forceinline__ bool vc_go(const int* ctrl) {
  return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
         ctrl[C_IT] < ctrl[C_LIMIT] && ctrl[C_VLIVE] > ctrl[C_HALF];
}

template <typename T>
__device__ __forceinline__ bool var_live(const VSys<T>& s, int v) {
  return s.pen[v] > T(0) && !s.v_fixed[v];
}

template <typename T>
__device__ __forceinline__ T rou_of(const VSys<T>& s, int c) {
  return s.light[c] ? div_rn(s.remaining[c], s.usage[c]) : inf_v<T>();
}

#define FOR_VARS(v) \
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < s.V; \
       v += gridDim.x * blockDim.x)

#define FOR_CNST_WARPS(c)                                            \
  int lane = threadIdx.x & 31;                                       \
  int warps = (gridDim.x * blockDim.x) >> 5;                         \
  for (int c = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; c < s.C; \
       c += warps)

// nmin_v = min rou over the variable's live entries
template <typename T>
__global__ void v_nmin(VSys<T> s) {
  if (!vc_go(s.ctrl)) return;
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

// nmin_c = min nmin_v over the constraint's live entries; processable
template <typename T>
__global__ void c_proc(VSys<T> s) {
  if (!vc_go(s.ctrl)) return;
  FOR_CNST_WARPS(c) {
    T m = inf_v<T>();
    for (int j = s.vcx_ptr[c] + lane, end = s.vcx_ptr[c + 1]; j < end;
         j += 32) {
      int v = s.vcx_idx[j] / s.Wv;
      if (var_live(s, v)) m = min_v(m, s.nmin_v[v]);
    }
    m = warp_min(m);
    if (lane == 0) s.proc[c] = s.light[c] && rou_of(s, c) <= m;
  }
}

// level2 over processable entries; fix; count the live variables left
template <typename T>
__global__ void v_fix(VSys<T> s) {
  if (!vc_go(s.ctrl)) return;
  int live = 0;
  FOR_VARS(v) {
    T p = s.pen[v];
    bool fx = false;
    if (var_live(s, v)) {
      T m = inf_v<T>();
      for (int l = 0; l < s.Wv; ++l) {
        int idx = v * s.Wv + l;
        if (s.vc_valid[idx]) {
          int c = s.vc_cnst[idx];
          if (s.proc[c]) m = min_v(m, rou_of(s, c));
        }
      }
      if (finite_v(m)) {
        s.v_value[v] = div_rn(m, p);
        s.v_fixed[v] = true;
        fx = true;
      } else {
        live = live + 1;
      }
    }
    s.fix_now[v] = fx;
  }
  int tot = block_sum(live);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_VLIVE_ACC, tot);
}

// the in-order sums of the entries fixed now, the live count, the
// FATPIPE max; clamps and light-set pruning, counting the light set
template <typename T, bool FAT>
__global__ void c_apply(VSys<T> s) {
  if (!vc_go(s.ctrl)) return;
  int cnt = 0;
  FOR_CNST_WARPS(c) {
    T d_rem = T(0), d_use = T(0), umax = T(0);
    bool has_live = false;
    for (int base = s.vcx_ptr[c], end = s.vcx_ptr[c + 1]; base < end;
         base += 32) {
      int j = base + lane;
      T xr = T(0), xu = T(0), xl = T(0);
      bool lv = false;
      if (j < end) {
        int idx = s.vcx_idx[j];
        int v = idx / s.Wv;
        T p = s.pen[v];
        if (p > T(0)) {
          T up = div_rn(s.vc_w[idx], p);
          if (s.fix_now[v]) {
            xr = mul_rn(s.vc_w[idx], s.v_value[v]);
            xu = up;
          }
          lv = !s.v_fixed[v];
          if (lv) xl = up;
        }
      }
      d_rem = warp_fold_into(d_rem, xr);
      d_use = warp_fold_into(d_use, xu);
      if (__any_sync(FULL_MASK, lv)) has_live = true;
      if (FAT) umax = max_v(umax, warp_max(xl));
    }
    if (lane == 0) {
      bool touched = d_use > T(0);
      T ce = mul_rn(s.c_bound[c], s.eps);
      T rem = s.remaining[c], use = s.usage[c];
      if (touched) {
        T nr = sub_rn(rem, d_rem);
        if (nr < ce) nr = T(0);
        T nu = sub_rn(use, d_use);
        if (nu < s.eps) nu = T(0);
        if (FAT && s.c_fat[c]) {
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

__global__ void v_commit(int* ctrl) {
  if (!vc_go(ctrl)) return;
  ctrl[C_LIGHT] = ctrl[C_LIGHT_ACC];
  ctrl[C_LIGHT_ACC] = 0;
  ctrl[C_VLIVE] = ctrl[C_VLIVE_ACC];
  ctrl[C_VLIVE_ACC] = 0;
  ctrl[C_IT] += 1;
}

const int TB = 256;

template <typename T>
int launch(VSys<T> s, cudaStream_t st) {
  int gv = grid_for(s.V, TB), gc = grid_for((long long)s.C * 32, TB);
  v_nmin<T><<<gv, TB, 0, st>>>(s);
  c_proc<T><<<gc, TB, 0, st>>>(s);
  v_fix<T><<<gv, TB, 0, st>>>(s);
  if (s.fat)
    c_apply<T, true><<<gc, TB, 0, st>>>(s);
  else
    c_apply<T, false><<<gc, TB, 0, st>>>(s);
  v_commit<<<1, 1, 0, st>>>(s.ctrl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vc_round(int dbl, int V, int C, int Wv, int fat, void** ptrs,
                        int n_ptrs, double eps, void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) return launch(make_sys<double>(V, C, Wv, fat, eps, ptrs), st);
  return launch(make_sys<float>(V, C, Wv, fat, eps, ptrs), st);
}
