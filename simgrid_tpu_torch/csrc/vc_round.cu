// K8 vc_round: the bound-free local round on the variable-row tables.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `_vc_round_body` (:629-703), the
// round `fixpoint_ell` runs as `body_local_vc` for a local, bound-free
// system and the compaction chain runs in its stages and finisher.
//
// Tables: vc_cnst/vc_valid [V, Wv] flat, row-major (the variable rows),
// and the constraint-ordered entry layout over them (ops/lmm_ell.py
// `build_vc_index`, re-derived by K9 at every chain stage): vcx_ptr
// [C+1] and, for each constraint's valid entries in increasing flat
// position v * Wv + lane, the entry's row (vcx_row), its weight (vcx_w)
// and w / penalty (vcx_upen, 0 for a disabled row: JAX's `vc_upen_v`,
// the same division, written by `vc_prep` once a solve or chunk).
//
// The JAX round sums per constraint with scatter-adds over [V, Wv],
// which XLA:CPU applies in update order (row-major, from 0.0).  Here a
// group of G lanes walks a constraint's entries in order and the warp
// folds the entries fixed this round into each group's sums one by one
// in lane order (`group_fold2`), so every sum adds the same values in
// the same order; no f64 atomics.  The scatter-min (nmin_c) and the
// scatter-max (the FATPIPE usage) are order-free.
//
// A round is four kernels: v_nmin and v_fix over the variable rows (a
// thread a row), c_proc and c_apply over the constraints (a group of
// G lanes a constraint, 8 unless the layout's segments are shorter),
// the last three launched as programmatic dependents.  Each constraint's level rou = remaining / usage (inf when
// not light) is kept in `rou`, written by `vc_prep` and by c_apply
// where it updates remaining and usage (the same division, so the same
// bits), so the variable passes read one value per entry.  v_fix leaves
// one byte per variable in `code` (1 fixed this round, 2 live after
// it, 0 otherwise), which is all c_apply reads of a row besides its
// value.  c_proc does no walk for a constraint that is not light.  The
// last block of c_apply (a ticket, common.cuh `last_block`)
// commits the round (LIGHT, VLIVE, IT) and, inside a K16 loop built
// with `Loop(..., ends=True)`, counts the iteration and sets the WHILE
// node's condition itself (loop_cond's PRED_VC_ROUND formula and cap),
// so a round is four kernel nodes where it was six.
//
// The round also counts the variables still live after it (enabled and
// not fixed) into VLIVE, and its guard requires VLIVE > HALF: a chain
// stage (K9 arms HALF and LIMIT) runs its rounds under K16's loop and
// they stop once the live set fits the next stage.
//
// What bounds it on this card: latency, then memory.  A round reads
// the variable rows twice and the entry layout twice: at the headline's
// first stage (V 131,072 x Wv 4, 400,000 entries) about 10 MB, 3 us at
// 3.35 TB/s, below four dependent launches' latency.

#include "common.cuh"

#define N_PTRS 19

namespace {

template <typename T>
struct VSys {
  int V, C, Wv, fat;
  T eps;
  const T* pen;
  const int* vc_cnst;
  const bool* vc_valid;
  const T* c_bound;
  const bool* c_fat;
  const int* vcx_ptr;
  const int* vcx_row;
  const T* vcx_w;
  T* vcx_upen;
  T* v_value;
  bool* v_fixed;
  T* remaining;
  T* usage;
  bool* light;
  T* rou;
  T* nmin_v;
  bool* proc;
  uint8_t* code;
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
  s.vc_valid = (const bool*)p[2];
  s.c_bound = (const T*)p[3];
  s.c_fat = (const bool*)p[4];
  s.vcx_ptr = (const int*)p[5];
  s.vcx_row = (const int*)p[6];
  s.vcx_w = (const T*)p[7];
  s.vcx_upen = (T*)p[8];
  s.v_value = (T*)p[9];
  s.v_fixed = (bool*)p[10];
  s.remaining = (T*)p[11];
  s.usage = (T*)p[12];
  s.light = (bool*)p[13];
  s.rou = (T*)p[14];
  s.nmin_v = (T*)p[15];
  s.proc = (bool*)p[16];
  s.code = (uint8_t*)p[17];
  s.ctrl = (int*)p[18];
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
__device__ __forceinline__ T rou_new(bool lt, T rem, T use) {
  return lt ? div_rn(rem, use) : inf_v<T>();
}

#define FOR_VARS(v) \
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < s.V; \
       v += gridDim.x * blockDim.x)

// The warp-uniform loop over constraints, G lanes a constraint: each
// warp serves 32 / G consecutive constraints at a time; `c` is this
// lane's constraint (>= C past the end), `g` its lane in the group.
#define FOR_CNST_GROUPS(c, g)                                          \
  const int lane = threadIdx.x & 31, g = lane & (G - 1);              \
  const long long nwarps = (gridDim.x * (long long)blockDim.x) >> 5;   \
  for (long long cb = ((blockIdx.x * (long long)blockDim.x +           \
                        threadIdx.x) >> 5) * (32 / G);                 \
       cb < s.C; cb += nwarps * (32 / G))                              \
    for (int c = (int)cb + lane / G, once_ = 1; once_; once_ = 0)

template <typename T, int G>
__device__ __forceinline__ T group_max(T v) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = max_v(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// Fold the lanes with `on` set into their group's two sums, one add at a
// time in lane order (so each group adds its entries in entry order);
// called by all 32 lanes with the same loop, `gmask` the lanes of the
// caller's group.
template <typename T>
__device__ __forceinline__ void group_fold2(T* a, T* b, T xa, T xb, bool on,
                                            unsigned gmask) {
  unsigned m = __ballot_sync(FULL_MASK, on);
  while (m) {
    int l = __ffs(m) - 1;
    m &= m - 1;
    T ya = __shfl_sync(FULL_MASK, xa, l);
    T yb = __shfl_sync(FULL_MASK, xb, l);
    if ((gmask >> l) & 1u) {
      *a = add_rn(*a, ya);
      *b = add_rn(*b, yb);
    }
  }
}

// rou of every constraint from the state, w / penalty of every entry
template <typename T>
__global__ void vc_prep_k(VSys<T> s) {
  int cur = s.vcx_ptr[s.C];
  int n = cur > s.C ? cur : s.C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    if (i < s.C) s.rou[i] = rou_new(s.light[i], s.remaining[i], s.usage[i]);
    if (i < cur) {
      T p = s.pen[s.vcx_row[i]];
      s.vcx_upen[i] = p > T(0) ? div_rn(s.vcx_w[i], p) : T(0);
    }
  }
}

// nmin_v = min rou over the variable's valid entries (inf unless live)
template <typename T>
__global__ void v_nmin(VSys<T> s) {
  pdl_wait();
  pdl_trigger();
  if (!vc_go(s.ctrl)) return;
  FOR_VARS(v) {
    T m = inf_v<T>();
    if (var_live(s, v)) {
      const int* cn = s.vc_cnst + (long long)v * s.Wv;
      const bool* ok = s.vc_valid + (long long)v * s.Wv;
      for (int l = 0; l < s.Wv; ++l)
        if (ok[l]) m = min_v(m, s.rou[cn[l]]);
    }
    s.nmin_v[v] = m;
  }
}

template <typename T, int G>
__device__ __forceinline__ T group_min(T v) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = min_v(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// processable = light and rou <= the min nmin_v over the entries (a
// row that is not live holds inf); no walk for a constraint not light
template <typename T, int G>
__global__ void c_proc(VSys<T> s) {
  pdl_wait();
  pdl_trigger();
  if (!vc_go(s.ctrl)) return;
  FOR_CNST_GROUPS(c, g) {
    bool act = c < s.C && s.light[c];
    T m = inf_v<T>();
    if (act)
      for (int j = s.vcx_ptr[c] + g, end = s.vcx_ptr[c + 1]; j < end; j += G)
        m = min_v(m, s.nmin_v[s.vcx_row[j]]);
    m = group_min<T, G>(m);
    if (g == 0 && c < s.C) s.proc[c] = act && s.rou[c] <= m;
  }
}

// level2 over processable entries; fix; the code byte; count the live
// variables left
template <typename T>
__global__ void v_fix(VSys<T> s) {
  pdl_wait();
  pdl_trigger();
  if (!vc_go(s.ctrl)) return;
  int live = 0;
  FOR_VARS(v) {
    uint8_t code = 0;
    if (var_live(s, v)) {
      T m = inf_v<T>();
      const int* cn = s.vc_cnst + (long long)v * s.Wv;
      const bool* ok = s.vc_valid + (long long)v * s.Wv;
      for (int l = 0; l < s.Wv; ++l) {
        if (ok[l]) {
          int c = cn[l];
          if (s.proc[c]) m = min_v(m, s.rou[c]);
        }
      }
      if (finite_v(m)) {
        s.v_value[v] = div_rn(m, s.pen[v]);
        s.v_fixed[v] = true;
        code = 1;
      } else {
        code = 2;
        live = live + 1;
      }
    }
    s.code[v] = code;
  }
  int tot = block_sum(live);
  if (threadIdx.x == 0 && tot) atomicAdd(s.ctrl + C_VLIVE_ACC, tot);
}

// The in-order sums of the entries fixed now, the live test, the
// FATPIPE max; clamps, light-set pruning and rou; the last block
// commits the round and ends the loop body.
template <typename T, int G, bool FAT>
__global__ void c_apply(VSys<T> s, LoopEnd le) {
  pdl_wait();
  pdl_trigger();
  if (!vc_go(s.ctrl)) {
    if (le.h && blockIdx.x == 0 && threadIdx.x == 0)
      cudaGraphSetConditional(le.h, 0u);
    return;
  }
  int cnt = 0;
  FOR_CNST_GROUPS(c, g) {
    bool act = c < s.C;
    int beg = 0, end = 0;
    if (act) {
      beg = s.vcx_ptr[c];
      end = s.vcx_ptr[c + 1];
    }
    int steps = __reduce_max_sync(FULL_MASK, (unsigned)((end - beg + G - 1) / G));
    unsigned gmask = (G == 32 ? FULL_MASK : ((1u << G) - 1u))
                     << (lane & ~(G - 1));
    T d_rem = T(0), d_use = T(0), umax = T(0);
    bool has_live = false;
    for (int it = 0; it < steps; ++it) {
      int j = beg + it * G + g;
      T xr = T(0), xu = T(0);
      bool fx = false, lv = false;
      if (j < end) {
        int v = s.vcx_row[j];
        uint8_t cd = s.code[v];
        if (cd == 1) {
          fx = true;
          xr = mul_rn(s.vcx_w[j], s.v_value[v]);
          xu = s.vcx_upen[j];
        } else if (cd == 2) {
          lv = true;
          if (FAT) umax = max_v(umax, s.vcx_upen[j]);
        }
      }
      group_fold2(&d_rem, &d_use, xr, xu, fx, gmask);
      if (__ballot_sync(FULL_MASK, lv) & gmask) has_live = true;
    }
    if (FAT) umax = group_max<T, G>(umax);
    if (g == 0 && act) {
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
      s.rou[c] = rou_new(lt, rem, use);
      cnt += lt;
    }
  }
  int bt = block_sum(cnt);
  unsigned tot;
  bool last = last_block(ticket_of(s.ctrl), (unsigned)bt, &tot);
  if (last && threadIdx.x == 0) {
    int* ctrl = s.ctrl;
    ctrl[C_LIGHT] = (int)tot;
    ctrl[C_VLIVE] = atomicExch(ctrl + C_VLIVE_ACC, 0);
    ctrl[C_IT] += 1;
    if (le.h) end_iteration(le, vc_go(ctrl));
  }
}

const int TB = 256;

template <typename T, int G, bool FAT>
cudaError_t launch_c(VSys<T> s, LoopEnd le, cudaStream_t st) {
  int gv = grid_for(s.V, TB), gc = grid_for((long long)s.C * G, TB);
  v_nmin<T><<<gv, TB, 0, st>>>(s);
  cudaError_t e = launch_dependent(c_proc<T, G>, dim3(gc), TB, st, s);
  if (e == cudaSuccess) e = launch_dependent(v_fix<T>, dim3(gv), TB, st, s);
  if (e == cudaSuccess)
    e = launch_dependent(c_apply<T, G, FAT>, dim3(gc), TB, st, s, le);
  return e;
}

template <typename T, bool FAT>
cudaError_t launch_g(VSys<T> s, int G, LoopEnd le, cudaStream_t st) {
  switch (G) {
    case 4: return launch_c<T, 4, FAT>(s, le, st);
    case 8: return launch_c<T, 8, FAT>(s, le, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(VSys<T> s, int G, LoopEnd le, cudaStream_t st) {
  cudaError_t e = s.fat ? launch_g<T, true>(s, G, le, st)
                        : launch_g<T, false>(s, G, le, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int prep(VSys<T> s, int nnz, cudaStream_t st) {
  int g = grid_for(nnz > s.C ? nnz : s.C, TB);
  vc_prep_k<T><<<g, TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One round; `G` the lanes a constraint (4 or 8); cnt, tally,
// cap and handle: the K16 loop whose body this round ends (handle 0:
// none).
int vc_round(int dbl, int V, int C, int Wv, int G, int fat, void** ptrs,
             int n_ptrs, double eps, void* cnt, void* tally, int cap,
             unsigned long long handle, void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LoopEnd le{(int*)cnt, (int*)tally, cap,
             (cudaGraphConditionalHandle)handle};
  if (dbl)
    return launch(make_sys<double>(V, C, Wv, fat, eps, ptrs), G, le, st);
  return launch(make_sys<float>(V, C, Wv, fat, eps, ptrs), G, le, st);
}

// rou from the state and w / penalty of the entries (`nnz` the layout's
// capacity; the live count is vcx_ptr[C])
int vc_prep(int dbl, int V, int C, int nnz, void** ptrs, int n_ptrs,
            void* stream) {
  if (n_ptrs != N_PTRS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) return prep(make_sys<double>(V, C, 1, 0, 0.0, ptrs), nnz, st);
  return prep(make_sys<float>(V, C, 1, 0, 0.0, ptrs), nnz, st);
}

}  // extern "C"
