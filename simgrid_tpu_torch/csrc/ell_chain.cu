// K9 ell_chain: the device half of the ELL compaction chain.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `_ell_chain_stage` (:733-784)
// apart from its rounds (K8's), with `_stable_livefirst_perm`
// (:716-731), and `_chain_fetch` (:803-815).
//
// * chain_arm: the guard of a stage's K8 rounds (K16's loop): VLIVE =
//   the live variable rows now (enabled and not fixed), LIMIT = rounds
//   so far + the stage's cap (MAX_ROUNDS for the finisher), HALF = the
//   rows the stage keeps (-1 for the finisher); the first arm also
//   starts the fixpoint from the carried init (round 0, the light
//   count, overflow cleared).
// * chain_stage: v_final[orig[i]] = v_value[i]; the stable live-first
//   partition of the rows (the scan of scan.cuh, the one K4 runs);
//   overflow when more than HALF rows stay live while constraints are
//   light; the first `half` rows of the partition gathered into fresh
//   tables (vc_cnst, vc_w, vc_valid, penalty, original slot) and carried
//   vectors (value, fixed); K8's constraint index re-derived over them:
//   an entry survives when its row is live and kept, a stable
//   compaction of the entry list keeps each constraint's entries in
//   increasing new position (live rows keep their order), and the new
//   row pointers are the compaction's exclusive scan at the old ones.
//   Dead and dropped rows only ever contributed identities.
// * chain_fetch: v_final[orig[i]] = v_value[i] and the one transfer of
//   a finisher chunk: [rounds, light, fixed, overflow, v_final (V0),
//   remaining (C), usage (C)] in the solve dtype.
//
// What bounds it on this card: memory.  A stage reads and writes the
// variable rows once (16-40 B a row with Wv 4) and the index twice: at
// the headline's first stage (131,072 rows, 400,000 entries) about
// 8 MB, 2.4 us at 3.35 TB/s; it runs four times a solve.
//
// What the design does about it: no atomics in any position (the
// scans), one thread per row or entry, the gathers are scatters to the
// computed positions.

#include "common.cuh"
#include "scan.cuh"

#define N_STAGE_PTRS 21

namespace {

template <typename T>
__global__ void ca_zero(int* ctrl, int first) {
  ctrl[C_VLIVE_ACC] = 0;
  if (first) {
    ctrl[C_IT] = 0;
    ctrl[C_ARMED] = 1;
    ctrl[C_OVERFLOW] = 0;
    ctrl[C_LIGHT] = 0;
    ctrl[C_LIGHT_ACC] = 0;
  }
}

template <typename T>
__global__ void ca_count(int V, int C, int first, const T* __restrict__ pen,
                         const bool* __restrict__ v_fixed,
                         const bool* __restrict__ light, int* ctrl) {
  int live = 0, lt = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V || i < C;
       i += gridDim.x * blockDim.x) {
    if (i < V) live += pen[i] > T(0) && !v_fixed[i];
    if (first && i < C) lt += light[i];
  }
  int tl = block_sum(live);
  int tt = block_sum(lt);
  if (threadIdx.x == 0) {
    if (tl) atomicAdd(ctrl + C_VLIVE_ACC, tl);
    if (tt) atomicAdd(ctrl + C_LIGHT, tt);
  }
}

__global__ void ca_set(int* ctrl, int cap, int half) {
  ctrl[C_VLIVE] = ctrl[C_VLIVE_ACC];
  ctrl[C_VLIVE_ACC] = 0;
  ctrl[C_LIMIT] = cap < 0 ? MAX_ROUNDS : ctrl[C_IT] + cap;
  ctrl[C_HALF] = half;
}

template <typename T>
struct Stage {
  int V, Wv, C, half, nnz;
  const int* vc_cnst;
  const T* vc_w;
  const bool* vc_valid;
  const T* pen;
  const int* orig;
  const T* v_value;
  const bool* v_fixed;
  const int* vptr;
  const int* vidx;
  int* vc_cnst2;
  T* vc_w2;
  bool* vc_valid2;
  T* pen2;
  int* orig2;
  T* v_value2;
  bool* v_fixed2;
  int* vptr2;
  int* vidx2;
  T* v_final;
  int* ctrl;
  uint8_t* fv;
  uint8_t* fe;
  int* ex_v;
  int* pos_v;
  int* ex_e;
  int* bsum;
  int* totals;
};

template <typename T>
Stage<T> make_stage(int V, int Wv, int C, int half, int nnz, void** p) {
  Stage<T> s;
  s.V = V;
  s.Wv = Wv;
  s.C = C;
  s.half = half;
  s.nnz = nnz;
  s.vc_cnst = (const int*)p[0];
  s.vc_w = (const T*)p[1];
  s.vc_valid = (const bool*)p[2];
  s.pen = (const T*)p[3];
  s.orig = (const int*)p[4];
  s.v_value = (const T*)p[5];
  s.v_fixed = (const bool*)p[6];
  s.vptr = (const int*)p[7];
  s.vidx = (const int*)p[8];
  s.vc_cnst2 = (int*)p[9];
  s.vc_w2 = (T*)p[10];
  s.vc_valid2 = (bool*)p[11];
  s.pen2 = (T*)p[12];
  s.orig2 = (int*)p[13];
  s.v_value2 = (T*)p[14];
  s.v_fixed2 = (bool*)p[15];
  s.vptr2 = (int*)p[16];
  s.vidx2 = (int*)p[17];
  s.v_final = (T*)p[18];
  s.ctrl = (int*)p[19];
  uint8_t* scratch = (uint8_t*)p[20];
  long long flags = ((long long)V + nnz + 15) & ~15LL;
  s.fv = scratch;
  s.fe = scratch + V;
  int* ints = (int*)(scratch + flags);
  s.ex_v = ints;
  s.pos_v = ints + V;
  s.ex_e = ints + 2LL * V;
  s.totals = ints + 2LL * V + nnz;
  s.bsum = s.totals + 4;
  return s;
}

// v_final at original numbering; live flags of the rows
template <typename T>
__global__ void cs_final(Stage<T> s) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < s.V;
       i += gridDim.x * blockDim.x) {
    s.v_final[s.orig[i]] = s.v_value[i];
    s.fv[i] = !s.v_fixed[i] && s.pen[i] > T(0);
  }
}

__global__ void cs_over(int* ctrl, const int* totals, int half) {
  if (totals[0] > half && ctrl[C_LIGHT] > 0) ctrl[C_OVERFLOW] = 1;
}

// position of every row in the partition; the kept rows' gather
template <typename T>
__global__ void cs_rows(Stage<T> s) {
  int n_live = s.totals[0];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < s.V;
       i += gridDim.x * blockDim.x) {
    int ex = s.ex_v[i];
    int p = s.fv[i] ? ex : n_live + (i - ex);
    s.pos_v[i] = p;
    if (p < s.half) {
      for (int l = 0; l < s.Wv; ++l) {
        long long a = (long long)i * s.Wv + l, b = (long long)p * s.Wv + l;
        s.vc_cnst2[b] = s.vc_cnst[a];
        s.vc_w2[b] = s.vc_w[a];
        s.vc_valid2[b] = s.vc_valid[a];
      }
      s.pen2[p] = s.pen[i];
      s.orig2[p] = s.orig[i];
      s.v_value2[p] = s.v_value[i];
      s.v_fixed2[p] = s.v_fixed[i];
    }
  }
}

// index entries that survive: live and kept rows
template <typename T>
__global__ void cs_eflags(Stage<T> s) {
  int cur = s.vptr[s.C];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < s.nnz;
       j += gridDim.x * blockDim.x) {
    bool keep = false;
    if (j < cur) {
      int row = s.vidx[j] / s.Wv;
      keep = s.fv[row] && s.pos_v[row] < s.half;
    }
    s.fe[j] = keep;
  }
}

template <typename T>
__global__ void cs_eapply(Stage<T> s) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < s.nnz;
       j += gridDim.x * blockDim.x) {
    if (s.fe[j]) {
      int idx = s.vidx[j];
      int row = idx / s.Wv;
      s.vidx2[s.ex_e[j]] = s.pos_v[row] * s.Wv + (idx - row * s.Wv);
    }
  }
}

template <typename T>
__global__ void cs_ptr(Stage<T> s) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c <= s.C;
       c += gridDim.x * blockDim.x) {
    int o = s.vptr[c];
    s.vptr2[c] = o < s.nnz ? s.ex_e[o] : s.totals[1];
  }
}

template <typename T>
__global__ void cf_rows(int V, const int* __restrict__ orig,
                        const T* __restrict__ v_value,
                        const bool* __restrict__ v_fixed, T* v_final,
                        int* ctrl) {
  int nf = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V;
       i += gridDim.x * blockDim.x) {
    v_final[orig[i]] = v_value[i];
    nf += v_fixed[i];
  }
  int t = block_sum(nf);
  if (threadIdx.x == 0 && t) atomicAdd(ctrl + C_NFIXED_ACC, t);
}

template <typename T>
__global__ void cf_copy(int V0, int C, const T* __restrict__ v_final,
                        const T* __restrict__ remaining,
                        const T* __restrict__ usage, int* ctrl, T* out) {
  int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 == 0) {
    out[0] = (T)ctrl[C_IT];
    out[1] = (T)ctrl[C_LIGHT];
    out[2] = (T)ctrl[C_NFIXED_ACC];
    out[3] = (T)ctrl[C_OVERFLOW];
    ctrl[C_NFIXED_ACC] = 0;
  }
  for (int k = i0; k < V0 + 2 * C; k += gridDim.x * blockDim.x) {
    T x;
    if (k < V0)
      x = v_final[k];
    else if (k < V0 + C)
      x = remaining[k - V0];
    else
      x = usage[k - V0 - C];
    out[4 + k] = x;
  }
}

const int TB = 256;

template <typename T>
int arm(int V, int C, int cap, int half, int first, const void* pen,
        const bool* v_fixed, const bool* light, int* ctrl, cudaStream_t st) {
  ca_zero<T><<<1, 1, 0, st>>>(ctrl, first);
  int g = grid_for(V > C ? V : C, TB);
  ca_count<T><<<g, TB, 0, st>>>(
      V, C, first, (const T*)pen, v_fixed, light, ctrl);
  ca_set<<<1, 1, 0, st>>>(ctrl, cap, half);
  return (int)cudaGetLastError();
}

template <typename T>
int stage(Stage<T> s, cudaStream_t st) {
  cs_final<T><<<grid_for(s.V, TB), TB, 0, st>>>(s);
  scan(s.V, s.fv, s.ex_v, s.bsum, s.totals + 0, st);
  cs_over<<<1, 1, 0, st>>>(s.ctrl, s.totals, s.half);
  cs_rows<T><<<grid_for(s.V, TB), TB, 0, st>>>(s);
  cs_eflags<T><<<grid_for(s.nnz, TB), TB, 0, st>>>(s);
  scan(s.nnz, s.fe, s.ex_e, s.bsum, s.totals + 1, st);
  cs_eapply<T><<<grid_for(s.nnz, TB), TB, 0, st>>>(s);
  cs_ptr<T><<<grid_for(s.C + 1, TB), TB, 0, st>>>(s);
  return (int)cudaGetLastError();
}

template <typename T>
int fetch(int V, int V0, int C, const int* orig, const T* v_value,
          const bool* v_fixed, const T* remaining, const T* usage,
          T* v_final, int* ctrl, T* out, cudaStream_t st) {
  cf_rows<T><<<grid_for(V, TB), TB, 0, st>>>(V, orig, v_value, v_fixed,
                                             v_final, ctrl);
  cf_copy<T><<<grid_for(V0 + 2LL * C, TB), TB, 0, st>>>(
      V0, C, v_final, remaining, usage, ctrl, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int chain_arm(int dbl, int V, int C, int cap, int half, int first,
              void* pen, void* v_fixed, void* light, void* ctrl,
              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return arm<double>(V, C, cap, half, first, pen, (const bool*)v_fixed,
                       (const bool*)light, (int*)ctrl, st);
  return arm<float>(V, C, cap, half, first, pen, (const bool*)v_fixed,
                    (const bool*)light, (int*)ctrl, st);
}

int chain_stage(int dbl, int V, int Wv, int C, int half, int nnz,
                void** ptrs, int n_ptrs, void* stream) {
  if (n_ptrs != N_STAGE_PTRS || half < 1 || half > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl) return stage(make_stage<double>(V, Wv, C, half, nnz, ptrs), st);
  return stage(make_stage<float>(V, Wv, C, half, nnz, ptrs), st);
}

int chain_fetch(int dbl, int V, int V0, int C, void* orig, void* v_value,
                void* v_fixed, void* light, void* remaining, void* usage,
                void* v_final, void* ctrl, void* out, void* stream) {
  (void)light;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return fetch<double>(V, V0, C, (const int*)orig, (const double*)v_value,
                         (const bool*)v_fixed, (const double*)remaining,
                         (const double*)usage, (double*)v_final, (int*)ctrl,
                         (double*)out, st);
  return fetch<float>(V, V0, C, (const int*)orig, (const float*)v_value,
                      (const bool*)v_fixed, (const float*)remaining,
                      (const float*)usage, (float*)v_final, (int*)ctrl,
                      (float*)out, st);
}

}  // extern "C"
