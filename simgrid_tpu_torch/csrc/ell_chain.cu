// K9 ell_chain: the device half of the ELL compaction chain.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `_ell_chain_stage` (:733-784)
// apart from its rounds (K8's), with `_stable_livefirst_perm`
// (:716-731), and `_chain_fetch` (:803-815).
//
// * chain_arm: the guard of the chain's first K8 loop and the start of
//   its fixpoint from the carried init: round 0, the light count,
//   overflow cleared, VLIVE = the live variable rows (enabled and not
//   fixed), LIMIT = the loop's cap (MAX_ROUNDS for the finisher), HALF
//   = the rows the stage keeps (-1 for the finisher).  One launch; its
//   last block (a ticket) writes the words.
// * chain_stage, two launches:
//   - cs_rows, over tiles of rows: v_final[orig[i]] = v_value[i]; each
//     row's place in the stable live-first partition (live rows first,
//     each side in its order) from a single-pass scan of the live flags
//     with decoupled look-back (tiles numbered in the order they start,
//     so a tile only waits on tiles already running); the live rows
//     among the first `half` gathered into the next stage's tables
//     (vc_cnst, vc_w, vc_valid, penalty, original slot) and carried
//     vectors (value, fixed).  The tile that ends the scan knows the
//     live count: it raises OVERFLOW (more than `half` rows live while
//     constraints are light) and arms the next K8 loop (VLIVE = the
//     kept rows' live count, min(n_live, half); LIMIT; HALF).
//   - cs_entries (a programmatic dependent): the dead rows the partition
//     keeps (they follow the live ones); then K8's entry layout
//     re-derived over the kept rows by the same single-pass compaction
//     over the index entries: an entry survives when its row is live and
//     kept, and since live rows keep their order, the survivors list
//     every constraint's entries in increasing new position; each
//     carries its new row, position, weight and w / penalty (the
//     penalty moves with the row, so the quotient is unchanged), and
//     each tile writes the new row pointers that fall in it (the
//     compaction's exclusive scan at the old pointers).
//   Dead and dropped rows only ever contributed identities.  Every scan
//   is an integer count (exact in any order); the tiles' status words
//   and start counters are zeroed by the pass before their next use.
// * chain_fetch: v_final[orig[i]] = v_value[i] and the one transfer of
//   a finisher chunk: [rounds, light, fixed, overflow, v_final (V0),
//   remaining (C), usage (C)] in the solve dtype.
//
// What bounds it on this card: memory and the scan's latency.  A stage
// reads and writes the variable rows once (16-40 B a row with Wv 4) and
// the entry layout once (24 B an entry): at the headline's first stage
// (131,072 rows, 400,000 entries) about 16 MB, 4.8 us at 3.35 TB/s; it
// runs four times a solve.

#include "common.cuh"
#include "scan.cuh"

#define N_STAGE_PTRS 29
#define ST_TB 256
#define ROW_IPT 1
#define ROW_TILE (ST_TB * ROW_IPT)
#define ENT_IPT 2
#define ENT_TILE (ST_TB * ENT_IPT)

namespace {

template <typename T>
__global__ void __launch_bounds__(ST_TB)
    ca_arm(int V, int C, int first, int cap, int half,
           const T* __restrict__ pen, const bool* __restrict__ v_fixed,
           const bool* __restrict__ light, int* ctrl) {
  int live = 0, lt = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < V || i < C;
       i += gridDim.x * blockDim.x) {
    if (i < V) live += pen[i] > T(0) && !v_fixed[i];
    if (first && i < C) lt += light[i];
  }
  int tl = block_sum(live);
  int tt = block_sum(lt);
  if (threadIdx.x == 0 && tl) atomicAdd(ctrl + C_VLIVE_ACC, tl);
  unsigned tot;
  bool last = last_block(ticket_of(ctrl), (unsigned)tt, &tot);
  if (last && threadIdx.x == 0) {
    if (first) {
      ctrl[C_IT] = 0;
      ctrl[C_ARMED] = 1;
      ctrl[C_OVERFLOW] = 0;
      ctrl[C_LIGHT] = (int)tot;
      ctrl[C_LIGHT_ACC] = 0;
    }
    ctrl[C_VLIVE] = atomicExch(ctrl + C_VLIVE_ACC, 0);
    ctrl[C_LIMIT] = cap < 0 ? MAX_ROUNDS : ctrl[C_IT] + cap;
    ctrl[C_HALF] = half;
  }
}

template <typename T>
struct Stage {
  int V, Wv, C, half, nnz;
  int arm, cap, next_half;
  int tiles_v, tiles_e;
  const int* vc_cnst;
  const T* vc_w;
  const bool* vc_valid;
  const T* pen;
  const int* orig;
  const T* v_value;
  const bool* v_fixed;
  const int* vptr;
  const int* vidx;
  const int* vrow;
  const T* vw;
  const T* vupen;
  int* vc_cnst2;
  T* vc_w2;
  bool* vc_valid2;
  T* pen2;
  int* orig2;
  T* v_value2;
  bool* v_fixed2;
  int* vptr2;
  int* vidx2;
  int* vrow2;
  T* vw2;
  T* vupen2;
  T* v_final;
  int* ctrl;
  int* rpos;
  unsigned long long* st_v;  // tiles_v status words, then the start counter
  unsigned long long* st_e;  // tiles_e status words, then the start counter
  int* totals;
};

template <typename T>
Stage<T> make_stage(int V, int Wv, int C, int half, int nnz, int arm,
                    int cap, int next_half, int tiles_v, void** p) {
  Stage<T> s;
  s.V = V;
  s.Wv = Wv;
  s.C = C;
  s.half = half;
  s.nnz = nnz;
  s.arm = arm;
  s.cap = cap;
  s.next_half = next_half;
  s.tiles_v = (V + ROW_TILE - 1) / ROW_TILE;
  s.tiles_e = (nnz + ENT_TILE - 1) / ENT_TILE;
  if (s.tiles_e < 1) s.tiles_e = 1;
  s.vc_cnst = (const int*)p[0];
  s.vc_w = (const T*)p[1];
  s.vc_valid = (const bool*)p[2];
  s.pen = (const T*)p[3];
  s.orig = (const int*)p[4];
  s.v_value = (const T*)p[5];
  s.v_fixed = (const bool*)p[6];
  s.vptr = (const int*)p[7];
  s.vidx = (const int*)p[8];
  s.vrow = (const int*)p[9];
  s.vw = (const T*)p[10];
  s.vupen = (const T*)p[11];
  s.vc_cnst2 = (int*)p[12];
  s.vc_w2 = (T*)p[13];
  s.vc_valid2 = (bool*)p[14];
  s.pen2 = (T*)p[15];
  s.orig2 = (int*)p[16];
  s.v_value2 = (T*)p[17];
  s.v_fixed2 = (bool*)p[18];
  s.vptr2 = (int*)p[19];
  s.vidx2 = (int*)p[20];
  s.vrow2 = (int*)p[21];
  s.vw2 = (T*)p[22];
  s.vupen2 = (T*)p[23];
  s.v_final = (T*)p[24];
  s.ctrl = (int*)p[25];
  s.rpos = (int*)p[26];
  // the status words are sized for the chain's first stage (tiles_v0)
  s.st_v = (unsigned long long*)p[27];
  s.st_e = s.st_v + tiles_v + 1;
  s.totals = (int*)p[28];
  return s;
}

// The first index of the sorted a[0, n) whose value is >= x, by one
// warp: 32 probes a step (every lane returns it).
__device__ int warp_lower_bound(const int* a, int n, int x, int lane) {
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    int step = (hi - lo + 31) / 32;
    int probe = lo + lane * step;
    bool less = probe < hi && a[probe] < x;
    int k = __popc(__ballot_sync(FULL_MASK, less));  // a prefix of lanes
    if (k == 0) return lo;
    int nhi = lo + k * step;
    lo = lo + (k - 1) * step + 1;
    hi = nhi < hi ? nhi : hi;
  }
  int probe = lo + lane;
  bool less = probe < hi && a[probe] < x;
  return lo + __popc(__ballot_sync(FULL_MASK, less));
}

template <typename T>
__device__ __forceinline__ void gather_row(const Stage<T>& s, int i, int p) {
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

// v_final; each row's place (rpos: the live rank of a live row, or
// -1 - the dead rank of a dead one); the kept live rows' gather; the
// live count, the overflow flag and the next loop's words
template <typename T>
__global__ void __launch_bounds__(ST_TB) cs_rows(Stage<T> s) {
  pdl_trigger();
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= s.tiles_e;
       k += gridDim.x * blockDim.x)
    s.st_e[k] = 0ULL;
  int tile = start_order(s.st_v + s.tiles_v);
  int lo = tile * ROW_TILE + threadIdx.x;
  bool f[ROW_IPT];
  for (int k = 0; k < ROW_IPT; ++k) {
    int i = lo + k * ST_TB;
    f[k] = false;
    if (i < s.V) {
      s.v_final[s.orig[i]] = s.v_value[i];
      f[k] = !s.v_fixed[i] && s.pen[i] > T(0);
    }
  }
  int ex[ROW_IPT], agg;
  tile_ranks<ROW_IPT>(f, ex, &agg);
  __shared__ int base;
  if (threadIdx.x < 32) {
    int b = look_back(s.st_v, tile, agg, threadIdx.x);
    if (threadIdx.x == 0) base = b;
    if (threadIdx.x == 0 && tile == s.tiles_v - 1) {
      int n_live = base + agg;
      s.totals[0] = n_live;
      int* ctrl = s.ctrl;
      if (n_live > s.half && ctrl[C_LIGHT] > 0) ctrl[C_OVERFLOW] = 1;
      if (s.arm) {
        ctrl[C_VLIVE] = n_live < s.half ? n_live : s.half;
        ctrl[C_LIMIT] = s.cap < 0 ? MAX_ROUNDS : ctrl[C_IT] + s.cap;
        ctrl[C_HALF] = s.next_half;
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < ROW_IPT; ++k) {
    int i = lo + k * ST_TB;
    if (i >= s.V) break;
    int r = base + ex[k];  // live rows before i
    if (f[k]) {
      s.rpos[i] = r;
      if (r < s.half) gather_row(s, i, r);
    } else {
      s.rpos[i] = -1 - (i - r);
    }
  }
}

// the kept dead rows; the surviving entries' compaction, their new
// layout and the new row pointers
template <typename T>
__global__ void __launch_bounds__(ST_TB) cs_entries(Stage<T> s) {
  pdl_wait();
  int n_live = s.totals[0];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < s.V;
       i += gridDim.x * blockDim.x) {
    int r = s.rpos[i];
    if (r < 0) {
      int p = n_live + (-1 - r);
      if (p < s.half) gather_row(s, i, p);
    }
  }
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k <= s.tiles_v;
       k += gridDim.x * blockDim.x)
    s.st_v[k] = 0ULL;
  int tile = start_order(s.st_e + s.tiles_e);
  int cur = s.vptr[s.C];
  int lo0 = tile * ENT_TILE;
  if (lo0 >= cur) {
    if (tile == 0)   // no entry at all
      for (int c = threadIdx.x; c <= s.C; c += blockDim.x) s.vptr2[c] = 0;
    return;
  }
  __shared__ int sx[ENT_TILE];
  __shared__ int base, c_lo, c_hi;
  int lo = lo0 + threadIdx.x;
  bool f[ENT_IPT];
  int row[ENT_IPT], rp[ENT_IPT];
  for (int k = 0; k < ENT_IPT; ++k) {
    int j = lo + k * ST_TB;
    f[k] = false;
    if (j < cur) {
      row[k] = s.vrow[j];
      rp[k] = s.rpos[row[k]];
      f[k] = rp[k] >= 0 && rp[k] < s.half;
    }
  }
  int ex[ENT_IPT], agg;
  tile_ranks<ENT_IPT>(f, ex, &agg);
  int hi = lo0 + ENT_TILE < cur ? lo0 + ENT_TILE : cur;
  bool last = lo0 + ENT_TILE >= cur;
  int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (wid == 0) {
    int b = look_back(s.st_e, tile, agg, lane);
    if (lane == 0) base = b;
  } else if (wid == 1) {
    int l = warp_lower_bound(s.vptr, s.C + 1, lo0, lane);
    if (lane == 0) c_lo = l;
  } else if (wid == 2) {
    int h = last ? s.C + 1 : warp_lower_bound(s.vptr, s.C + 1, hi, lane);
    if (lane == 0) c_hi = h;
  }
  __syncthreads();
  for (int k = 0; k < ENT_IPT; ++k) {
    int j = lo + k * ST_TB;
    if (j >= cur) break;
    int off = base + ex[k];
    sx[j - lo0] = off;
    if (f[k]) {
      int r = rp[k];
      s.vrow2[off] = r;
      s.vidx2[off] = r * s.Wv + (s.vidx[j] - row[k] * s.Wv);
      s.vw2[off] = s.vw[j];
      s.vupen2[off] = s.vupen[j];
    }
  }
  __syncthreads();
  int total = base + agg;
  for (int c = c_lo + threadIdx.x; c < c_hi; c += blockDim.x) {
    int o = s.vptr[c];
    s.vptr2[c] = o < cur ? sx[o - lo0] : total;
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
  int g = grid_for(V > C ? V : C, TB);
  ca_arm<T><<<g, TB, 0, st>>>(V, C, first, cap, half, (const T*)pen,
                               v_fixed, light, ctrl);
  return (int)cudaGetLastError();
}

template <typename T>
int stage(Stage<T> s, cudaStream_t st) {
  cs_rows<T><<<s.tiles_v, ST_TB, 0, st>>>(s);
  cudaError_t e = launch_dependent(cs_entries<T>, dim3(s.tiles_e), ST_TB,
                                   st, s);
  if (e != cudaSuccess) return (int)e;
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

// One stage from V rows to `half`; `nnz` the entry layout's capacity,
// `tiles_v` the row tiles the status buffer was sized for (the first
// stage's); with `arm` set, the next K8 loop is armed with `cap` and
// `next_half` (as chain_arm would).
int chain_stage(int dbl, int V, int Wv, int C, int half, int nnz, int arm,
                int cap, int next_half, int tiles_v, void** ptrs,
                int n_ptrs, void* stream) {
  if (n_ptrs != N_STAGE_PTRS || half < 1 || half > V ||
      (V + ROW_TILE - 1) / ROW_TILE > tiles_v)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return stage(make_stage<double>(V, Wv, C, half, nnz, arm, cap,
                                    next_half, tiles_v, ptrs), st);
  return stage(make_stage<float>(V, Wv, C, half, nnz, arm, cap, next_half,
                                 tiles_v, ptrs), st);
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
