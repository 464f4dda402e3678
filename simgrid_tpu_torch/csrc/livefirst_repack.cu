// K4 livefirst_repack: on-device repack of the drain to halved shapes.
//
// Replaces: simgrid_tpu/ops/lmm_jax.py `_stable_livefirst_perm`
// (:716-731) and simgrid_tpu/ops/lmm_drain.py `_drain_repack`
// (:606-644) with `_repack_vbound` (:647-651): when the drain has rate
// bounds, the bound rows follow the flow rows' permutation (a NULL `vb`
// skips them).
//
// A stable live-first partition of the flow rows (live = pen > 0) and
// of the element rows (live = w > 0 and the flow is live), then a
// gather into the halved shapes: ev2 = old2new[ev] clamped to vh-1,
// weights of dead elements zeroed.  Stability keeps the live rows in
// their order, so every in-order sum over the survivors is unchanged.
// The kernel then RE-DERIVES both row indexes on the device: a row
// index entry survives when its element is live, and since the live
// elements keep their relative order, a stable compaction of the old
// entry list, mapped through the element permutation, is the new index
// with every row still in increasing element order.  Row pointers are
// the compaction's exclusive scan read at the old row starts.
//
// What bounds it on this card: latency, then memory.  It reads the
// element arrays and the flow arrays once and writes the halves (at
// main path 1's first repack, 1.24M elements, about 34 MB: 10 us at
// 3.35 TB/s), once per halving of the live set; each pass is a few
// dependent steps of memory latency (a tile's flags, its look-back, its
// gather), so the chain of passes costs more than the bytes.
//
// What the design does about it: three launches, each one pass over
// its rows, each after the first a programmatic dependent of the one
// before (it waits for it in `pdl_wait`); every partition is a
// single-pass stable compaction with decoupled look-back (scan.cuh
// `compact_tile`, K9's), the flags computed in registers and never
// stored, and two independent partitions share a grid:
// * rp_rank, tiles of flow rows and tiles of element rows: rank the
//   live flows (pen > 0) and the live elements (w > 0 and the flow's
//   pen > 0), gather the live ones below the halves, and leave each
//   row's place in `rpos` / `epos` (the live rank, or -1 - the dead
//   rank); the tile that ends a scan writes its live count;
// * rp_index: gather the kept dead rows (they follow the live ones),
//   write every kept element's ev2 (the flow's place clamped to vh-1);
//   compact both row indexes, the first half of the blocks over c_idx
//   and the second over v_idx, each with its own tile counter and
//   look-back chain (an entry survives when epos[idx[j]] >= 0 and
//   becomes that place), each leaving its exclusive scan;
// * rp_ptrs: both pointer arrays from the scans at the old row starts.
// Every count is an integer (exact in any order).  The tiles' status
// words and start counters lie in a buffer the wrapper keeps zeroed
// between calls: each pass zeroes the words of the pass before it
// (rp_index rp_rank's, rp_ptrs rp_index's), so a call needs no memset
// and the wrapper allocates no scratch per call.

#include "common.cuh"
#include "scan.cuh"

#define N_PTRS 24
// rows a tile ranks (the wrapper sizes the scratch by it)
#define RP_TILE 1024

namespace {

constexpr int RP_TB = 256;
constexpr int RP_IPT = RP_TILE / RP_TB;

template <typename T>
struct Rp {
  int V, E, C, nnz, vh, eh, cap;
  int tiles_v, tiles_e, tiles_n;
  const int* e_var;
  const int* e_cnst;
  const T* e_w;
  const T* pen;
  const T* rem;
  const T* thresh;
  const int* ids;
  const T* vb;  // NULL: no bounds to carry
  const int* c_ptr;
  const int* c_idx;
  const int* v_ptr;
  const int* v_idx;
  int* ev2;
  int* ec2;
  T* ew2;
  T* pen2;
  T* rem2;
  T* thresh2;
  int* ids2;
  T* vb2;
  int* c_ptr2;
  int* c_idx2;
  int* v_ptr2;
  int* v_idx2;
  // status words, each chain's tiles then its start counter
  unsigned long long* st_v;
  unsigned long long* st_e;
  unsigned long long* st_c;
  unsigned long long* st_x;
  int* rpos;    // [V] live rank, or -1 - dead rank
  int* epos;    // [E] the same for the elements
  int* ex_c;    // [nnz] exclusive scan of the surviving c_idx entries
  int* ex_x;    // [nnz] the same for v_idx
  int* totals;  // live flows, live elements, c_idx and v_idx survivors
};

__host__ __device__ __forceinline__ int tiles_of(int n) {
  int t = (n + RP_TILE - 1) / RP_TILE;
  return t < 1 ? 1 : t;
}

#define FOR_GRID(i, n) \
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < (n); \
       i += gridDim.x * blockDim.x)

// zero a chain's status words and its start counter
__device__ __forceinline__ void zero_chain(unsigned long long* st,
                                           int tiles) {
  FOR_GRID(k, tiles + 1) st[k] = 0ULL;
}

// a place from its code (rpos/epos) and the live count
__device__ __forceinline__ int place(int r, int n_live) {
  return r >= 0 ? r : n_live + (-1 - r);
}

template <typename T>
__device__ __forceinline__ void put_flow(const Rp<T>& s, int v, int p) {
  s.pen2[p] = s.pen[v];
  s.rem2[p] = s.rem[v];
  s.thresh2[p] = s.thresh[v];
  s.ids2[p] = s.ids[v];
  if (s.vb) s.vb2[p] = s.vb[v];
}

template <typename T>
__global__ void __launch_bounds__(RP_TB) rp_rank(Rp<T> s) {
  bool flows = blockIdx.x < s.tiles_v;
  bool f[RP_IPT];
  int ex[RP_IPT], base, agg, tile;
  if (flows) {
    const T* pen = s.pen;
    tile = compact_tile<RP_IPT>(
        s.st_v, s.tiles_v, s.V, [pen](int i) { return pen[i] > T(0); }, f,
        ex, &base, &agg);
    if (threadIdx.x == 0 && tile == s.tiles_v - 1) s.totals[0] = base + agg;
  } else {
    const int* ev = s.e_var;
    const T* ew = s.e_w;
    const T* pen = s.pen;
    tile = compact_tile<RP_IPT>(
        s.st_e, s.tiles_e, s.E,
        [ev, ew, pen](int e) { return ew[e] > T(0) && pen[ev[e]] > T(0); },
        f, ex, &base, &agg);
    if (threadIdx.x == 0 && tile == s.tiles_e - 1) s.totals[1] = base + agg;
  }
  int n = flows ? s.V : s.E;
  int* pos = flows ? s.rpos : s.epos;
  int lo = tile * RP_TILE + threadIdx.x;
  for (int k = 0; k < RP_IPT; ++k) {
    int i = lo + k * RP_TB;
    if (i >= n) break;
    int r = base + ex[k];  // live rows before i
    if (!f[k]) {
      pos[i] = -1 - (i - r);
    } else if (flows) {
      pos[i] = r;
      if (r < s.vh) put_flow(s, i, r);
    } else {
      pos[i] = r;
      if (r < s.eh) {
        s.ec2[r] = s.e_cnst[i];
        s.ew2[r] = s.e_w[i];
      }
    }
  }
}

// The kept dead flow rows, every kept element's ev2 and the kept dead
// elements; then both row indexes compacted in one grid, the first
// tiles_n blocks over c_idx and the rest over v_idx, each with its own
// tile counter and look-back chain (an entry survives when
// epos[idx[j]] >= 0 and becomes that place), each leaving its exclusive
// scan for the pointers.
template <typename T>
__global__ void __launch_bounds__(RP_TB) rp_index(Rp<T> s) {
  pdl_wait();
  int n_live = s.totals[0], n_le = s.totals[1];
  FOR_GRID(v, s.V) {
    int r = s.rpos[v];
    if (r < 0) {
      int p = n_live + (-1 - r);
      if (p < s.vh) put_flow(s, v, p);
    }
  }
  FOR_GRID(e, s.E) {
    int r = s.epos[e];
    int p = place(r, n_le);
    if (p < s.eh) {
      int nv = place(s.rpos[s.e_var[e]], n_live);
      s.ev2[p] = nv < s.vh - 1 ? nv : s.vh - 1;
      if (r < 0) {
        s.ec2[p] = s.e_cnst[e];
        s.ew2[p] = T(0);
      }
    }
  }
  zero_chain(s.st_v, s.tiles_v);
  zero_chain(s.st_e, s.tiles_e);
  bool second = blockIdx.x >= s.tiles_n;
  const int* idx = second ? s.v_idx : s.c_idx;
  unsigned long long* st = second ? s.st_x : s.st_c;
  int* exs = second ? s.ex_x : s.ex_c;
  int* out = second ? s.v_idx2 : s.c_idx2;
  const int* epos = s.epos;
  bool f[RP_IPT];
  int ex[RP_IPT], base, agg;
  int tile = compact_tile<RP_IPT>(
      st, s.tiles_n, s.nnz,
      [idx, epos](int j) { return epos[idx[j]] >= 0; }, f, ex, &base,
      &agg);
  if (threadIdx.x == 0 && tile == s.tiles_n - 1)
    s.totals[second ? 3 : 2] = base + agg;
  int lo = tile * RP_TILE + threadIdx.x;
  for (int k = 0; k < RP_IPT; ++k) {
    int j = lo + k * RP_TB;
    if (j >= s.nnz) break;
    int q = base + ex[k];
    exs[j] = q;
    if (f[k] && q < s.cap) out[q] = epos[idx[j]];
  }
}

template <typename T>
__global__ void __launch_bounds__(RP_TB) rp_ptrs(Rp<T> s) {
  pdl_wait();
  zero_chain(s.st_c, s.tiles_n);
  zero_chain(s.st_x, s.tiles_n);
  int n_live = s.totals[0], tot_c = s.totals[2], tot_x = s.totals[3];
  FOR_GRID(c, s.C + 1) {
    int j = s.c_ptr[c];
    s.c_ptr2[c] = j < s.nnz ? s.ex_c[j] : tot_c;
  }
  FOR_GRID(v, s.V) {
    int r = s.rpos[v];
    int p = place(r, n_live);
    if (p < s.vh) {
      int j = s.v_ptr[v];
      s.v_ptr2[p] = (r >= 0 && j < s.nnz) ? s.ex_x[j] : tot_x;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) s.v_ptr2[s.vh] = tot_x;
}

template <typename T>
int run(Rp<T> s, cudaStream_t st) {
  int gp = grid_for((long long)(s.C + 1 > s.V ? s.C + 1 : s.V), RP_TB);
  rp_rank<T><<<s.tiles_v + s.tiles_e, RP_TB, 0, st>>>(s);
  cudaError_t e =
      launch_dependent(rp_index<T>, dim3(2 * s.tiles_n), RP_TB, st, s);
  if (e == cudaSuccess)
    e = launch_dependent(rp_ptrs<T>, dim3(gp), RP_TB, st, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
Rp<T> make(int V, int E, int C, int nnz, int vh, int eh, int cap,
           void** p, void* status, void* work) {
  Rp<T> s;
  s.V = V;
  s.E = E;
  s.C = C;
  s.nnz = nnz;
  s.vh = vh;
  s.eh = eh;
  s.cap = cap;
  s.tiles_v = tiles_of(V);
  s.tiles_e = tiles_of(E);
  s.tiles_n = tiles_of(nnz);
  s.e_var = (const int*)p[0];
  s.e_cnst = (const int*)p[1];
  s.e_w = (const T*)p[2];
  s.pen = (const T*)p[3];
  s.rem = (const T*)p[4];
  s.thresh = (const T*)p[5];
  s.ids = (const int*)p[6];
  s.vb = (const T*)p[7];
  s.c_ptr = (const int*)p[8];
  s.c_idx = (const int*)p[9];
  s.v_ptr = (const int*)p[10];
  s.v_idx = (const int*)p[11];
  s.ev2 = (int*)p[12];
  s.ec2 = (int*)p[13];
  s.ew2 = (T*)p[14];
  s.pen2 = (T*)p[15];
  s.rem2 = (T*)p[16];
  s.thresh2 = (T*)p[17];
  s.ids2 = (int*)p[18];
  s.vb2 = (T*)p[19];
  s.c_ptr2 = (int*)p[20];
  s.c_idx2 = (int*)p[21];
  s.v_ptr2 = (int*)p[22];
  s.v_idx2 = (int*)p[23];
  unsigned long long* u = (unsigned long long*)status;
  s.st_v = u;
  s.st_e = s.st_v + s.tiles_v + 1;
  s.st_c = s.st_e + s.tiles_e + 1;
  s.st_x = s.st_c + s.tiles_n + 1;
  int* w = (int*)work;
  s.rpos = w;
  s.epos = s.rpos + V;
  s.ex_c = s.epos + E;
  s.ex_x = s.ex_c + nnz;
  s.totals = s.ex_x + nnz;
  return s;
}

}  // namespace

extern "C" {

// `ptrs`: N_PTRS buffers in the order of `make` (vb and vb2 NULL
// without bounds); `status`: 64-bit words, zero before the call and
// again after it, one a tile of each partition and one start counter
// each (tiles(V) + tiles(E) + 2 tiles(nnz) + 4, a partition of n rows
// taking max(1, ceil(n / RP_TILE)) tiles); `work`: V + E + 2 nnz + 4
// int32 words.
int livefirst_repack(int dbl, int V, int E, int C, int nnz, int vh, int eh,
                     int cap, void** ptrs, int n_ptrs, void* status,
                     void* work, void* stream) {
  if (n_ptrs != N_PTRS || vh < 1 || eh < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return run(make<double>(V, E, C, nnz, vh, eh, cap, ptrs, status, work),
               st);
  return run(make<float>(V, E, C, nnz, vh, eh, cap, ptrs, status, work),
             st);
}

}  // extern "C"
