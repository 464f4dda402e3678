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
// What bounds it on this card: memory.  It reads the element arrays,
// the flow arrays and both row indexes once or twice and writes the
// halves (about 2 x (E x 16 B + nnz x 8 B) = 60 MB at config #4, about
// 18 us at 3.35 TB/s), and it runs once per halving of the live set.
//
// What the design does about it: every partition is the same three-
// pass scan (per-tile counts, one block scanning the tile counts,
// per-tile scan and apply) over byte flags, with no atomics, so the
// positions are stable by construction; the gathers are scatters to
// the computed positions, one thread per row.

#include "common.cuh"
#include "scan.cuh"

namespace {

template <typename T>
__global__ void flags_v(int V, const T* __restrict__ pen, uint8_t* fv) {
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x)
    fv[v] = pen[v] > T(0);
}

template <typename T>
__global__ void flags_e(int E, const int* __restrict__ e_var,
                        const T* __restrict__ e_w,
                        const uint8_t* __restrict__ fv, uint8_t* fe) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x)
    fe[e] = e_w[e] > T(0) && fv[e_var[e]];
}

__global__ void flags_idx(int n, const int* __restrict__ idx,
                          const uint8_t* __restrict__ fe, uint8_t* f) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x)
    f[j] = fe[idx[j]];
}

// position of row i in the stable live-first order
__device__ __forceinline__ int livefirst_pos(int i, bool live, int ex,
                                             int n_live) {
  return live ? ex : n_live + (i - ex);
}

template <typename T>
__global__ void scatter_v(int V, int vh, const uint8_t* __restrict__ fv,
                          const int* __restrict__ ex, const int* totals,
                          const T* __restrict__ pen, const T* __restrict__ rem,
                          const T* __restrict__ thresh,
                          const int* __restrict__ ids,
                          const T* __restrict__ vb, int* pos_v, T* pen2,
                          T* rem2, T* thresh2, int* ids2, T* vb2) {
  int n_live = totals[0];
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    int p = livefirst_pos(v, fv[v], ex[v], n_live);
    pos_v[v] = p;
    if (p < vh) {
      pen2[p] = pen[v];
      rem2[p] = rem[v];
      thresh2[p] = thresh[v];
      ids2[p] = ids[v];
      if (vb) vb2[p] = vb[v];
    }
  }
}

template <typename T>
__global__ void scatter_e(int E, int eh, int vh,
                          const uint8_t* __restrict__ fe,
                          const int* __restrict__ ex, const int* totals,
                          const int* __restrict__ e_var,
                          const int* __restrict__ e_cnst,
                          const T* __restrict__ e_w,
                          const int* __restrict__ pos_v, int* pos_e,
                          int* ev2, int* ec2, T* ew2) {
  int n_live = totals[1];
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x) {
    bool live = fe[e];
    int p = livefirst_pos(e, live, ex[e], n_live);
    pos_e[e] = p;
    if (p < eh) {
      int nv = pos_v[e_var[e]];
      ev2[p] = nv < vh - 1 ? nv : vh - 1;
      ec2[p] = e_cnst[e];
      ew2[p] = live ? e_w[e] : T(0);
    }
  }
}

// stable compaction of a row index: keep entries of live elements,
// renumbered through the element permutation
__global__ void compact_idx(int n, const uint8_t* __restrict__ f,
                            const int* __restrict__ ex,
                            const int* __restrict__ idx,
                            const int* __restrict__ pos_e, int* out,
                            int cap) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    if (f[j]) {
      int q = ex[j];
      if (q < cap) out[q] = pos_e[idx[j]];
    }
  }
}

__global__ void ptr_c(int C, int nnz, const int* __restrict__ c_ptr,
                      const int* __restrict__ ex, const int* totals,
                      int* out) {
  int tot = totals[2];
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c <= C;
       c += gridDim.x * blockDim.x) {
    int j = c_ptr[c];
    out[c] = j < nnz ? ex[j] : tot;
  }
}

__global__ void ptr_v(int V, int vh, int nnz, const uint8_t* __restrict__ fv,
                      const int* __restrict__ pos_v,
                      const int* __restrict__ v_ptr,
                      const int* __restrict__ ex, const int* totals,
                      int* out) {
  int tot = totals[3];
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < V;
       v += gridDim.x * blockDim.x) {
    int p = pos_v[v];
    if (p < vh) {
      int j = v_ptr[v];
      out[p] = (fv[v] && j < nnz) ? ex[j] : tot;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[vh] = tot;
}

struct Scratch {
  uint8_t *fv, *fe, *fc, *fvv;
  int *ex_v, *ex_e, *ex_c, *ex_vv, *pos_v, *pos_e, *bsum, *totals;
};

template <typename T>
int run(int V, int E, int C, int nnz, int vh, int eh, int cap,
        const void* e_var, const void* e_cnst, const void* e_w,
        const void* pen, const void* rem, const void* thresh,
        const void* ids, const void* c_ptr, const void* c_idx,
        const void* v_ptr, const void* v_idx, void* ev2, void* ec2,
        void* ew2, void* pen2, void* rem2, void* thresh2, void* ids2,
        void* c_ptr2, void* c_idx2, void* v_ptr2, void* v_idx2,
        const void* vb, void* vb2, const Scratch& w, cudaStream_t s) {
  const int TB = 256;
  flags_v<T><<<grid_for(V, TB), TB, 0, s>>>(V, (const T*)pen, w.fv);
  flags_e<T><<<grid_for(E, TB), TB, 0, s>>>(E, (const int*)e_var,
                                            (const T*)e_w, w.fv, w.fe);
  flags_idx<<<grid_for(nnz, TB), TB, 0, s>>>(nnz, (const int*)c_idx, w.fe,
                                             w.fc);
  flags_idx<<<grid_for(nnz, TB), TB, 0, s>>>(nnz, (const int*)v_idx, w.fe,
                                             w.fvv);
  // the four scans share one block-sum buffer: each finishes (in stream
  // order) before the next one starts
  scan(V, w.fv, w.ex_v, w.bsum, w.totals + 0, s);
  scatter_v<T><<<grid_for(V, TB), TB, 0, s>>>(
      V, vh, w.fv, w.ex_v, w.totals, (const T*)pen, (const T*)rem,
      (const T*)thresh, (const int*)ids, (const T*)vb, w.pos_v, (T*)pen2,
      (T*)rem2, (T*)thresh2, (int*)ids2, (T*)vb2);
  scan(E, w.fe, w.ex_e, w.bsum, w.totals + 1, s);
  scatter_e<T><<<grid_for(E, TB), TB, 0, s>>>(
      E, eh, vh, w.fe, w.ex_e, w.totals, (const int*)e_var,
      (const int*)e_cnst, (const T*)e_w, w.pos_v, w.pos_e, (int*)ev2,
      (int*)ec2, (T*)ew2);
  scan(nnz, w.fc, w.ex_c, w.bsum, w.totals + 2, s);
  compact_idx<<<grid_for(nnz, TB), TB, 0, s>>>(nnz, w.fc, w.ex_c,
                                               (const int*)c_idx, w.pos_e,
                                               (int*)c_idx2, cap);
  ptr_c<<<grid_for(C + 1, TB), TB, 0, s>>>(C, nnz, (const int*)c_ptr,
                                           w.ex_c, w.totals, (int*)c_ptr2);
  scan(nnz, w.fvv, w.ex_vv, w.bsum, w.totals + 3, s);
  compact_idx<<<grid_for(nnz, TB), TB, 0, s>>>(nnz, w.fvv, w.ex_vv,
                                               (const int*)v_idx, w.pos_e,
                                               (int*)v_idx2, cap);
  ptr_v<<<grid_for(V, TB), TB, 0, s>>>(V, vh, nnz, w.fv, w.pos_v,
                                       (const int*)v_ptr, w.ex_vv, w.totals,
                                       (int*)v_ptr2);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes (bytes), laid out by the caller in one buffer `scratch`:
// flags V + E + 2*nnz bytes (rounded up to 16), then int32 arrays
// ex_v[V] ex_e[E] ex_c[nnz] ex_vv[nnz] pos_v[V] pos_e[E]
// bsum[ceil(max(V,E,nnz)/2048)] totals[4].
extern "C" int livefirst_repack(
    int dbl, int V, int E, int C, int nnz, int vh, int eh, int cap,
    const void* e_var, const void* e_cnst, const void* e_w, const void* pen,
    const void* rem, const void* thresh, const void* ids, const void* c_ptr,
    const void* c_idx, const void* v_ptr, const void* v_idx, void* ev2,
    void* ec2, void* ew2, void* pen2, void* rem2, void* thresh2, void* ids2,
    void* c_ptr2, void* c_idx2, void* v_ptr2, void* v_idx2, const void* vb,
    void* vb2, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  Scratch w;
  uint8_t* b = (uint8_t*)scratch;
  w.fv = b;
  w.fe = w.fv + V;
  w.fc = w.fe + E;
  w.fvv = w.fc + nnz;
  size_t fl = ((size_t)V + E + 2 * (size_t)nnz + 15) & ~(size_t)15;
  int* ip = (int*)(b + fl);
  w.ex_v = ip;
  w.ex_e = w.ex_v + V;
  w.ex_c = w.ex_e + E;
  w.ex_vv = w.ex_c + nnz;
  w.pos_v = w.ex_vv + nnz;
  w.pos_e = w.pos_v + V;
  w.bsum = w.pos_e + E;
  int mx = V > E ? V : E;
  if (nnz > mx) mx = nnz;
  w.totals = w.bsum + (mx + SCAN_TILE - 1) / SCAN_TILE + 1;
  if (dbl)
    return run<double>(V, E, C, nnz, vh, eh, cap, e_var, e_cnst, e_w, pen,
                       rem, thresh, ids, c_ptr, c_idx, v_ptr, v_idx, ev2,
                       ec2, ew2, pen2, rem2, thresh2, ids2, c_ptr2, c_idx2,
                       v_ptr2, v_idx2, vb, vb2, w, s);
  return run<float>(V, E, C, nnz, vh, eh, cap, e_var, e_cnst, e_w, pen, rem,
                    thresh, ids, c_ptr, c_idx, v_ptr, v_idx, ev2, ec2, ew2,
                    pen2, rem2, thresh2, ids2, c_ptr2, c_idx2, v_ptr2,
                    v_idx2, vb, vb2, w, s);
}
