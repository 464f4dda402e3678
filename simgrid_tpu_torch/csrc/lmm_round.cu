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
// them exactly as the JAX caller does.  The replica axis (a fleet of B
// scenarios: simgrid_tpu/ops/lmm_batch.py `_batch_superstep_program`,
// `_batch_fused_fresh`/`_cont` and lmm_jax.py:1054/1081, the solo
// programs vmapped over the replicas) runs every replica in the same
// launches.
//
// What bounds it on this card: latency, not bytes.  A round is a chain
// of grid-wide dependencies (neighbourhood min -> processable -> [low
// bounds -> mb_c -> mb_v -> blocked] -> levels -> sums), so it is four
// launches (eight with bounds, four or five in global order).  Each
// pass walks row indexes and gathers through them: c_ptr -> c_idx ->
// e_var -> penalty / state, a chain of three or four dependent loads.
// The bytes a local round must move (elements, bounds, penalties,
// state once) are about 27 MB at config #4, 8 us at 3.35 TB/s, and the
// 50 MB L2 holds the whole system; a pass cannot take less than one
// launch (about 2.5 us queued on this card, 1.4 us as a programmatic
// dependent, PERF.md §6) plus one such chain (about 1 us from L2), so a
// solo local round is bound below by about 4 x 2.5 = 10 us whatever
// its bytes.  A first design gave every
// constraint pass one warp a row, whatever its length, and each
// element's loads waited on the last: that cost 21-35x the bytes bound.
//
// What the design does about it, fault by fault:
// * rows mapped by length (`lmm_plan` below, built on the device from
//   c_ptr at each new row index: at system build and after every K4
//   repack).  A stable three-way partition puts the rows of more than
//   `long_min` elements first, then the rows of more than `short_max`,
//   then the rest, each class in increasing row order.  A constraint
//   pass walks the classes as units of one block: a long row takes a
//   whole block, eight medium rows a block (a warp each), 256 short rows
//   a block (a thread each, folding in a register in element order).
//   The grid is sized for the card, and blocks take units in turn,
//   reading the class counts from device memory, so the build needs no
//   host sync.  Every load of a chunk of elements, for every replica of
//   the group, is issued unconditionally at a valid address before any
//   is used, so a chunk costs one chain of dependent loads, not one per
//   element; the variable passes give each variable row four lanes;
// * long rows: the block's threads gather 256 elements at a time, and
//   one thread per replica folds the staged contributions from shared
//   memory in element order; mins, maxes and ORs reduce across the
//   block.  No warp walks a long row alone;
// * dead rows are skipped exactly: round_b, bnd_mbc and bnd_blk write
//   their row's result for a row that is not light (not processable)
//   without walking it (the walk could only give that result); round_d
//   walks a row that is not light only when a variable fixed in this
//   round lies on it, which round_c, glob_sat and glob_fix mark in
//   `touch` (a byte a constraint and replica, set by idempotent stores,
//   cleared by round_d and the init): with no fixed element the row's
//   remaining, usage and light are what JAX computes for it, unchanged.
//   A light row that is not touched has no fixed element either, so
//   round_d reads from it only whether it still has a live element and
//   stops at the first one;
// * one launch chain: a round's first kernel (round_a, or glob_reset
//   in global order) is a plain launch and every later pass a
//   programmatic dependent (`launch_dependent`; it waits in `pdl_wait`
//   for the pass before it), as is the init's constraint pass after
//   init_var.  No pass triggers its dependent early: on this card an
//   explicit `pdl_trigger`, at a pass's start or at its end, made the
//   round slower than the implicit trigger at its exit (PERF.md §6).
//   The round's bookkeeping (the light count into LIGHT, IT + 1,
//   for every replica whose round ran), which a one-thread launch did
//   before, is done in the last pass, RoundD, by a two-level ticket
//   (`round_end`): the light counts travel in the ticket words, so no
//   block fences.  Captured as the body of a K16 loop built with
//   `Loop(..., ends=True)`, its last block also does what the loop's
//   `loop_cond` node did after it: PRED_ROUND over every replica, the
//   tally and the cap's count, and the WHILE node's handle
//   (`end_iteration`, common.cuh), so a solo local round is four kernel
//   nodes in the loop where it was six (eight with bounds where it was
//   ten);
// * one index walk for a group of replicas: a thread, warp or block
//   that owns a row (or a variable) reads the shared index once and
//   keeps one fold per replica of a group of G (G of 1 or 2, chosen per
//   launch from B and the system's size; blockIdx.y picks the group):
//   the replicas' gathers are independent loads in flight together, and
//   the index is walked B / G times.  On this card the replicas' own
//   state loads, not the shared index, set the fleet's round: groups of
//   4 and 8 cost more in registers than they saved (PERF.md §6).
//
// What stays as it was: every sum that the JAX program takes with
// `.at[].add` (usage0, d_rem, d_use) is a left fold in element order
// from 0.0 that skips only contributions of exactly 0.0 (an exact
// no-op on the non-negative partial sums): a thread adds its row's
// elements in order, a warp adds its 32 lanes in lane order, a block's
// folding thread adds the staged entries in order.  No atomic feeds a
// float sum.  The global order's two grid-wide minima (min rou, min
// bound) are one unsigned atomicMin per block on the bits of a
// non-negative float, which is exact; rou is computed once per round
// into a buffer and the saturated test compares that stored value.
// `v_bound * penalty` is one rounded product (__dmul_rn) and the bound
// test |bp - mb| < eps is absolute, as in JAX.  The fixpoint state and
// the round counter stay on the device, and every launch first reads
// the control words and returns at once when the fixpoint has
// converged or its round limit is spent, so K16's loop runs rounds with
// no host in between, and a replica that is done waits while the others
// run.  A replica reads only its own control
// words and state, and equals its solo run by bits.

#include "common.cuh"
#include "scan.cuh"

#define ARM_BOUNDS 1
#define ARM_FATPIPE 2
#define ARM_GLOBAL 4
#define N_PTRS 31

namespace {

const int TB = 256;      // threads per block, every pass
const int NW = TB / 32;  // warps per block

// Every buffer of the fixpoint, in the order of kernels/lmm_round.py
// `_ptrs`; unused arms' pointers are NULL.  Per-replica arrays hold B
// rows (the solo layout is B = 1).
template <typename T>
struct Sys {
  int V, C, B, flags;
  T eps;
  // per-replica strides (in elements) of the element weights, bounds
  // and rate bounds (0: shared by every replica)
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
  // the row plan (lmm_plan): rows by class, and the three class sizes
  const int* order;
  const int* ncls;
  bool* touch;
};

template <typename T>
Sys<T> make_sys(int B, int V, int C, int flags, double eps, void** p,
                long long s_ew, int s_cb, int s_vb) {
  Sys<T> s;
  s.V = V;
  s.C = C;
  s.B = B;
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
  s.order = (const int*)p[28];
  s.ncls = (const int*)p[29];
  s.touch = (bool*)p[30];
  return s;
}

// replica b's entry of a per-variable / per-constraint array
#define VX(p, b, v) (p)[(long long)(b) * s.V + (v)]
#define CX(p, b, c) (p)[(long long)(b) * s.C + (c)]
// replica b's weight of element e, bound of constraint c, rate bound
// of variable v (shared arrays have stride 0)
#define EW(b, e) s.e_w[(long long)(b) * s.s_ew + (e)]
#define CB(b, c) s.c_bound[(long long)(b) * s.s_cb + (c)]
#define VB(b, v) s.vb[(long long)(b) * s.s_vb + (v)]
#define CTRL(b) (s.ctrl + (long long)(b) * N_CTRL)
// the replicas r of the group set in mask m (the loop is unrolled: G
// is a template argument)
#define FOR_REPS(r, m)          \
  _Pragma("unroll")             \
  for (int r = 0; r < G; ++r)   \
    if ((m) >> r & 1u)
#define FOR_ALL_REPS(r)  \
  _Pragma("unroll")      \
  for (int r = 0; r < G; ++r)
#define UNROLLED(k, n)  \
  _Pragma("unroll")     \
  for (int k = 0; k < (n); ++k)

__device__ __forceinline__ bool round_go(const int* ctrl) {
  return ctrl[C_ARMED] != 0 && ctrl[C_LIGHT] > 0 &&
         ctrl[C_IT] < ctrl[C_LIMIT];
}

// The replicas of group blockIdx.y whose round runs (bit r: replica
// blockIdx.y * G + r); `armed`: whose init ran (the init's passes).
template <typename T, int G>
__device__ __forceinline__ unsigned go_mask(const Sys<T>& s, bool armed) {
  unsigned go = 0;
  FOR_ALL_REPS(r) {
    int b = blockIdx.y * G + r;
    if (b < s.B) {
      const int* ctrl = CTRL(b);
      if (armed ? ctrl[C_ARMED] != 0 : round_go(ctrl)) go |= 1u << r;
    }
  }
  return go;
}

// Replica r of the group, clamped to the fleet: every load below is
// issued for every replica of the group, whether it walks or not (so
// that a thread's loads are independent and in flight together), and
// the results of replicas that do not walk are dropped.
template <typename T, int G>
__device__ __forceinline__ int rep_b(const Sys<T>& s, int r) {
  int b = blockIdx.y * G + r;
  return b < s.B ? b : s.B - 1;
}

// the replicas of `go` whose variable v is live (enabled: penalty > 0,
// and not fixed yet)
template <typename T, int G>
__device__ __forceinline__ unsigned live_mask(const Sys<T>& s, unsigned go,
                                              int v) {
  T p[G];
  bool f[G];
  FOR_ALL_REPS(r) {
    int b = rep_b<T, G>(s, r);
    p[r] = VX(s.pen, b, v);
    f[r] = VX(s.v_fixed, b, v);
  }
  unsigned lm = 0;
  FOR_ALL_REPS(r) lm |= (p[r] > T(0) && !f[r]) ? 1u << r : 0u;
  return lm & go;
}

template <typename T>
__device__ __forceinline__ T rou_of(const Sys<T>& s, int b, int c) {
  return div_rn(CX(s.remaining, b, c), CX(s.usage, b, c));
}

#define FOR_VARS(v) \
  for (int v = blockIdx.x * blockDim.x + threadIdx.x; v < s.V; \
       v += gridDim.x * blockDim.x)

// ------------------------------------------------- constraint passes
//
// A pass over the constraint rows is a policy P (below) run by one
// walker in three shapes.  Per element and replica P loads an `Ld`
// (every load unconditional, at a valid address) and turns it into an
// `Elem`: up to two contributions to in-order sums (`x0`, `x1`, added
// when `on`), one value to an order-free min or max (`m`), and OR flags
// (`f`); per row the walker folds them into an `Acc` and P's `done`
// writes the row's results.  P's `walk` says whether a replica's row
// must be walked at all; where not, `dead` writes what the walk would
// give.  A walker first loads a chunk's indices, then every element's
// and replica's `Ld`, then folds: the loads of a chunk are in flight
// together, not one dependent chain per element.

template <typename T>
struct Elem {
  T x0, x1, m;
  unsigned f;
  bool on;
};

template <typename T>
struct Acc {
  T s0, s1, m;
  unsigned f;
};

template <typename T, class P>
__device__ __forceinline__ T m_ident() {
  return P::MAX ? T(0) : inf_v<T>();
}

template <typename T, class P>
__device__ __forceinline__ T m_op(T a, T b) {
  return P::MAX ? max_v(a, b) : min_v(a, b);
}

template <typename T, class P>
__device__ __forceinline__ Acc<T> acc0() {
  Acc<T> a;
  a.s0 = T(0);
  a.s1 = T(0);
  a.m = m_ident<T, P>();
  a.f = 0;
  return a;
}

template <typename T, class P>
__device__ __forceinline__ Elem<T> elem_none() {
  Elem<T> x;
  x.x0 = T(0);
  x.x1 = T(0);
  x.m = m_ident<T, P>();
  x.f = 0;
  x.on = false;
  return x;
}

// fold one element into a thread's accumulator, in element order
// (`use`: the element is in the row and the replica walks)
template <typename T, class P>
__device__ __forceinline__ void fold(Acc<T>& a, const Elem<T>& x,
                                     bool use) {
  if (!use) return;
  if (P::NS > 0 && x.on) {
    a.s0 = add_rn(a.s0, x.x0);
    if (P::NS > 1) a.s1 = add_rn(a.s1, x.x1);
  }
  a.m = m_op<T, P>(a.m, x.m);
  a.f |= x.f;
}

// the walking replicas of row c (dead ones are written by `writer`)
template <typename T, int G, class P>
__device__ __forceinline__ unsigned walk_mask(const Sys<T>& s, unsigned go,
                                              int c, bool writer) {
  bool wk[G];
  FOR_ALL_REPS(r) wk[r] = P::walk(s, rep_b<T, G>(s, r), c);
  unsigned wm = 0;
  FOR_REPS(r, go) {
    if (wk[r])
      wm |= 1u << r;
    else if (writer)
      P::dead(s, blockIdx.y * G + r, c);
  }
  return wm;
}

// Whether every walking replica of row c needs only to find one
// element with flag P::PROBE_F (then the walk stops at the first chunk
// that holds one for each); P::probe says so per replica.
template <typename T, int G, class P>
__device__ __forceinline__ bool probe_only(const Sys<T>& s, unsigned wm,
                                           int c) {
  if (!P::PROBE_F) return false;
  bool all = true;
  FOR_REPS(r, wm) all &= P::probe(s, blockIdx.y * G + r, c);
  return all;
}

template <typename T, int G, class P>
__device__ __forceinline__ bool probe_found(const Acc<T> (&a)[G],
                                            unsigned wm) {
  bool found = true;
  FOR_REPS(r, wm) found &= (a[r].f & P::PROBE_F) != 0;
  return found;
}

// A short row: one thread, folding in element order.  U elements (4 /
// G) are loaded at once.
template <typename T, int G, class P>
__device__ __forceinline__ void thread_row(const Sys<T>& s, unsigned go,
                                           int c, int (&cnt)[G]) {
  constexpr int U = 4 / G;
  unsigned wm = walk_mask<T, G, P>(s, go, c, true);
  if (!wm) return;
  bool probe = probe_only<T, G, P>(s, wm, c);
  int info = P::row(s, c);
  Acc<T> a[G];
  FOR_ALL_REPS(r) a[r] = acc0<T, P>();
  int beg = s.c_ptr[c], end = s.c_ptr[c + 1];
  for (int base = beg; base < end; base += U) {
    int e[U], v[U];
    bool in[U];
    UNROLLED(k, U) {
      in[k] = base + k < end;
      e[k] = s.c_idx[in[k] ? base + k : beg];
    }
    UNROLLED(k, U) v[k] = s.e_var[e[k]];
    typename P::Ld ld[U][G];
    UNROLLED(k, U) {
      FOR_ALL_REPS(r) ld[k][r] = P::load(s, rep_b<T, G>(s, r), e[k], v[k]);
    }
    UNROLLED(k, U) {
      FOR_ALL_REPS(r) fold<T, P>(a[r], P::elem(ld[k][r], info),
                                 in[k] && (wm >> r & 1));
    }
    if (probe && probe_found<T, G, P>(a, wm)) break;
  }
  FOR_REPS(r, wm) cnt[r] += P::done(s, blockIdx.y * G + r, c, info, a[r]);
}

// A medium row: one warp, 32 x U elements at a time (U = 2 for one
// replica a group, else 1); the in-order sums add the contributing
// lanes one by one in lane order.
template <typename T, int G, class P>
__device__ __forceinline__ void warp_row(const Sys<T>& s, unsigned go,
                                         int c, int lane, int (&cnt)[G]) {
  constexpr int U = G == 1 ? 2 : 1;
  unsigned wm = walk_mask<T, G, P>(s, go, c, lane == 0);
  if (!wm) return;
  bool probe = probe_only<T, G, P>(s, wm, c);
  int info = P::row(s, c);
  Acc<T> a[G];
  FOR_ALL_REPS(r) a[r] = acc0<T, P>();
  int beg = s.c_ptr[c], end = s.c_ptr[c + 1];
  for (int base = beg; base < end; base += 32 * U) {
    int e[U], v[U];
    bool in[U];
    UNROLLED(k, U) {
      int j = base + 32 * k + lane;
      in[k] = j < end;
      e[k] = s.c_idx[in[k] ? j : beg];
    }
    UNROLLED(k, U) v[k] = s.e_var[e[k]];
    typename P::Ld ld[U][G];
    UNROLLED(k, U) {
      FOR_ALL_REPS(r) ld[k][r] = P::load(s, rep_b<T, G>(s, r), e[k], v[k]);
    }
    UNROLLED(k, U) {
      FOR_REPS(r, wm) {
        Elem<T> x = P::elem(ld[k][r], info);
        if (P::NS > 0) {
          unsigned m = __ballot_sync(FULL_MASK, in[k] && x.on);
          while (m) {
            int l = __ffs(m) - 1;
            m &= m - 1;
            a[r].s0 = add_rn(a[r].s0, __shfl_sync(FULL_MASK, x.x0, l));
            if (P::NS > 1)
              a[r].s1 = add_rn(a[r].s1, __shfl_sync(FULL_MASK, x.x1, l));
          }
        }
        if (in[k]) {
          a[r].m = m_op<T, P>(a[r].m, x.m);
          a[r].f |= x.f;
        }
      }
    }
    if (probe) {
      bool found = true;
      FOR_REPS(r, wm) found &= (__reduce_or_sync(FULL_MASK, a[r].f) &
                                P::PROBE_F) != 0;
      if (found) break;
    }
  }
  FOR_REPS(r, wm) {
    a[r].m = P::MAX ? warp_max(a[r].m) : warp_min(a[r].m);
    a[r].f = __reduce_or_sync(FULL_MASK, a[r].f);
    if (lane == r) cnt[r] += P::done(s, blockIdx.y * G + r, c, info, a[r]);
  }
}

// A long row: one block, TB elements at a time: thread t loads element
// t of the chunk, for every replica.  The in-order sums' contributions
// are staged in shared memory with one ballot mask per warp, and thread
// r folds replica r's contributions in element order.  (More elements a
// thread, for more loads in flight, cost more in registers and shared
// memory than they saved on the alltoall's rows: PERF.md §6.)
template <typename T, int G, class P>
__device__ __forceinline__ void block_row(const Sys<T>& s, unsigned go,
                                          int c, int (&cnt)[G]) {
  constexpr int NS1 = P::NS > 0 ? P::NS : 1;
  constexpr int SG = P::NS > 0 ? G : 1;
  __shared__ T stage[SG * NS1 * TB];
  __shared__ unsigned masks[SG * NW];
  __shared__ T redm[G * NW];
  __shared__ unsigned redf[G * NW];
  int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  unsigned wm = walk_mask<T, G, P>(s, go, c, t == 0);
  if (!wm) return;
  bool probe = probe_only<T, G, P>(s, wm, c);
  int info = P::row(s, c);
  Acc<T> a[G];
  FOR_ALL_REPS(r) a[r] = acc0<T, P>();
  T f0 = T(0), f1 = T(0);  // thread r < G: replica r's in-order sums
  int beg = s.c_ptr[c], end = s.c_ptr[c + 1];
  for (int base = beg; base < end; base += TB) {
    int j = base + t;
    bool in = j < end;
    int e = s.c_idx[in ? j : beg];
    int v = s.e_var[e];
    typename P::Ld ld[G];
    FOR_ALL_REPS(r) ld[r] = P::load(s, rep_b<T, G>(s, r), e, v);
    FOR_REPS(r, wm) {
      Elem<T> x = P::elem(ld[r], info);
      if (in) {
        a[r].m = m_op<T, P>(a[r].m, x.m);
        a[r].f |= x.f;
      }
      if (P::NS > 0) {
        stage[(r * NS1) * TB + t] = x.x0;
        if (P::NS > 1) stage[(r * NS1 + 1) * TB + t] = x.x1;
        unsigned m = __ballot_sync(FULL_MASK, in && x.on);
        if (lane == 0) masks[r * NW + wid] = m;
      }
    }
    if (P::NS > 0) {
      __syncthreads();
      if (t < G && (wm >> t & 1)) {
        const T* st = stage + (t * NS1) * TB;
        for (int w = 0; w < NW; ++w) {
          unsigned m = masks[t * NW + w];
          while (m) {
            int k = w * 32 + __ffs(m) - 1;
            m &= m - 1;
            f0 = add_rn(f0, st[k]);
            if (P::NS > 1) f1 = add_rn(f1, st[TB + k]);
          }
        }
      }
      __syncthreads();
    }
    if (probe) {
      bool found = true;
      FOR_REPS(r, wm) found &=
          __syncthreads_or((a[r].f & P::PROBE_F) != 0) != 0;
      if (found) break;
    }
  }
  FOR_REPS(r, wm) {
    T m = P::MAX ? warp_max(a[r].m) : warp_min(a[r].m);
    unsigned f = __reduce_or_sync(FULL_MASK, a[r].f);
    if (lane == 0) {
      redm[r * NW + wid] = m;
      redf[r * NW + wid] = f;
    }
  }
  __syncthreads();
  FOR_REPS(r, wm) {
    if (t == r) {
      Acc<T> z = acc0<T, P>();
      z.s0 = f0;
      z.s1 = f1;
      for (int w = 0; w < NW; ++w) {
        z.m = m_op<T, P>(z.m, redm[r * NW + w]);
        z.f |= redf[r * NW + w];
      }
      cnt[r] += P::done(s, blockIdx.y * G + r, c, info, z);
    }
  }
  __syncthreads();  // the next row reuses the shared arrays
}

// The round's bookkeeping in its last pass (RoundD), by a two-level
// ticket and no fence.  Level 1, per replica group: each block adds one
// 64-bit word to the ticket of the group's first replica (C_TICKET):
// 1 << 48 (a block in) plus its light rows of replica r << 24 r (a
// count below 2^24 a replica, so no field carries into the next); the
// block that takes the last ticket holds the group's light counts and,
// for each replica whose round ran, sets LIGHT and IT + 1.  Level 2,
// only inside a K16 loop whose body this round ends (`le.h`) and only
// with more than one group: each group's last block adds (its
// replicas still go) << 16 plus 1 to the launch-wide ticket C_GTICKET;
// the last one has PRED_ROUND over every replica, counts the iteration
// and sets the WHILE node's handle (`end_iteration`).  A replica whose
// round did not run keeps its words, so its condition stays false.
// Every block calls it with all its threads; `cnt` holds each thread's
// light rows by replica of the group.
template <typename T, int G>
__device__ __forceinline__ void round_end(const Sys<T>& s,
                                          const int (&cnt)[G],
                                          const LoopEnd& le) {
  __shared__ bool last;
  __shared__ unsigned long long got;
  unsigned long long add = 1ULL << 48;
  FOR_ALL_REPS(r) {
    int tot = block_sum(cnt[r]);  // valid in thread 0
    add += (unsigned long long)tot << (24 * r);
  }
  int b0 = blockIdx.y * G;
  if (threadIdx.x == 0) {
    unsigned long long* ticket = ticket_of(CTRL(b0));
    unsigned long long old = atomicAdd(ticket, add);
    last = (unsigned)(old >> 48) == gridDim.x - 1;
    if (last) {
      *ticket = 0ULL;
      got = old + add;
    }
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  bool go = false;
  FOR_ALL_REPS(r) {
    int b = b0 + r;
    if (b >= s.B) break;
    int* ctrl = CTRL(b);
    int it = ctrl[C_IT], lt = ctrl[C_LIGHT], lim = ctrl[C_LIMIT];
    if (!(ctrl[C_ARMED] != 0 && lt > 0 && it < lim)) continue;  // round_go
    lt = (int)((got >> (24 * r)) & 0xffffff);
    ctrl[C_LIGHT] = lt;
    ctrl[C_IT] = it + 1;
    go |= lt > 0 && it + 1 < lim;
  }
  if (!le.h) return;
  if (gridDim.y > 1) {
    unsigned* gticket = reinterpret_cast<unsigned*>(s.ctrl + C_GTICKET);
    unsigned old = atomicAdd(gticket, (go ? 1u << 16 : 0u) | 1u);
    if ((old & 0xffffu) != gridDim.y - 1) return;
    *gticket = 0u;
    go = go || (old >> 16) != 0;
  }
  end_iteration(le, go);
}

// One constraint pass of policy P over every row of the plan.  Units:
// the long rows (one block each), then the medium rows (NW per block),
// then the short rows (TB per block); the blocks take units in turn.
// P::COUNT >= 0: the light rows are counted into that control slot;
// every pass leaves each thread's count of them in `cnt`.
template <typename T, int G, class P>
__device__ __forceinline__ void cnst_rows(const Sys<T>& s, unsigned go,
                                          int (&cnt)[G]) {
  int nL = s.ncls[0], nM = s.ncls[1], nS = s.ncls[2];
  int uM = (nM + NW - 1) / NW, uS = (nS + TB - 1) / TB;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int u = blockIdx.x, nu = nL + uM + uS; u < nu; u += gridDim.x) {
    if (u < nL) {
      block_row<T, G, P>(s, go, s.order[u], cnt);
    } else if (u < nL + uM) {
      int i = (u - nL) * NW + wid;
      if (i < nM) warp_row<T, G, P>(s, go, s.order[nL + i], lane, cnt);
    } else {
      int i = (u - nL - uM) * TB + threadIdx.x;
      if (i < nS) thread_row<T, G, P>(s, go, s.order[nL + nM + i], cnt);
    }
  }
  if (P::COUNT >= 0) {
    FOR_ALL_REPS(r) {
      int tot = warp_sum(cnt[r]);
      if (lane == 0 && tot) atomicAdd(CTRL(blockIdx.y * G + r) + P::COUNT,
                                      tot);
    }
  }
}

// The pass as a kernel; P::END: the round's last pass, which counts
// its light rows by replica and ends the round (round_end).
template <typename T, int G, class P>
__global__ void __launch_bounds__(TB, 3) cnst_pass(Sys<T> s, LoopEnd le) {
  pdl_wait();
  unsigned go = go_mask<T, G>(s, P::ARMED);
  int cnt[G];
  FOR_ALL_REPS(r) cnt[r] = 0;
  if (go) cnst_rows<T, G, P>(s, go, cnt);
  if (P::END) round_end<T, G>(s, cnt, le);
}

// usage0: in-order sum of w/penalty for SHARED rows, max for FATPIPE
// rows; remaining, light, and the touch marks cleared.
template <typename T, bool FAT>
struct InitC {
  static constexpr int NS = 1;
  static constexpr bool MAX = true;
  static constexpr bool ARMED = true;
  static constexpr int COUNT = C_LIGHT;
  static constexpr bool END = false;
  static constexpr unsigned PROBE_F = 0;
  struct Ld {
    T w, p;
  };
  __device__ static int row(const Sys<T>& s, int c) {
    return FAT && s.c_fat[c];
  }
  __device__ static bool walk(const Sys<T>&, int, int) { return true; }
  __device__ static void dead(const Sys<T>&, int, int) {}
  __device__ static bool probe(const Sys<T>&, int, int) { return false; }
  __device__ static Ld load(const Sys<T>& s, int b, int e, int v) {
    return Ld{EW(b, e), VX(s.pen, b, v)};
  }
  __device__ static Elem<T> elem(const Ld& l, int) {
    Elem<T> x;
    x.on = l.w > T(0) && l.p > T(0);
    x.x0 = x.on ? div_rn(l.w, l.p) : T(0);
    x.x1 = T(0);
    x.m = x.x0;
    x.f = 0;
    return x;
  }
  __device__ static int done(const Sys<T>& s, int b, int c, int fat,
                             const Acc<T>& a) {
    T use = fat ? a.m : a.s0;
    T cb = CB(b, c);
    CX(s.remaining, b, c) = cb;
    CX(s.usage, b, c) = use;
    bool lt = (cb > mul_rn(cb, s.eps)) && (use > T(0));
    CX(s.light, b, c) = lt;
    CX(s.touch, b, c) = false;
    return lt;
  }
};

// Pass B: a light constraint is processable when its rou is at most
// the two-hop neighbourhood min.  A row that is not light is not
// processable, whatever its walk would find: it is not walked.
template <typename T>
struct RoundB {
  static constexpr int NS = 0;
  static constexpr bool MAX = false;
  static constexpr bool ARMED = false;
  static constexpr int COUNT = -1;
  static constexpr bool END = false;
  static constexpr unsigned PROBE_F = 0;
  struct Ld {
    T w, p, nm;
    bool fixed;
  };
  __device__ static int row(const Sys<T>&, int) { return 0; }
  __device__ static bool walk(const Sys<T>& s, int b, int c) {
    return CX(s.light, b, c);
  }
  __device__ static void dead(const Sys<T>& s, int b, int c) {
    CX(s.proc, b, c) = false;
  }
  __device__ static bool probe(const Sys<T>&, int, int) { return false; }
  __device__ static Ld load(const Sys<T>& s, int b, int e, int v) {
    return Ld{EW(b, e), VX(s.pen, b, v), VX(s.nmin_v, b, v),
              VX(s.v_fixed, b, v)};
  }
  __device__ static Elem<T> elem(const Ld& l, int) {
    Elem<T> x = elem_none<T, RoundB>();
    if (l.w > T(0) && l.p > T(0) && !l.fixed) x.m = l.nm;
    return x;
  }
  __device__ static int done(const Sys<T>& s, int b, int c, int,
                             const Acc<T>& a) {
    CX(s.proc, b, c) = rou_of(s, b, c) <= a.m;
    return 0;
  }
};

// Bound pass 2: mb_c = min bound * penalty over the constraint's live
// low-bound variables, inf unless the constraint is processable (an
// unprocessable row is not walked).
template <typename T>
struct BndMbc {
  static constexpr int NS = 0;
  static constexpr bool MAX = false;
  static constexpr bool ARMED = false;
  static constexpr int COUNT = -1;
  static constexpr bool END = false;
  static constexpr unsigned PROBE_F = 0;
  struct Ld {
    T w, p, vb;
    bool fixed, low;
  };
  __device__ static int row(const Sys<T>&, int) { return 0; }
  __device__ static bool walk(const Sys<T>& s, int b, int c) {
    return CX(s.proc, b, c);
  }
  __device__ static void dead(const Sys<T>& s, int b, int c) {
    CX(s.mb_c, b, c) = inf_v<T>();
  }
  __device__ static bool probe(const Sys<T>&, int, int) { return false; }
  __device__ static Ld load(const Sys<T>& s, int b, int e, int v) {
    return Ld{EW(b, e), VX(s.pen, b, v), VB(b, v), VX(s.v_fixed, b, v),
              VX(s.low_v, b, v)};
  }
  __device__ static Elem<T> elem(const Ld& l, int) {
    Elem<T> x = elem_none<T, BndMbc>();
    if (l.w > T(0) && l.p > T(0) && !l.fixed && l.low)
      x.m = mul_rn(l.vb, l.p);
    return x;
  }
  __device__ static int done(const Sys<T>& s, int b, int c, int,
                             const Acc<T>& a) {
    CX(s.mb_c, b, c) = a.m;
    return 0;
  }
};

// Bound pass 4: a processable constraint is blocked when one of its
// live variables has a finite mb_v (it waits for the bound fixes); an
// unprocessable one is not blocked and is not walked.
template <typename T>
struct BndBlk {
  static constexpr int NS = 0;
  static constexpr bool MAX = false;
  static constexpr bool ARMED = false;
  static constexpr int COUNT = -1;
  static constexpr bool END = false;
  static constexpr unsigned PROBE_F = 0;
  struct Ld {
    T w, p, mbv;
    bool fixed;
  };
  __device__ static int row(const Sys<T>&, int) { return 0; }
  __device__ static bool walk(const Sys<T>& s, int b, int c) {
    return CX(s.proc, b, c);
  }
  __device__ static void dead(const Sys<T>& s, int b, int c) {
    CX(s.blocked_c, b, c) = false;
  }
  __device__ static bool probe(const Sys<T>&, int, int) { return false; }
  __device__ static Ld load(const Sys<T>& s, int b, int e, int v) {
    return Ld{EW(b, e), VX(s.pen, b, v), VX(s.mb_v, b, v),
              VX(s.v_fixed, b, v)};
  }
  __device__ static Elem<T> elem(const Ld& l, int) {
    Elem<T> x = elem_none<T, BndBlk>();
    x.f = l.w > T(0) && l.p > T(0) && !l.fixed && finite_v(l.mbv);
    return x;
  }
  __device__ static int done(const Sys<T>& s, int b, int c, int,
                             const Acc<T>& a) {
    CX(s.blocked_c, b, c) = a.f != 0;
    return 0;
  }
};

// Pass D (apply_fixes): in-order d_rem / d_use sums of the fixed
// variables, eps clamps, the FATPIPE usage max over still-live
// elements (FATPIPE rows, FAT), light-set pruning; counts the light
// set.  f bit 0: an element was fixed (touched), bit 1: one is live.
// A row that is neither light nor touched has no fixed element: its
// remaining and usage stay, and it stays not light, as in JAX; it is
// not walked.
template <typename T, bool FAT>
struct RoundD {
  static constexpr int NS = 2;
  static constexpr bool MAX = true;
  static constexpr bool ARMED = false;
  static constexpr int COUNT = -1;
  static constexpr bool END = true;
  // An untouched light row has no fixed element: no sum, no FATPIPE max
  // and no change is read from its walk, only whether it still has a
  // live element (bit 1), so the walk stops at the first one.
  static constexpr unsigned PROBE_F = 2;
  struct Ld {
    T w, p, val;
    bool now, fixed;
  };
  __device__ static int row(const Sys<T>& s, int c) {
    return FAT && s.c_fat[c];
  }
  __device__ static bool walk(const Sys<T>& s, int b, int c) {
    return CX(s.light, b, c) | CX(s.touch, b, c);
  }
  __device__ static void dead(const Sys<T>&, int, int) {}
  __device__ static bool probe(const Sys<T>& s, int b, int c) {
    return !CX(s.touch, b, c);
  }
  __device__ static Ld load(const Sys<T>& s, int b, int e, int v) {
    return Ld{EW(b, e), VX(s.pen, b, v), VX(s.v_value, b, v),
              VX(s.fix_now, b, v), VX(s.v_fixed, b, v)};
  }
  __device__ static Elem<T> elem(const Ld& l, int fat) {
    Elem<T> x;
    bool valid = l.w > T(0) && l.p > T(0);
    bool fx = valid && l.now;
    bool lv = valid && !l.fixed;
    // the division only where a sum or the FATPIPE max reads it
    T xu = (fx || (fat && lv)) ? div_rn(l.w, l.p) : T(0);
    x.x0 = fx ? mul_rn(l.w, l.val) : T(0);
    x.x1 = xu;
    x.on = fx;
    x.m = lv ? xu : T(0);
    x.f = (fx ? 1u : 0u) | (lv ? 2u : 0u);
    return x;
  }
  __device__ static int done(const Sys<T>& s, int b, int c, int fat,
                             const Acc<T>& a) {
    bool touched = a.f & 1u, has_live = a.f & 2u;
    T ce = mul_rn(CB(b, c), s.eps);
    T rem = CX(s.remaining, b, c), use = CX(s.usage, b, c);
    if (touched) {
      T nr = sub_rn(rem, a.s0);
      if (nr < ce) nr = T(0);
      T nu = sub_rn(use, a.s1);
      if (nu < s.eps) nu = T(0);
      if (fat) {
        // a FATPIPE row keeps its remaining (lmm_jax.py:496)
        use = a.m;
      } else {
        rem = nr;
        use = nu;
      }
      CX(s.remaining, b, c) = rem;
      CX(s.usage, b, c) = use;
    }
    bool drop = touched && (!(use > s.eps) || !(rem > ce));
    bool lt = CX(s.light, b, c) && !drop && has_live;
    CX(s.light, b, c) = lt;
    CX(s.touch, b, c) = false;
    return lt;
  }
};

// -------------------------------------------------- variable passes
//
// LPV lanes per variable row (rows are route-length short: at most 14
// elements on the port's systems), for every replica of the group: the
// row index and the element's constraint are read once, each lane
// loads U (4 / G) elements' indices and then every element's and
// replica's data at once, and the lanes' mins and ORs reduce over the
// group of LPV lanes; lane 0 of the group writes the results.

#define LPV 4

// variable v (and q, the lane in its group of LPV), grid-stride
#define FOR_VAR_LANES(v, q)                                             \
  for (int _t = blockIdx.x * blockDim.x + threadIdx.x, q = _t % LPV,   \
           v = _t / LPV;                                                \
       v < s.V; v += gridDim.x * blockDim.x / LPV)

// the lanes of this thread's group of LPV (aligned in the warp)
__device__ __forceinline__ unsigned group_mask() {
  return ((1u << LPV) - 1) << ((threadIdx.x & 31) & ~(LPV - 1));
}

template <typename T>
__device__ __forceinline__ T group_min(T x, unsigned gm) {
#pragma unroll
  for (int o = 1; o < LPV; o <<= 1)
    x = min_v(x, __shfl_xor_sync(gm, x, o));
  return x;
}

// lane q's U elements of chunk `base` of variable row [beg, end): their
// element and constraint indices (`in`: inside the row)
template <typename T, int U>
__device__ __forceinline__ void var_chunk(const Sys<T>& s, int beg, int end,
                                          int base, int q, int (&e)[U],
                                          int (&c)[U], bool (&in)[U]) {
  UNROLLED(k, U) {
    int j = base + q + k * LPV;
    in[k] = j < end;
    e[k] = s.v_idx[in[k] ? j : beg];
  }
  UNROLLED(k, U) c[k] = s.e_cnst[e[k]];
}

// Mark the constraints of variable v touched for the replicas in
// `fixed` (round_d then walks them), lane q taking every LPV-th
// element.  A superset of the rows a fixed element lies on is
// harmless: round_d walks them and finds what JAX finds.
template <typename T, int G>
__device__ __forceinline__ void touch_rows(const Sys<T>& s, int v, int q,
                                           unsigned fixed) {
  for (int j = s.v_ptr[v] + q, end = s.v_ptr[v + 1]; j < end; j += LPV) {
    int c = s.e_cnst[s.v_idx[j]];
    FOR_REPS(r, fixed) CX(s.touch, blockIdx.y * G + r, c) = true;
  }
}

template <typename T, int G>
__global__ void __launch_bounds__(TB) init_var(Sys<T> s, int gated,
                                               int limit) {
  pdl_wait();
  unsigned go = 0;
  FOR_ALL_REPS(r) {
    int b = blockIdx.y * G + r;
    if (b >= s.B) continue;
    int* ctrl = CTRL(b);
    int g = gated ? ctrl[C_SS_ACTIVE] : 1;
    if (g) go |= 1u << r;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      ctrl[C_ARMED] = g;
      if (g) {
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
  }
  if (!go) return;
  FOR_VARS(v) {
    FOR_REPS(r, go) {
      int b = blockIdx.y * G + r;
      T p = VX(s.pen, b, v);
      // parked variables carry penalty inf; inf*0 is NaN, so sanitise
      T base = finite_v(p) ? p : T(0);
      VX(s.v_value, b, v) = mul_rn(base, T(0));
      VX(s.v_fixed, b, v) = p < T(0);
    }
  }
}

// Pass A: nmin_v = min rou over the variable's live elements.
template <typename T, int G>
__global__ void __launch_bounds__(TB) round_a(Sys<T> s) {
  pdl_wait();
  constexpr int U = 4 / G;
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  unsigned gm = group_mask();
  FOR_VAR_LANES(v, q) {
    unsigned lm = live_mask<T, G>(s, go, v);
    T m[G];
    FOR_ALL_REPS(r) m[r] = inf_v<T>();
    int beg = s.v_ptr[v], end = lm ? s.v_ptr[v + 1] : beg;
    for (int base = beg; base < end; base += LPV * U) {
      int e[U], c[U];
      bool in[U];
      var_chunk<T, U>(s, beg, end, base, q, e, c, in);
      T w[U][G], rem[U][G], use[U][G];
      bool lt[U][G];
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          int b = rep_b<T, G>(s, r);
          w[k][r] = EW(b, e[k]);
          lt[k][r] = CX(s.light, b, c[k]);
          rem[k][r] = CX(s.remaining, b, c[k]);
          use[k][r] = CX(s.usage, b, c[k]);
        }
      }
      UNROLLED(k, U) {
        FOR_REPS(r, lm) {
          if (in[k] && w[k][r] > T(0) && lt[k][r])
            m[r] = min_v(m[r], div_rn(rem[k][r], use[k][r]));
        }
      }
    }
    FOR_ALL_REPS(r) m[r] = group_min(m[r], gm);
    if (q == 0) {
      FOR_REPS(r, go) VX(s.nmin_v, blockIdx.y * G + r, v) = m[r];
    }
  }
}

// Bound pass 1: low_v = saturated (touches a processable constraint),
// bounded, and bound * penalty below its level nmin_v.
template <typename T, int G>
__global__ void __launch_bounds__(TB) bnd_low(Sys<T> s) {
  pdl_wait();
  constexpr int U = 4 / G;
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  unsigned gm = group_mask();
  FOR_VAR_LANES(v, q) {
    T vb[G], p[G], nm[G];
    FOR_ALL_REPS(r) {
      int b = rep_b<T, G>(s, r);
      vb[r] = VB(b, v);
      p[r] = VX(s.pen, b, v);
      nm[r] = VX(s.nmin_v, b, v);
    }
    unsigned cand = 0, sat = 0;
    FOR_ALL_REPS(r) cand |= vb[r] > T(0) ? 1u << r : 0u;
    cand &= live_mask<T, G>(s, go, v);
    int beg = s.v_ptr[v], end = cand ? s.v_ptr[v + 1] : beg;
    for (int base = beg; base < end; base += LPV * U) {
      int e[U], c[U];
      bool in[U];
      var_chunk<T, U>(s, beg, end, base, q, e, c, in);
      T w[U][G];
      bool pc[U][G];
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          int b = rep_b<T, G>(s, r);
          w[k][r] = EW(b, e[k]);
          pc[k][r] = CX(s.proc, b, c[k]);
        }
      }
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          if (in[k] && w[k][r] > T(0) && pc[k][r]) sat |= 1u << r;
        }
      }
    }
    sat = __reduce_or_sync(gm, sat) & cand;
    if (q == 0) {
      FOR_REPS(r, go) VX(s.low_v, blockIdx.y * G + r, v) =
          (sat >> r & 1) && mul_rn(vb[r], p[r]) < nm[r];
    }
  }
}

// Bound pass 3: mb_v = min mb_c over the variable's processable
// constraints.
template <typename T, int G>
__global__ void __launch_bounds__(TB) bnd_mbv(Sys<T> s) {
  pdl_wait();
  constexpr int U = 4 / G;
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  unsigned gm = group_mask();
  FOR_VAR_LANES(v, q) {
    unsigned lm = live_mask<T, G>(s, go, v);
    T m[G];
    FOR_ALL_REPS(r) m[r] = inf_v<T>();
    int beg = s.v_ptr[v], end = lm ? s.v_ptr[v + 1] : beg;
    for (int base = beg; base < end; base += LPV * U) {
      int e[U], c[U];
      bool in[U];
      var_chunk<T, U>(s, beg, end, base, q, e, c, in);
      T w[U][G], mb[U][G];
      bool pc[U][G];
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          int b = rep_b<T, G>(s, r);
          w[k][r] = EW(b, e[k]);
          pc[k][r] = CX(s.proc, b, c[k]);
          mb[k][r] = CX(s.mb_c, b, c[k]);
        }
      }
      UNROLLED(k, U) {
        FOR_REPS(r, lm) {
          if (in[k] && w[k][r] > T(0) && pc[k][r])
            m[r] = min_v(m[r], mb[k][r]);
        }
      }
    }
    FOR_ALL_REPS(r) m[r] = group_min(m[r], gm);
    if (q == 0) {
      FOR_REPS(r, go) VX(s.mb_v, blockIdx.y * G + r, v) = m[r];
    }
  }
}

// Pass C: a live variable touching a processable (unblocked) constraint
// is fixed at its minimal such rou over its penalty; with bounds, a
// low-bound variable at its constraint's minimal bound is fixed at its
// bound first.  A fixed variable marks its rows touched.
template <typename T, int G>
__global__ void __launch_bounds__(TB) round_c(Sys<T> s) {
  pdl_wait();
  constexpr int U = 4 / G;
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  bool bounds = s.flags & ARM_BOUNDS;
  unsigned gm = group_mask();
  FOR_VAR_LANES(v, q) {
    unsigned lm = live_mask<T, G>(s, go, v);
    T m[G];
    FOR_ALL_REPS(r) m[r] = inf_v<T>();
    int beg = s.v_ptr[v], end = lm ? s.v_ptr[v + 1] : beg;
    for (int base = beg; base < end; base += LPV * U) {
      int e[U], c[U];
      bool in[U];
      var_chunk<T, U>(s, beg, end, base, q, e, c, in);
      T w[U][G], rem[U][G], use[U][G];
      bool ok[U][G];
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          int b = rep_b<T, G>(s, r);
          w[k][r] = EW(b, e[k]);
          ok[k][r] = CX(s.proc, b, c[k]) &
                     !(bounds & CX(s.blocked_c, b, c[k]));
          rem[k][r] = CX(s.remaining, b, c[k]);
          use[k][r] = CX(s.usage, b, c[k]);
        }
      }
      UNROLLED(k, U) {
        FOR_REPS(r, lm) {
          if (in[k] && w[k][r] > T(0) && ok[k][r])
            m[r] = min_v(m[r], div_rn(rem[k][r], use[k][r]));
        }
      }
    }
    FOR_ALL_REPS(r) m[r] = group_min(m[r], gm);
    unsigned fixed = 0;
    if (q == 0) {
      FOR_REPS(r, go) {
        int b = blockIdx.y * G + r;
        bool fx = false;
        if (lm >> r & 1) {
          T p = VX(s.pen, b, v);
          bool fix_bound = false;
          if (bounds && VX(s.low_v, b, v)) {
            T d = sub_rn(mul_rn(VB(b, v), p), VX(s.mb_v, b, v));
            fix_bound = fabs(d) < s.eps;
          }
          if (fix_bound) {
            VX(s.v_value, b, v) = VB(b, v);
            fx = true;
          } else if (finite_v(m[r])) {
            VX(s.v_value, b, v) = div_rn(m[r], p);
            fx = true;
          }
          if (fx) VX(s.v_fixed, b, v) = true;
        }
        if (bounds) VX(s.level2_v, b, v) = m[r];
        VX(s.fix_now, b, v) = fx;
        if (fx) fixed |= 1u << r;
      }
    }
    fixed = __shfl_sync(gm, fixed, (threadIdx.x & 31) & ~(LPV - 1));
    if (fixed) touch_rows<T, G>(s, v, q, fixed);
  }
}

// --------------------------------------------------------- global order

// one thread per replica (blockIdx.y)
template <typename T>
__global__ void glob_reset(Sys<T> s) {
  pdl_wait();
  int b = blockIdx.y;
  if (!round_go(CTRL(b))) return;
  s.min_usage[b] = key_of(inf_v<T>());
  s.min_bound[b] = key_of(inf_v<T>());
}

// rou of every constraint, stored once, and its grid-wide min (one
// replica per blockIdx.y: the pass reads no row index)
template <typename T>
__global__ void __launch_bounds__(TB) glob_rou(Sys<T> s) {
  pdl_wait();
  int b = blockIdx.y;
  if (!round_go(CTRL(b))) return;
  T m = inf_v<T>();
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < s.C;
       c += gridDim.x * blockDim.x) {
    T r = CX(s.light, b, c) ? rou_of(s, b, c) : inf_v<T>();
    CX(s.rou, b, c) = r;
    m = min_v(m, r);
  }
  block_min_to(m, s.min_usage + b);
}

// saturated variables: a live element in a light constraint whose
// stored rou equals the min.  Bound-free: fix them at min/penalty (and
// mark their rows touched).  With bounds: record v_sat (in low_v) and
// the grid-wide min of bound * penalty over saturated bounded variables
// below the min.
template <typename T, int G>
__global__ void __launch_bounds__(TB) glob_sat(Sys<T> s) {
  pdl_wait();
  constexpr int U = 4 / G;
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  bool bounds = s.flags & ARM_BOUNDS;
  unsigned gm = group_mask();
  T mu[G], mb[G];
  FOR_ALL_REPS(r) {
    mu[r] = (go >> r & 1) ? from_key<T>(s.min_usage[blockIdx.y * G + r])
                          : inf_v<T>();
    mb[r] = inf_v<T>();
  }
  FOR_VAR_LANES(v, q) {
    unsigned lm = live_mask<T, G>(s, go, v), sat = 0;
    int beg = s.v_ptr[v], end = lm ? s.v_ptr[v + 1] : beg;
    for (int base = beg; base < end; base += LPV * U) {
      int e[U], c[U];
      bool in[U];
      var_chunk<T, U>(s, beg, end, base, q, e, c, in);
      T w[U][G], ro[U][G];
      bool lt[U][G];
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          int b = rep_b<T, G>(s, r);
          w[k][r] = EW(b, e[k]);
          lt[k][r] = CX(s.light, b, c[k]);
          ro[k][r] = CX(s.rou, b, c[k]);
        }
      }
      UNROLLED(k, U) {
        FOR_ALL_REPS(r) {
          if (in[k] && w[k][r] > T(0) && lt[k][r] && ro[k][r] == mu[r])
            sat |= 1u << r;
        }
      }
    }
    sat = __reduce_or_sync(gm, sat) & lm;
    if (q == 0) {
      FOR_REPS(r, go) {
        int b = blockIdx.y * G + r;
        bool st = sat >> r & 1;
        if (!bounds) {
          if (st) {
            VX(s.v_value, b, v) = div_rn(mu[r], VX(s.pen, b, v));
            VX(s.v_fixed, b, v) = true;
          }
          VX(s.fix_now, b, v) = st;
          continue;
        }
        VX(s.low_v, b, v) = st;
        if (st && VB(b, v) > T(0)) {
          T bp = mul_rn(VB(b, v), VX(s.pen, b, v));
          if (bp < mu[r]) mb[r] = min_v(mb[r], bp);
        }
      }
    }
    if (!bounds && sat) touch_rows<T, G>(s, v, q, sat);
  }
  if (bounds) {
    FOR_REPS(r, go) {
      __syncthreads();  // block_min_to's shared array is reused
      block_min_to(mb[r], s.min_bound + blockIdx.y * G + r);
    }
  }
}

// with bounds: when some saturated bound sits below the min, fix only
// the variables at the smallest such bound, at their bound; otherwise
// every saturated variable at min/penalty
template <typename T, int G>
__global__ void __launch_bounds__(TB) glob_fix(Sys<T> s) {
  pdl_wait();
  unsigned go = go_mask<T, G>(s, false);
  if (!go) return;
  T mu[G], mb[G];
  FOR_ALL_REPS(r) {
    int b = blockIdx.y * G + r;
    bool in = go >> r & 1;
    mu[r] = in ? from_key<T>(s.min_usage[b]) : inf_v<T>();
    mb[r] = in ? from_key<T>(s.min_bound[b]) : inf_v<T>();
  }
  FOR_VAR_LANES(v, q) {
    unsigned fixed = 0;
    FOR_REPS(r, go) {
      int b = blockIdx.y * G + r;
      bool fx = false;
      if (VX(s.low_v, b, v)) {
        T p = VX(s.pen, b, v);
        T val;
        if (finite_v(mb[r])) {
          fx = fabs(sub_rn(mul_rn(VB(b, v), p), mb[r])) < s.eps;
          val = VB(b, v);
        } else {
          fx = true;
          val = div_rn(mu[r], p);
        }
        if (fx && q == 0) {
          VX(s.v_value, b, v) = val;
          VX(s.v_fixed, b, v) = true;
        }
      }
      if (q == 0) VX(s.fix_now, b, v) = fx;
      if (fx) fixed |= 1u << r;
    }
    if (fixed) touch_rows<T, G>(s, v, q, fixed);
  }
}

// ------------------------------------------------------------ launches

// Replicas per group: 2 when there are two or more and the system is
// large enough that rows x groups still give the card about half its
// resident threads; else 1 (B groups in parallel).  Groups of 4 and 8
// cost more in registers than they save in index walks (PERF.md §6).
// `forced` (1 or 2; the caller's flags >> 8, checked by the entries)
// overrides the choice.
template <typename T>
static int pick_group(const Sys<T>& s, int forced) {
  if (forced) return forced;
  long long rows = s.V > s.C ? s.V : s.C;
  long long target = 32LL * 32 * sm_count();
  return s.B >= 2 && rows * ((s.B + 1) / 2) >= target ? 2 : 1;
}

// Resident blocks of TB threads of one kernel on the card.
template <typename K>
static int resident(K kernel) {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, TB, 0);
  return (n > 0 ? n : 1) * sm_count();
}

// The grid of a variable pass: a grid-stride loop over V (LPV lanes a
// variable; init_var's one thread a variable strides alike), the blocks
// shared among the groups.
static dim3 grid_v(int V, int ng) {
  int b = (int)(((long long)V * LPV + TB - 1) / TB);
  int cap = 8 * sm_count() / ng;
  if (cap < 1) cap = 1;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return dim3(b, ng);
}

// One constraint pass, a programmatic dependent of the kernel before
// it: at most one block per row and the card's resident blocks shared
// among the groups.
template <typename T, int G, class P>
static cudaError_t launch_cnst(const Sys<T>& s, int ng, LoopEnd le,
                               cudaStream_t st) {
  static int res = resident(cnst_pass<T, G, P>);
  int b = res / ng;
  if (b > s.C) b = s.C;
  if (b < 1) b = 1;
  return launch_dependent(cnst_pass<T, G, P>, dim3(b, ng), TB, st, s, le);
}

template <typename T, int G>
int launch_init_g(Sys<T> s, int gated, int limit, cudaStream_t st) {
  int ng = (s.B + G - 1) / G;
  init_var<T, G><<<grid_v(s.V, ng), TB, 0, st>>>(s, gated, limit);
  LoopEnd none{nullptr, nullptr, 0, 0};
  cudaError_t e =
      s.flags & ARM_FATPIPE
          ? launch_cnst<T, G, InitC<T, true>>(s, ng, none, st)
          : launch_cnst<T, G, InitC<T, false>>(s, ng, none, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A round: its first kernel a plain launch, the rest programmatic
// dependents; the last (RoundD) ends the loop body `le` when le.h is set.
template <typename T, int G>
int launch_round_g(Sys<T> s, LoopEnd le, cudaStream_t st) {
  int ng = (s.B + G - 1) / G;
  dim3 gv = grid_v(s.V, ng);
  LoopEnd none{nullptr, nullptr, 0, 0};
  cudaError_t e = cudaSuccess;
  if (s.flags & ARM_GLOBAL) {
    glob_reset<T><<<grid_r(s.B), 1, 0, st>>>(s);
    e = launch_dependent(glob_rou<T>, grid_b(s.C, TB, s.B), TB, st, s);
    if (e == cudaSuccess)
      e = launch_dependent(glob_sat<T, G>, gv, TB, st, s);
    if (e == cudaSuccess && (s.flags & ARM_BOUNDS))
      e = launch_dependent(glob_fix<T, G>, gv, TB, st, s);
  } else {
    round_a<T, G><<<gv, TB, 0, st>>>(s);
    e = launch_cnst<T, G, RoundB<T>>(s, ng, none, st);
    if (e == cudaSuccess && (s.flags & ARM_BOUNDS)) {
      e = launch_dependent(bnd_low<T, G>, gv, TB, st, s);
      if (e == cudaSuccess) e = launch_cnst<T, G, BndMbc<T>>(s, ng, none, st);
      if (e == cudaSuccess) e = launch_dependent(bnd_mbv<T, G>, gv, TB, st, s);
      if (e == cudaSuccess) e = launch_cnst<T, G, BndBlk<T>>(s, ng, none, st);
    }
    if (e == cudaSuccess) e = launch_dependent(round_c<T, G>, gv, TB, st, s);
  }
  if (e == cudaSuccess)
    e = s.flags & ARM_FATPIPE
            ? launch_cnst<T, G, RoundD<T, true>>(s, ng, le, st)
            : launch_cnst<T, G, RoundD<T, false>>(s, ng, le, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_init(Sys<T> s, int forced, int gated, int limit,
                cudaStream_t st) {
  switch (pick_group(s, forced)) {
    case 2: return launch_init_g<T, 2>(s, gated, limit, st);
    default: return launch_init_g<T, 1>(s, gated, limit, st);
  }
}

template <typename T>
int launch_round(Sys<T> s, int forced, LoopEnd le, cudaStream_t st) {
  switch (pick_group(s, forced)) {
    case 2: return launch_round_g<T, 2>(s, le, st);
    default: return launch_round_g<T, 1>(s, le, st);
  }
}

// ------------------------------------------------------------ the plan

// byte flags of the long rows (more than long_min elements) and the
// medium rows (more than short_max, at most long_min)
__global__ void plan_flags(int C, int short_max, int long_min,
                           const int* __restrict__ c_ptr, uint8_t* fl,
                           uint8_t* fm) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    int n = c_ptr[c + 1] - c_ptr[c];
    fl[c] = n > long_min;
    fm[c] = n > short_max && n <= long_min;
  }
}

// order = the long rows, then the medium rows, then the short rows,
// each class in increasing row order (the scans are stable); ncls =
// the three class sizes
__global__ void plan_scatter(int C, const uint8_t* __restrict__ fl,
                             const uint8_t* __restrict__ fm,
                             const int* __restrict__ exl,
                             const int* __restrict__ exm, const int* tot,
                             int* order, int* ncls) {
  int nL = tot[0], nM = tot[1];
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < C;
       c += gridDim.x * blockDim.x) {
    int p = fl[c] ? exl[c]
                  : fm[c] ? nL + exm[c] : nL + nM + (c - exl[c] - exm[c]);
    order[p] = c;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ncls[0] = nL;
    ncls[1] = nM;
    ncls[2] = C - nL - nM;
  }
}

}  // namespace

extern "C" {

// B replicas in one launch; s_ew, s_cb and s_vb are the per-replica
// strides of e_w, c_bound and vb (0: shared).  flags: the ARM_* bits,
// and in bits 8 and up the replicas per group when the caller forces it
// (1 or 2; 0: chosen here; any other value is refused).
int lmm_init(int dbl, int B, int V, int C, int flags, void** ptrs,
             int n_ptrs, double eps, int gated, int limit, long long s_ew,
             int s_cb, int s_vb, void* stream) {
  int arms = flags & 0xff, forced = flags >> 8;
  if (n_ptrs != N_PTRS || B < 1 || B > 65535 || forced < 0 || forced > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dbl)
    return launch_init(
        make_sys<double>(B, V, C, arms, eps, ptrs, s_ew, s_cb, s_vb),
        forced, gated, limit, st);
  return launch_init(
      make_sys<float>(B, V, C, arms, eps, ptrs, s_ew, s_cb, s_vb), forced,
      gated, limit, st);
}

// One round; cnt, tally, cap and handle: the K16 loop whose body this
// round ends (handle 0: none; the loop's condition is then read over
// the same B replicas' control words).
int lmm_round(int dbl, int B, int V, int C, int flags, void** ptrs,
              int n_ptrs, double eps, long long s_ew, int s_cb, int s_vb,
              void* cnt, void* tally, int cap, unsigned long long handle,
              void* stream) {
  int arms = flags & 0xff, forced = flags >> 8;
  if (n_ptrs != N_PTRS || B < 1 || B > 65535 || forced < 0 || forced > 2 ||
      C >= (1 << 24) || (cnt && cap < 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  LoopEnd le{(int*)cnt, (int*)tally, cap,
             (cudaGraphConditionalHandle)handle};
  if (dbl)
    return launch_round(
        make_sys<double>(B, V, C, arms, eps, ptrs, s_ew, s_cb, s_vb),
        forced, le, st);
  return launch_round(
      make_sys<float>(B, V, C, arms, eps, ptrs, s_ew, s_cb, s_vb), forced,
      le, st);
}

// The row plan of a constraint index: `order` [C] and `ncls` [3] (see
// plan_scatter).  Scratch (bytes): flags 2*C (rounded up to 16), then
// int32 exl[C] exm[C] bsum[C / 2048 + 1] tot[2].
int lmm_plan(int C, int short_max, int long_min, const void* c_ptr,
             void* order, void* ncls, void* scratch, void* stream) {
  if (C < 0 || short_max < 0 || long_min < short_max)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  uint8_t* fl = (uint8_t*)scratch;
  uint8_t* fm = fl + C;
  int* exl = (int*)(fl + ((2 * (size_t)C + 15) & ~(size_t)15));
  int* exm = exl + C;
  int* bsum = exm + C;
  int* tot = bsum + C / SCAN_TILE + 1;
  plan_flags<<<grid_for(C, TB), TB, 0, st>>>(C, short_max, long_min,
                                            (const int*)c_ptr, fl, fm);
  scan(C, fl, exl, bsum, tot, st);
  scan(C, fm, exm, bsum, tot + 1, st);
  plan_scatter<<<grid_for(C, TB), TB, 0, st>>>(C, fl, fm, exl, exm, tot,
                                              (int*)order, (int*)ncls);
  return (int)cudaGetLastError();
}

}  // extern "C"
