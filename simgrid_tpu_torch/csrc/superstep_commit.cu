// K3 superstep_commit: the control of a superstep of up to K advances.
//
// Replaces: simgrid_tpu/ops/lmm_drain.py `_superstep_program`
// (:248-531) and, through the same kernels, the commit half of
// `_fused_step_program` (:203-234).  Its tape arm replaces :423-437,
// its collective arm :332-342, :439-456 and :486-521 (K10 `dag_walk`
// takes :457-463).
// The JAX program is one lax.while_loop; here K16's graph runs it on
// the card (csrc/superstep_loop.cu: its condition node evaluates the
// JAX cond, `flag == OK && adv < k && rounds < budget && (n_live >
// stop_live || pending > 0)`, into each replica's SS_ACTIVE) around K1's
// init and rounds, K2 and the commit below, each of which gates on the
// slot's SS_ACTIVE:
//
// * superstep_reset: the loop carry (advance/round counters, flag,
//   ring length, Kahan pair) and the live count of the input; with a
//   tape, the cursor and the f64 base clock t0 the event peek adds
//   t_sum to;
//   with a collective, the Kahan pair from `coll_clk` (carried across
//   supersteps, so event dates do not depend on how advances are
//   grouped) and the count of pending activation dates;
// * superstep_commit: the loop body after the solve and the advance:
//   the Kahan clock update `y = dt - c; t' = t + y; c' = (t' - t) - y`
//   (explicit round-to-nearest intrinsics, so nothing reassociates or
//   contracts it), ring positions `n_ev + cumsum(done) - 1` in slot
//   order, the per-advance dt and event-count tables, the flag and the
//   `commit only if ok` select.  Its event arms, after the completions:
//   when K2 said the fault-tape entry fires, one tagged ring entry
//   `-(1 + slot)` at t_new, the new bound scattered into the drain's
//   c_bound and the cursor bumped; when activations fire, every flow
//   with `ready <= next_t` (read before K10 writes new dates) gets a
//   ring entry `-(1 + n_c + id)` in slot order after those, penalty 1
//   and `ready = inf`, and the pending and live counts move by their
//   number.  All of it only if ok, as JAX's `sel`;
// * superstep_finish: live elements and the packed stats vector,
//   laid out as lmm_drain.py:525-530, so the host collect is a straight
//   port and the host fetches once per superstep; with a collective,
//   the Kahan pair back into `coll_clk`.
//
// What bounds it on this card: latency.  The commit reads the V-long
// completion mask once (100 KB at 100k flows, tens of nanoseconds of
// bandwidth; with a collective the f64 `ready` row too, 800 KB); the
// rest is scalar work.  The finish reads the element list once (E x 12
// B = 15 MB at config #4, about 4.5 us).
//
// What the design does about it: the commit is a reduce-then-scan over
// tiles of COMMIT_TILE flags, two launches of a (tiles, B) grid, so the
// whole card reads the mask and no block waits on another.  `ss_count`:
// each thread loads 16 flags (one 16-byte load; 16 f64 dates in 8 with
// a collective) and the block counts the completions and the due
// activations of its tile into the Work's scratch (`commit_scan`);
// block 0 copies there what launch 2 needs and its tail overwrites (the
// ring length, the arms that fire, t_new).  `ss_write`, a programmatic
// dependent launch (its launch overlaps launch 1): a block whose tile
// holds entries adds up the counts of the tiles before it, scans its
// threads' counts in thread order and writes its entries (and the
// activations' pen and ready); the others return at once, but block 0,
// which runs the scalar tail: the Kahan clock, the fault entry and its
// bound, the dt/nev tables and the control words.  Positions are
// integer prefix sums in tile, thread and flag order: slot order, the
// order the host paths emit completions in.  No block waits on another
// block, so no grid size can deadlock it.

// The replica axis (simgrid_tpu/ops/lmm_batch.py
// `_batch_superstep_program`, :477-523: the solo superstep vmapped over
// a fleet): blockIdx.y picks the replica, whose control words, Kahan
// pair, event clock, ring row of `packed`, flow state, tape row and
// bounds move to its row (the ids are shared).  `ss_reset` takes a
// per-replica k (`k_l = where(alive, k, 0)`, :510), base clock t0 and
// tape cursor, so a dead replica's guards are false from entry and its
// state comes back unchanged; `superstep_finish` packs [B, packed_size]
// for one fetch per fleet superstep.

#include "common.cuh"

namespace {

template <typename T>
__global__ void ss_reset(int V, const T* __restrict__ pen, int* ctrl,
                         T* fctrl, int k, int budget, int stop, double* evf,
                         double t0, int tpos,
                         const double* __restrict__ ready,
                         const double* __restrict__ clk, const int* k_arr,
                         const double* t0_arr, const int* tpos_arr) {
  long long b = blockIdx.y;
  pen += b * V;
  ctrl += b * N_CTRL;
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  if (ready) ready += b * V;
  if (clk) clk += 2 * b;
  if (k_arr) k = k_arr[b];
  if (t0_arr) t0 = t0_arr[b];
  if (tpos_arr) tpos = tpos_arr[b];
  int live = 0, pend = 0;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    live += pen[v] > T(0);
    if (ready) pend += isfinite(ready[v]);
  }
  int tot = block_sum(live);
  int ptot = block_sum(pend);
  if (threadIdx.x == 0) {
    ctrl[C_SS_ACTIVE] = 0;
    ctrl[C_SS_ADV] = 0;
    ctrl[C_SS_ROUNDS] = 0;
    ctrl[C_SS_FLAG] = FLAG_OK;
    ctrl[C_SS_NEV] = 0;
    ctrl[C_SS_NLIVE] = tot;
    ctrl[C_SS_K] = k;
    ctrl[C_SS_BUDGET] = budget;
    ctrl[C_SS_STOP] = stop;
    ctrl[C_TPOS] = tpos;
    ctrl[C_PENDING] = ptot;
    ctrl[C_ADV_OK] = 0;
    fctrl[F_TSUM] = clk ? T(clk[0]) : T(0);
    fctrl[F_TCOMP] = clk ? T(clk[1]) : T(0);
    evf[EV_T0] = t0;
    evf[EV_NEXT_T] = inf_v<double>();
  }
}

// The event arms' arrays (NULL when the arm is off).
template <typename T>
struct Arms {
  const int* tape_slot;  // [T] int32 constraint slots
  const T* tape_val;     // [T] new bounds, in the drain's dtype
  int n_tape;            // T, the tape row's stride
  T* c_bound;            // [C] the drain's bounds (scattered into)
  int cb_stride;         // C, the bounds row's stride
  int n_c;
  double* ready;         // [V] f64 pending activation dates
  T* pen;                // [V] penalties (activations set 1.0)

  __device__ Arms row(long long b, int V) const {
    Arms r = *this;
    if (tape_slot) {
      r.tape_slot += b * n_tape;
      r.tape_val += b * n_tape;
      r.c_bound += b * cb_stride;
    }
    if (ready) {
      r.ready += b * V;
      r.pen += b * V;
    }
    return r;
  }
};

// flags of a block of the commit: 256 threads x 16 (csrc and
// kernels/common.py COMMIT_TILE)
#define COMMIT_TB 256
#define COMMIT_TILE (16 * COMMIT_TB)
// the scratch row of a replica (kernels/common.py COMMIT_HEAD): what
// launch 1 hands to launch 2 (the ring length before the advance, the
// arms that fire, t_new's bits), then (completions, activations) per tile
#define COMMIT_HEAD 4
#define CS_NEV 0
#define CS_FLAGS 1
#define CS_TN 2
#define CS_OK 1
#define CS_FFIRE 2
#define CS_AANY 4

__host__ __device__ __forceinline__ int commit_tiles(int V) {
  return V > COMMIT_TILE ? (V + COMMIT_TILE - 1) / COMMIT_TILE : 1;
}

// One bit per nonzero byte of x, in byte order (bit i: byte i): the
// bytes' low bits, 8 apart, gathered into the top nibble by one multiply
// whose partial products never carry into it.
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// Bit j: the flag v0 + j of the row is set (v0 + j < V), from one
// 16-byte load where the 16 flags are whole and aligned.
__device__ __forceinline__ unsigned done16(const bool* row, int v0, int V) {
  const unsigned char* p = reinterpret_cast<const unsigned char*>(row) + v0;
  if (v0 + 16 <= V && (reinterpret_cast<size_t>(p) & 15) == 0) {
    uint4 q = *reinterpret_cast<const uint4*>(p);
    return byte_bits(q.x) | byte_bits(q.y) << 4 | byte_bits(q.z) << 8 |
           byte_bits(q.w) << 12;
  }
  unsigned m = 0;
  for (int j = 0; j < 16 && v0 + j < V; ++j) m |= (unsigned)(p[j] != 0) << j;
  return m;
}

// Bit j: the activation date v0 + j is due, ready <= nt (NaN never is).
__device__ __forceinline__ unsigned due16(const double* row, int v0, int V,
                                          double nt) {
  const double* p = row + v0;
  unsigned m = 0;
  if (v0 + 16 <= V && (reinterpret_cast<size_t>(p) & 15) == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      double2 d = reinterpret_cast<const double2*>(p)[j];
      m |= (unsigned)(d.x <= nt) << (2 * j) |
           (unsigned)(d.y <= nt) << (2 * j + 1);
    }
    return m;
  }
  for (int j = 0; j < 16 && v0 + j < V; ++j) m |= (unsigned)(p[j] <= nt) << j;
  return m;
}

// The Kahan clock update `y = dt - c; t' = t + y; c' = (t' - t) - y`.
template <typename T>
__device__ __forceinline__ T kahan(T dt, T ts, T tc, T* tc2) {
  T y = sub_rn(dt, tc);
  T tn = add_rn(ts, y);
  *tc2 = sub_rn(sub_rn(tn, ts), y);
  return tn;
}

// Launch 1: the counts of each tile, and (block 0) the words launch 2
// needs that its tail overwrites.
template <typename T>
__global__ void __launch_bounds__(COMMIT_TB)
    ss_count(int V, const bool* __restrict__ done, const int* ctrl,
             const T* fctrl, const double* evf, Arms<T> arm, int* scan) {
  // the write pass may be scheduled now: it waits for this grid's end
  pdl_trigger();
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  int tiles = commit_tiles(V);
  done += b * V;
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  scan += b * (COMMIT_HEAD + 2LL * tiles);
  arm = arm.row(b, V);
  // one wave of independent loads: the gate, the flags, the words
  int v0 = blockIdx.x * COMMIT_TILE + threadIdx.x * 16;
  int go = ctrl[C_ADV_GO];
  unsigned md = done16(done, v0, V);
  T dt = fctrl[F_DT];
  bool conv = ctrl[C_ADV_CONV] != 0;
  bool aany = arm.ready && ctrl[C_AANY];
  bool head = blockIdx.x == 0 && threadIdx.x == 0;
  int n_ev = 0, ffire = 0;
  T ts = T(0), tc = T(0);
  if (head) {
    n_ev = ctrl[C_SS_NEV];
    ffire = arm.tape_slot && ctrl[C_FFIRE];
    ts = fctrl[F_TSUM];
    tc = fctrl[F_TCOMP];
  }
  if (!go) return;
  bool ok = conv && finite_v(dt);
  bool a_any = ok && aany;
  unsigned ma = a_any ? due16(arm.ready, v0, V, evf[EV_NEXT_T]) : 0u;
  int nd = block_sum(ok ? __popc(md) : 0);
  int na = block_sum(__popc(ma));
  if (threadIdx.x != 0) return;
  scan[COMMIT_HEAD + 2 * blockIdx.x] = nd;
  scan[COMMIT_HEAD + 2 * blockIdx.x + 1] = na;
  if (head) {
    T tc2;
    scan[CS_NEV] = n_ev;
    scan[CS_FLAGS] = (ok ? CS_OK : 0) | (ok && ffire ? CS_FFIRE : 0) |
                     (a_any ? CS_AANY : 0);
    *reinterpret_cast<T*>(scan + CS_TN) = kahan(dt, ts, tc, &tc2);
  }
}

// Launch 2: the ring entries of the tiles that hold any, in slot order,
// and (block 0) the scalar tail.  Besides the scratch it reads only
// C_ADV_GO and the event date, which no kernel of the commit writes;
// block 0 alone reads the words the tail writes, before writing them.
template <typename T>
__global__ void __launch_bounds__(COMMIT_TB)
    ss_write(int V, const bool* __restrict__ done,
             const int* __restrict__ ids, T* packed, int* ctrl, T* fctrl,
             int k_max, int ring_n, const double* evf, Arms<T> arm,
             const int* scan) {
  pdl_wait();
  long long b = blockIdx.y;
  ctrl += b * N_CTRL;
  int tiles = commit_tiles(V);
  scan += b * (COMMIT_HEAD + 2LL * tiles);
  done += b * V;
  int v0 = blockIdx.x * COMMIT_TILE + threadIdx.x * 16;
  // one wave of independent loads: the gate, this tile's counts and
  // flags, the words launch 1 left
  int go = ctrl[C_ADV_GO];
  int cd = scan[COMMIT_HEAD + 2 * blockIdx.x];
  int ca = scan[COMMIT_HEAD + 2 * blockIdx.x + 1];
  unsigned md = done16(done, v0, V);
  int n_ev = scan[CS_NEV];
  int flags = scan[CS_FLAGS];
  T tn = *reinterpret_cast<const T*>(scan + CS_TN);
  bool tail = blockIdx.x == 0;
  if (!go || (!tail && !(cd | ca))) return;
  packed += b * (7 + 2 * (long long)k_max + 2 * (long long)ring_n);
  fctrl += b * N_FCTRL;
  evf += b * N_EVF;
  arm = arm.row(b, V);
  if (!cd) md = 0u;
  unsigned ma = ca ? due16(arm.ready, v0, V, evf[EV_NEXT_T]) : 0u;
  // the ids of this thread's flags, in flight during the scans below
  int idv[16];
  if (md | ma) {
    if (v0 + 16 <= V && (reinterpret_cast<size_t>(ids + v0) & 15) == 0) {
      const int4* q = reinterpret_cast<const int4*>(ids + v0);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int4 x = q[j];
        idv[4 * j] = x.x;
        idv[4 * j + 1] = x.y;
        idv[4 * j + 2] = x.z;
        idv[4 * j + 3] = x.w;
      }
    } else {
      for (int j = 0; j < 16 && v0 + j < V; ++j) idv[j] = ids[v0 + j];
    }
  }
  // the entries of the tiles before this one, and of all tiles
  __shared__ int sums[4];
  if (threadIdx.x < 32) {
    int pd = 0, pa = 0, sd = 0, sa = 0;
    for (int t = threadIdx.x; t < tiles; t += 32) {
      int d = scan[COMMIT_HEAD + 2 * t], a = scan[COMMIT_HEAD + 2 * t + 1];
      sd += d;
      sa += a;
      if (t < (int)blockIdx.x) {
        pd += d;
        pa += a;
      }
    }
    pd = warp_sum(pd);
    pa = warp_sum(pa);
    sd = warp_sum(sd);
    sa = warp_sum(sa);
    if (threadIdx.x == 0) {
      sums[0] = pd;
      sums[1] = pa;
      sums[2] = sd;
      sums[3] = sa;
    }
  }
  __syncthreads();
  int n_done = sums[2], n_act = sums[3];
  bool f_fire = flags & CS_FFIRE;
  T* ring_t = packed + 7 + 2 * k_max;
  T* ring_id = ring_t + ring_n;
  if (cd | ca) {
    // both counts in one scan: each field stays under COMMIT_TILE < 2^16
    int tot;
    int ex = block_exclusive_scan(__popc(md) | __popc(ma) << 16, &tot);
    int pos = n_ev + sums[0] + (ex & 0xffff);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (md >> j & 1u) {
        ring_t[pos] = tn;
        ring_id[pos] = T(idv[j]);
        ++pos;
      }
    }
    // activations after completions and the fault entry, in slot order
    pos = n_ev + n_done + (f_fire ? 1 : 0) + sums[1] + (ex >> 16);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (ma >> j & 1u) {
        ring_t[pos] = tn;
        ring_id[pos] = T(-(1 + arm.n_c + idv[j]));
        arm.pen[v0 + j] = T(1);
        arm.ready[v0 + j] = inf_v<double>();
        ++pos;
      }
    }
  }
  if (!tail || threadIdx.x != 0) return;
  // the tail: the clock, the fault entry, the tables, the control words
  T dt = fctrl[F_DT];
  bool conv = ctrl[C_ADV_CONV] != 0;
  bool ok = flags & CS_OK;
  T tc2;
  kahan(dt, fctrl[F_TSUM], fctrl[F_TCOMP], &tc2);
  int adv = ctrl[C_SS_ADV];
  int tpos = ctrl[C_TPOS];
  int n_new = n_ev + n_done;
  if (f_fire) {
    // the fault fires after this advance's completions
    int slot = arm.tape_slot[tpos];
    ring_t[n_new] = tn;
    ring_id[n_new] = T(-(1 + slot));
    arm.c_bound[slot] = arm.tape_val[tpos];
    n_new += 1;
  }
  n_new += n_act;
  if (ok) {
    packed[7 + adv] = dt;
    packed[7 + k_max + adv] = T(n_new);
    fctrl[F_TSUM] = tn;
    fctrl[F_TCOMP] = tc2;
    ctrl[C_SS_NEV] = n_new;
    ctrl[C_SS_ADV] = adv + 1;
    ctrl[C_TPOS] = tpos + (f_fire ? 1 : 0);
    ctrl[C_PENDING] -= n_act;
  }
  ctrl[C_ADV_OK] = ok;
  ctrl[C_SS_ROUNDS] += ctrl[C_IT];
  ctrl[C_SS_FLAG] = !conv ? FLAG_BUDGET
                          : (finite_v(dt) ? FLAG_OK : FLAG_STALLED);
  ctrl[C_SS_NLIVE] = ctrl[C_LIVE_ACC] + n_act;
}

__global__ void ss_zero_le(int* ctrl) {
  ctrl[(long long)blockIdx.y * N_CTRL + C_LE_ACC] = 0;
}

template <typename T>
__global__ void ss_live_elems(int E, const int* __restrict__ e_var,
                              const T* __restrict__ e_w,
                              const T* __restrict__ pen, int* ctrl, int V,
                              long long s_ew) {
  long long b = blockIdx.y;
  e_w += b * s_ew;
  pen += b * V;
  ctrl += b * N_CTRL;
  int n = 0;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < E;
       e += gridDim.x * blockDim.x)
    n += e_w[e] > T(0) && pen[e_var[e]] > T(0);
  int tot = block_sum(n);
  if (threadIdx.x == 0 && tot) atomicAdd(ctrl + C_LE_ACC, tot);
}

template <typename T>
__global__ void ss_stats(T* packed, const int* ctrl, const T* fctrl,
                         double* clk, long long psize) {
  long long b = blockIdx.y;
  packed += b * psize;
  ctrl += b * N_CTRL;
  fctrl += b * N_FCTRL;
  if (clk) clk += 2 * b;
  if (clk) {
    clk[0] = (double)fctrl[F_TSUM];
    clk[1] = (double)fctrl[F_TCOMP];
  }
  packed[0] = T(ctrl[C_SS_ROUNDS]);
  packed[1] = T(ctrl[C_SS_ADV]);
  packed[2] = T(ctrl[C_SS_NEV]);
  packed[3] = fctrl[F_TSUM];
  packed[4] = T(ctrl[C_SS_NLIVE]);
  packed[5] = T(ctrl[C_SS_FLAG]);
  packed[6] = T(ctrl[C_LE_ACC]);
}

template <typename T>
int reset_t(int B, int V, const void* pen, void* ctrl, void* fctrl, int k,
            int budget, int stop, void* evf, double t0, int tpos,
            const void* ready, const void* clk, const void* k_arr,
            const void* t0_arr, const void* tpos_arr, cudaStream_t s) {
  ss_reset<T><<<grid_r(B), 1024, 0, s>>>(
      V, (const T*)pen, (int*)ctrl, (T*)fctrl, k, budget, stop,
      (double*)evf, t0, tpos, (const double*)ready, (const double*)clk,
      (const int*)k_arr, (const double*)t0_arr, (const int*)tpos_arr);
  return (int)cudaGetLastError();
}

template <typename T>
int commit_t(int B, int V, const void* done, const void* ids, void* packed,
             void* ctrl, void* fctrl, int k_max, int ring_n,
             const void* evf, const void* tape_slot, const void* tape_val,
             int n_tape, void* c_bound, int cb_stride, int n_c, void* ready,
             void* pen, void* scan, cudaStream_t s) {
  Arms<T> arm{(const int*)tape_slot, (const T*)tape_val, n_tape,
              (T*)c_bound, cb_stride, n_c, (double*)ready, (T*)pen};
  dim3 g(commit_tiles(V), B);
  ss_count<T><<<g, COMMIT_TB, 0, s>>>(V, (const bool*)done,
                                      (const int*)ctrl, (const T*)fctrl,
                                      (const double*)evf, arm, (int*)scan);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_dependent(ss_write<T>, g, COMMIT_TB, s, V,
                               (const bool*)done, (const int*)ids,
                               (T*)packed, (int*)ctrl, (T*)fctrl, k_max,
                               ring_n, (const double*)evf, arm,
                               (const int*)scan);
}

template <typename T>
int finish_t(int B, int E, int V, const void* e_var, const void* e_w,
             long long s_ew, const void* pen, void* packed, long long psize,
             void* ctrl, void* fctrl, void* clk, cudaStream_t s) {
  const int TB = 256;
  ss_zero_le<<<grid_r(B), 1, 0, s>>>((int*)ctrl);
  ss_live_elems<T><<<grid_b(E, TB, B), TB, 0, s>>>(
      E, (const int*)e_var, (const T*)e_w, (const T*)pen, (int*)ctrl, V,
      s_ew);
  ss_stats<T><<<grid_r(B), 1, 0, s>>>((T*)packed, (const int*)ctrl,
                                      (const T*)fctrl, (double*)clk, psize);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// B replicas in one launch each.  ready (f64 activation dates) and clk
// (the f64 Kahan pair) are NULL without a collective; k_arr, t0_arr
// and tpos_arr (per replica) are NULL for the solo scalars.
int superstep_reset(int dbl, int B, int V, const void* pen, void* ctrl,
                    void* fctrl, int k, int budget, int stop, void* evf,
                    double t0, int tpos, const void* ready, const void* clk,
                    const void* k_arr, const void* t0_arr,
                    const void* tpos_arr, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? reset_t<double>(B, V, pen, ctrl, fctrl, k, budget, stop, evf,
                               t0, tpos, ready, clk, k_arr, t0_arr, tpos_arr,
                               s)
             : reset_t<float>(B, V, pen, ctrl, fctrl, k, budget, stop, evf,
                              t0, tpos, ready, clk, k_arr, t0_arr, tpos_arr,
                              s);
}

// tape_slot/tape_val/c_bound are NULL without a tape, ready/pen without
// a collective; n_tape and cb_stride are the per-replica strides of the
// tape rows and the bounds, n_c the collective arm's ring id offset;
// scan is the Work's commit scratch, [B, COMMIT_HEAD + 2 tiles] int32.
int superstep_commit(int dbl, int B, int V, const void* done,
                     const void* ids, void* packed, void* ctrl, void* fctrl,
                     int k_max, int ring_n, const void* evf,
                     const void* tape_slot, const void* tape_val, int n_tape,
                     void* c_bound, int cb_stride, int n_c, void* ready,
                     void* pen, void* scan, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? commit_t<double>(B, V, done, ids, packed, ctrl, fctrl, k_max,
                                ring_n, evf, tape_slot, tape_val, n_tape,
                                c_bound, cb_stride, n_c, ready, pen, scan, s)
             : commit_t<float>(B, V, done, ids, packed, ctrl, fctrl, k_max,
                               ring_n, evf, tape_slot, tape_val, n_tape,
                               c_bound, cb_stride, n_c, ready, pen, scan, s);
}

// s_ew: the per-replica stride of e_w (0: shared); psize: the stride of
// one replica's packed row.
int superstep_finish(int dbl, int B, int E, int V, const void* e_var,
                     const void* e_w, long long s_ew, const void* pen,
                     void* packed, long long psize, void* ctrl, void* fctrl,
                     void* clk, void* stream) {
  if (B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dbl ? finish_t<double>(B, E, V, e_var, e_w, s_ew, pen, packed,
                                psize, ctrl, fctrl, clk, s)
             : finish_t<float>(B, E, V, e_var, e_w, s_ew, pen, packed, psize,
                               ctrl, fctrl, clk, s);
}

}  // extern "C"
