// Shared helpers of the simgrid_tpu_torch kernels (Hopper, sm_90a).
//
// Every source compiles with -fmad=false, and every floating-point
// operation that decides a result the JAX reference pins is written
// with an explicit round-to-nearest intrinsic as well, so no compiler
// setting can contract or reassociate it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// ---- control words (int32), mirrored in kernels/common.py ----
#define C_IT 0
#define C_LIGHT 1
#define C_LIGHT_ACC 2
#define C_LIMIT 3
#define C_ARMED 4
#define C_SS_ACTIVE 5
#define C_SS_ADV 6
#define C_SS_ROUNDS 7
#define C_SS_FLAG 8
#define C_SS_NEV 9
#define C_SS_NLIVE 10
#define C_SS_K 11
#define C_SS_BUDGET 12
#define C_SS_STOP 13
// slot 14 of replica 0's row: a 32-bit ticket over the replica groups
// of one launch (K1's round end, lmm_round.cu), 0 between launches
#define C_GTICKET 14
#define C_LIVE_ACC 15
#define C_ADV_GO 16
#define C_ADV_CONV 17
#define C_LE_ACC 18
#define C_VLIVE 19
#define C_VLIVE_ACC 20
#define C_HALF 21
#define C_OVERFLOW 22
#define C_NFIXED_ACC 23
#define C_TPOS 24
#define C_FIRE 25
#define C_FFIRE 26
#define C_AANY 27
#define C_PENDING 28
#define C_ADV_OK 29
// slots 30-31: one 64-bit ticket (last_block below), 0 between launches
#define C_TICKET 30
// low_v rows of K7's running round (ell_round.cu), 0 between rounds
#define C_NLOW 32

// an even count, so that every replica's ticket is 8-byte aligned
#define N_CTRL 34

// ---- fctrl (dtype) slots ----
#define N_FCTRL 4
#define F_TSUM 0
#define F_TCOMP 1
#define F_DT 2

// ---- evf (float64) slots: the superstep's event clock ----
#define N_EVF 2
#define EV_T0 0
#define EV_NEXT_T 1

#define MAX_ROUNDS 100000
#define FLAG_OK 0
#define FLAG_STALLED 1
#define FLAG_BUDGET 2

#define FULL_MASK 0xffffffffu

template <typename T> __device__ __forceinline__ T inf_v();
template <> __device__ __forceinline__ double inf_v<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}
template <> __device__ __forceinline__ float inf_v<float>() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// f64 -> T with round to nearest (a jnp `.astype` of an f64 value)
template <typename T> __device__ __forceinline__ T from_f64(double x);
template <> __device__ __forceinline__ double from_f64<double>(double x) { return x; }
template <> __device__ __forceinline__ float from_f64<float>(double x) { return __double2float_rn(x); }

__device__ __forceinline__ bool finite_v(double x) { return isfinite(x); }
__device__ __forceinline__ bool finite_v(float x) { return isfinite(x); }

// min that keeps the first operand on ties (values here are never NaN)
template <typename T>
__device__ __forceinline__ T min_v(T a, T b) { return b < a ? b : a; }

// Order-preserving key of a NON-NEGATIVE float for unsigned atomicMin.
__device__ __forceinline__ unsigned long long key_of(double x) {
  return (unsigned long long)__double_as_longlong(x);
}
__device__ __forceinline__ unsigned long long key_of(float x) {
  return (unsigned long long)__float_as_uint(x);
}
template <typename T> __device__ __forceinline__ T from_key(unsigned long long k);
template <> __device__ __forceinline__ double from_key<double>(unsigned long long k) {
  return __longlong_as_double((long long)k);
}
template <> __device__ __forceinline__ float from_key<float>(unsigned long long k) {
  return __uint_as_float((unsigned int)k);
}

// max that keeps the first operand on ties (values here are never NaN)
template <typename T>
__device__ __forceinline__ T max_v(T a, T b) { return b > a ? b : a; }

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = 16; o > 0; o >>= 1) v = min_v(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = max_v(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// Min of one NON-NEGATIVE value per thread over the block, folded into
// the global minimum *bits with one atomicMin (exact: IEEE order of
// non-negative floats is the integer order of their bits).  +inf, the
// identity, is never written.  blockDim.x must be a multiple of 32.
template <typename T>
__device__ __forceinline__ void block_min_to(T m, unsigned long long* bits) {
  __shared__ unsigned long long wmin[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  m = warp_min(m);
  if (lane == 0) wmin[wid] = key_of(m);
  __syncthreads();
  if (wid == 0) {
    int nw = blockDim.x >> 5;
    T x = lane < nw ? from_key<T>(wmin[lane]) : inf_v<T>();
    x = warp_min(x);
    if (lane == 0 && x < inf_v<T>()) atomicMin(bits, key_of(x));
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Sum of one int per thread over the block; valid in thread 0.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_tot[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) warp_tot[wid] = v;
  __syncthreads();
  int nw = blockDim.x >> 5;
  int t = 0;
  if (wid == 0) {
    t = lane < nw ? warp_tot[lane] : 0;
    t = warp_sum(t);
  }
  return t;
}

// Exclusive prefix sum of one int per thread over the block, in thread
// order; *total receives the block total (all threads).
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_tot[32];
  __shared__ int tot;
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  __syncthreads();
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int nw = blockDim.x >> 5;
    int w = lane < nw ? warp_tot[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < nw) warp_tot[lane] = wi - w;
    if (lane == 31) tot = wi;
  }
  __syncthreads();
  int ex = warp_tot[wid] + incl - v;
  *total = tot;
  __syncthreads();
  return ex;
}

// Left fold of the 32 lanes' values into `acc`, in lane order, as a
// sequential loop adds them (every lane returns the same value).  Lanes
// holding exactly 0.0 are skipped: adding 0.0 to a non-negative partial
// sum is an exact no-op.  Values must be non-negative.
template <typename T>
__device__ __forceinline__ T warp_fold_into(T acc, T x) {
  unsigned m = __ballot_sync(FULL_MASK, x != T(0));
  while (m) {
    int l = __ffs(m) - 1;
    m &= m - 1;
    acc = add_rn(acc, __shfl_sync(FULL_MASK, x, l));
  }
  return acc;
}

// XLA:CPU's order for the sum of one row of a [R, W] table along W
// (`x.sum(axis=1)` in the JAX package): a row of at most 32 lanes is
// folded left to right from 0.0; a wider one is padded with zeros to a
// multiple of 32, `row_low(W)` of them on the left, each window of 32
// lanes is folded left to right from 0.0, then the window partials are
// folded left to right (XLA's tree reduction; at most 16 windows under
// the ELL width cap of 512, so one level).  The caller holds the row's
// values 32 lanes at a time from lane -row_low(W) and adds each
// window's `warp_block_sum` into its total with add_rn.
template <typename T>
__device__ __forceinline__ T warp_block_sum(T x) {
  return warp_fold_into(T(0), x);
}

// The zeros XLA pads a row of W lanes with on the left before its
// windows of 32 (kernels/ell_round.py `fold_rows`).
__host__ __device__ __forceinline__ int row_low(int W) {
  return W <= 32 ? 0 : ((W + 31) / 32 * 32 - W) / 2;
}

static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Blocks for a grid-stride loop over `items` work items of `per_block`
// items each, capped at 8 resident blocks per SM.
static inline int grid_for(long long items, int per_block) {
  long long b = (items + per_block - 1) / per_block;
  long long cap = 8LL * sm_count();
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return (int)b;
}

// The grid of a kernel with a replica axis: blockIdx.y picks the
// replica (B of them), blockIdx.x runs `grid_for`'s grid-stride loop
// with the cap shared among the replicas.  B = 1 is the solo grid.
static inline dim3 grid_b(long long items, int per_block, int B) {
  int g = grid_for(items, per_block);
  int cap = (8 * sm_count()) / (B > 0 ? B : 1);
  if (cap < 1) cap = 1;
  if (g > cap) g = cap;
  return dim3(g, B);
}

// The last block of a launch to finish, per replica.  Every block of the
// replica's grid row calls it once, with all its threads, after its own
// writes; `add` (thread 0's) is summed over the blocks into *sum.  One
// 64-bit atomic a block: the high word counts the blocks in, the low
// word sums `add` (the caller keeps the total under 2^32).  It returns
// true in the block that came in last, and that block has reset the
// ticket to 0 for the next launch; its reads of what the other blocks
// wrote must bypass L1 (__ldcg, or an atomic).
__device__ __forceinline__ bool last_block(unsigned long long* ticket,
                                           unsigned add, unsigned* sum) {
  __shared__ bool last;
  __shared__ unsigned tot;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long old = atomicAdd(ticket, (1ULL << 32) | add);
    last = (unsigned)(old >> 32) == gridDim.x - 1;
    tot = (unsigned)old + add;
    if (last) *ticket = 0ULL;
  }
  __syncthreads();
  if (last) __threadfence();
  *sum = tot;
  return last;
}

__device__ __forceinline__ unsigned long long* ticket_of(int* ctrl) {
  return reinterpret_cast<unsigned long long*>(ctrl + C_TICKET);
}

// Where a kernel ends a K16 loop body (superstep_loop.cu, `Loop(...,
// ends=True)`): the loop's count word (NULL: no cap), its tally word,
// its cap and the WHILE node's handle (0: not in such a loop).
struct LoopEnd {
  int* cnt;
  int* tally;
  int cap;
  cudaGraphConditionalHandle h;
};

// What loop_cond does as the body's last node, from one thread of the
// kernel that ends the body: count the iteration into the tally and the
// cap's word, and let the WHILE node run again when `go` holds and the
// cap is not reached.
__device__ __forceinline__ void end_iteration(const LoopEnd& le, bool go) {
  if (le.tally) *le.tally += 1;
  if (le.cnt) {
    int n = *le.cnt + 1;
    *le.cnt = n;
    go = go && n < le.cap;
  }
  cudaGraphSetConditional(le.h, go ? 1u : 0u);
}

// Programmatic dependent launch (Hopper): a kernel launched by
// `launch_dependent` may be scheduled while the kernel before it in the
// stream still runs, once every block of that kernel has called
// `pdl_trigger`; it must call `pdl_wait` before it touches memory that
// kernel reads or writes (the wait returns when that kernel has
// finished and its writes are visible).  It hides the second kernel's
// launch latency behind the first.  Both are no-ops for a kernel
// launched plainly.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... Params, typename... Args>
static inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                                    int threads, cudaStream_t s,
                                    Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

// One single-thread (or single-block) launch per replica.
static inline dim3 grid_r(int B) { return dim3(1, B); }
