// Bounded-variable primal simplex, one LP per thread-block cluster with
// its whole tableau in the cluster's shared memory, every pivot inside
// one launch.
//
// Replaces the Pallas TPU kernel bensolve_tpu/lp/pallas_simplex.py::_kernel
// (launched by _solve_batch_pallas_jit).  It computes what that kernel
// computes for a group of one LP: starting from a shared tableau W0
// (E = [I | -A] cold, or B^-1 E of a shared warm basis), a composite
// phase-1 bounded-variable primal simplex runs to termination with devex
// scores d^2/gamma, Bland's rule after BLAND_AFTER degenerate steps, a
// carried phase-2 reduced-cost row d2 that is rank-1 updated (a full
// pricing pass only while the LP is infeasible or when k % 128 == 0),
// a ratio test with bound flips and the largest-|pivot| tie-break, and
// a rank-1 update of W.  Tolerances are the kernel's own (TOL_BND =
// TOL_DJ = 1e-5, TOL_PIV = 1e-6), +-inf arrive encoded as +-1e30.
// Primal and dual recovery runs outside (simplex._final_solutions).
//
// Three variants, chosen by shape alone (group_simplex.plan in Python):
//
// * group_simplex_cluster_kernel, the main one.  The Pallas kernel keeps a
//   group's tableau in VMEM for every pivot; here an LP's (Mp, NT) tableau
//   lives in the shared memory of a cluster of C CTAs of 384 threads.  CTA
//   k owns the columns [k*S, (k+1)*S), S = NT/C, all Mp rows (row stride
//   S + 4, so a column read touches 8 banks, not 1), and the
//   column-indexed vectors of its slice (c, lb, ub, d, d2, gamma, the
//   scaled pivot row, in_basis, at_upper).  The row-indexed vectors (xb,
//   lbB, ubB, cB, the ratios, basis) are replicated: every CTA runs the
//   feasibility check, the ratio test and the xb/basis updates itself on
//   identical data and gets identical results.  Pricing (d_j = sum_i W_ij
//   cbe_i), the rank-1 update and the d2/gamma updates touch only the
//   CTA's own columns.  Per pivot the cluster exchanges two things, each
//   by remote stores into the receivers' shared memory (st.async) that
//   complete on an mbarrier in the receiver, which waits on it locally:
//   every warp's best (score, index) under the rule in force, 16 bytes to
//   every CTA, which then merge the entries themselves (lowest index on
//   ties); and the entering column alpha = W[:, q] with q's values, sent
//   by the CTA that owns q.  Both live in two buffers used on alternate
//   steps; a CTA writes a buffer of another only after receiving that
//   CTA's entries of the step before, which it sends after its last read
//   of the buffer, so the loop needs no cluster barrier.
//   C is the smallest of 1, 2, 4, 8, 16 whose per-CTA bytes
//   (cluster_smem_bytes) fit the 232,448 B a block may use; 16 needs the
//   non-portable cluster size.  Example10's P2 shape (Mp = 384, NT = 768,
//   f32) takes C = 8 at ~177 KB per CTA, the small examples C = 1.
//   Concurrency: one cluster per LP (grid = B*C CTAs), the simpler of the
//   two choices: the hardware starts the next LP's cluster wherever one
//   finishes, which balances LPs of unequal length without the
//   bookkeeping of persistent clusters, and a launch stays one per batch.
// * group_simplex_spill_kernel, for tableaux a 16-CTA cluster does not
//   hold (f32, from about 3 MB; the Pallas kernel keeps them in VMEM up to
//   about 6 MB).  The same code as the cluster kernel (cluster_body with
//   kSpill set) at C = 16, with a row split: rows [0, Ms) of a CTA's slice
//   stay in shared memory, rows [Ms, Mp) live in a global spill workspace,
//   one (Mp - Ms, S) region per CTA and LP, row stride S.  Ms is the
//   largest multiple of 4 that fits beside the vectors and a ring of
//   kStages 16-byte slots per thread.  Every per-pivot loop is the cluster
//   kernel's with the same thread-to-element map and summation order; only
//   where row i lives differs, so moving rows to the workspace changes no
//   pivot.  The pricing pass, the initial d2 sum and the rank-1 update
//   stream a thread's spilled quads (the rows of its row group, in
//   increasing order) through its ring by cp.async, kStages - 1 copies in
//   flight, the first ones issued before the thread walks its
//   shared-memory rows, so their update overlaps the loads; the rank-1
//   update writes each spilled quad back with st.global.cg.  A thread
//   reads and writes only its own spilled quads in those loops, so the
//   stream needs no barrier; the other readers of the workspace (the
//   initial xb sum, the pivot row, and the owner's gather of the entering
//   column's spilled entries into shared memory before it sends alpha)
//   read it after a block barrier, with ld.global.cg (no stale L1 line).
//   Only the live clusters (about 8 of 16 CTAs on 132 SMs) touch their
//   regions, 0.4-3 MB each at the band's shapes, so the workspace the
//   card works on stays inside its 50 MB L2.
// * group_simplex_kernel, for shapes neither of the above takes (rows or
//   slices not in fours, or row vectors that do not fit beside a slice):
//   the first port's design, W in a global-memory workspace, one CTA of
//   256 threads per LP.
//
// What bounds the cluster kernel on the H100.  Against the f32 roofline
// (every input read and output written once through HBM; 2 Mp NT flop for
// each rank-1 update and each pricing pass at 67 TFLOP/s) the work is
// operation-bound at ~6 ms for 256 LPs of the example10 shape, but one
// step of one LP is ~0.6 MFLOP spread over 8 SMs, so a step is a chain of
// short dependent phases: on-chip shared-memory traffic (the rank-1 update
// reads and writes the 147 KB slice once, ~1.3 us at 128 B per clock per
// SM), the latency of the two exchanges through distributed shared
// memory, and ~6 block barriers.  What the design does about the first
// port's limits: the tableau never goes through L2/HBM after the initial
// load (one coalesced 16-byte load per element, no per-LP copy of W0
// written to HBM), and every per-pivot loop is spread over all threads:
// the rank-1 update walks the slice in 16-byte vectors with the pivot row
// in registers and four rows' loads in flight, the pricing pass and the
// initial d2 sum each column over interleaved row groups and then add the
// partials in group order, the initial xb = -W zn sums each row by one
// warp and the CTAs' partial sums in rank order, and the ratio test gives
// each thread one row and one division.  Block reductions take one
// barrier each (redux.sync on order-preserving keys of the floats).  At
// Mp <= 32 the column sums stay sequential over the rows, so small LPs
// take the plain version's exact pivots.
//
// What bounds the spill kernel.  The same operation count as the cluster
// kernel's, but each rank-1 update also reads and writes, and each
// pricing pass reads, the (Mp - Ms) x S spilled rows of every CTA through
// L2: at (768, 1536) about 118 KB per CTA, 1.9 MB per LP and pivot each
// way.  One SM keeps about 18 KB in flight through its ring (Little's
// law: ~23 B per clock at ~800 cycles of L2 latency), so a pivot's spill
// traffic costs a few microseconds per CTA where the shared-memory rows
// cost about one; the first port's design streamed the whole tableau
// through one SM (7-9 MB per pivot at these shapes).  The work is a
// rank-1 update and a matrix-vector product: nothing in it is a matrix
// product, so neither kernel uses the tensor cores (wgmma).
//
// Arithmetic is IEEE with explicit round-to-nearest intrinsics for the
// products and sums (no contraction into FMA), so the kernel's pivot
// decisions follow the plain PyTorch version closely.  Reductions
// reproduce jnp.argmax: on ties the lowest index wins.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kRunning = 0;
constexpr int kOptimal = 1;
constexpr int kInfeasible = 2;
constexpr int kUnbounded = 3;
constexpr int kItlim = 4;
constexpr int kBlandAfter = 64;
constexpr int kThreadsGlobal = 256;   // block of the global-memory variant
constexpr int kThreads = 384;         // CTA of the cluster variant
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 4;        // extra columns per row of a shared W slice
// returned by the cluster launch when no cluster of that size fits the card
constexpr int kNoClusterFits = -2;
constexpr int kSpillC = 16;    // CTAs per cluster of the spill variant
constexpr int kStages = 4;     // 16-byte ring slots per thread of the spill variant

template <typename T>
struct Ar;

template <>
struct Ar<float> {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }
  static __device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
};

template <>
struct Ar<double> {
  static __device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ double neg_inf() { return __longlong_as_double(0xfff0000000000000ULL); }
  static __device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7ff0000000000000ULL); }
};

// Four consecutive elements, loaded and stored as one vector.
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

template <typename T>
__device__ __forceinline__ void argmax_merge(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmax(T& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, v2, i2);
  }
}

// Block-wide argmax over (value, index) pairs; the lowest index wins ties.
template <typename T>
__device__ void block_argmax(T& v, int& i, T* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : Ar<T>::neg_inf();
    i = lane < nwarps ? si[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      sv[0] = v;
      si[0] = i;
    }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

template <typename T>
__device__ T block_min(T v, T* sv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_down_sync(0xffffffffu, v, off);
    v = v2 < v ? v2 : v;
  }
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : Ar<T>::pos_inf();
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      T v2 = __shfl_down_sync(0xffffffffu, v, off);
      v = v2 < v ? v2 : v;
    }
    if (lane == 0) sv[0] = v;
  }
  __syncthreads();
  v = sv[0];
  __syncthreads();
  return v;
}

// The float's bits mapped to an unsigned key with the same order (-0 as
// +0, so keys are equal exactly where the floats compare equal; never
// called on NaN), and back.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned m) {
  return __uint_as_float((m & 0x80000000u) ? (m ^ 0x80000000u) : ~m);
}

// Warp-wide argmax (lowest index on ties) and minimum, the result in
// every lane: one redux.sync per step for float, shuffles otherwise.
template <typename T>
__device__ __forceinline__ void warp_argmax_all(T& v, int& i) {
  warp_argmax(v, i);
  v = __shfl_sync(0xffffffffu, v, 0);
  i = __shfl_sync(0xffffffffu, i, 0);
}
template <>
__device__ __forceinline__ void warp_argmax_all<float>(float& v, int& i) {
  const unsigned key = order_key(v);
  const unsigned m = __reduce_max_sync(0xffffffffu, key);
  i = __reduce_min_sync(0xffffffffu, key == m ? i : INT_MAX);
  v = from_key(m);
}
template <typename T>
__device__ __forceinline__ T warp_min_all(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_xor_sync(0xffffffffu, v, off);
    v = v2 < v ? v2 : v;
  }
  return v;
}
template <>
__device__ __forceinline__ float warp_min_all<float>(float v) {
  return from_key(__reduce_min_sync(0xffffffffu, order_key(v)));
}

// Block-wide reductions in one barrier: each warp reduces, lane 0 posts
// the warp's result, and after the barrier every warp reduces the posted
// results again, so every thread holds the block's result (the (value,
// lowest index) maximum does not depend on the order).  The scratch must
// not be reused before another barrier has passed.

// Two argmaxes and an OR (sv: 64 T, si: 96 int).
template <typename T>
__device__ void block_argmax2(T& v1, int& i1, T& v2, int& i2, int& flag, T* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool posted = lane < (int)(blockDim.x >> 5);
  warp_argmax_all(v1, i1);
  warp_argmax_all(v2, i2);
  flag = __any_sync(0xffffffffu, flag);
  if (lane == 0) {
    sv[warp] = v1;
    sv[32 + warp] = v2;
    si[warp] = i1;
    si[32 + warp] = i2;
    si[64 + warp] = flag;
  }
  __syncthreads();
  v1 = posted ? sv[lane] : Ar<T>::neg_inf();
  i1 = posted ? si[lane] : INT_MAX;
  v2 = posted ? sv[32 + lane] : Ar<T>::neg_inf();
  i2 = posted ? si[32 + lane] : INT_MAX;
  flag = __any_sync(0xffffffffu, posted && si[64 + lane]);
  warp_argmax_all(v1, i1);
  warp_argmax_all(v2, i2);
}

// The minimum (sv: 32 T).
template <typename T>
__device__ T block_min1(T v, T* sv) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool posted = lane < (int)(blockDim.x >> 5);
  v = warp_min_all(v);
  if (lane == 0) sv[warp] = v;
  __syncthreads();
  return warp_min_all(posted ? sv[lane] : Ar<T>::pos_inf());
}

// Point-to-point signalling inside a cluster.  A CTA that expects data
// arms its own mbarrier with the byte count; senders write into its
// shared memory with st.async, each store completing its bytes on that
// mbarrier; the receiver's threads wait for the phase to complete.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t remote_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of the given parity; a wait that never ends is a
// fault in the exchange, so it traps (the launch fails) instead of
// spinning forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 22)) __trap();
  }
}
// 16 bytes into CTA-shared address `dst` of another CTA, completing on
// its mbarrier at `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async16(uint32_t dst, uint32_t bar, uint4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

// x - a * w, elementwise, rounded as the plain version rounds it.
template <typename T>
__device__ __forceinline__ Quad<T> rank1(Quad<T> x, T a, const Quad<T>& w) {
  using A = Ar<T>;
  x.v[0] = A::sub(x.v[0], A::mul(a, w.v[0]));
  x.v[1] = A::sub(x.v[1], A::mul(a, w.v[1]));
  x.v[2] = A::sub(x.v[2], A::mul(a, w.v[2]));
  x.v[3] = A::sub(x.v[3], A::mul(a, w.v[3]));
  return x;
}

// Asynchronous 16-byte copy from global into shared memory (L2 only),
// and its groups: commit the copies issued so far as one group; wait
// until at most N groups of this thread are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A quad of the spill workspace, moved in 16-byte pieces that bypass
// L1: stored (st.global.cg), or copied into shared memory (cp.async).
template <typename T>
__device__ __forceinline__ void stcg_quad(Quad<T>* p, const Quad<T>& q) {
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Quad<T>) / 16); ++k) {
    uint4 u;
    memcpy(&u, reinterpret_cast<const unsigned char*>(&q) + 16 * k, 16);
    __stcg(reinterpret_cast<uint4*>(p) + k, u);
  }
}
template <typename T>
__device__ __forceinline__ void cp_async_quad(Quad<T>* dst, const Quad<T>* src) {
#pragma unroll
  for (int k = 0; k < (int)(sizeof(Quad<T>) / 16); ++k)
    cp_async16(reinterpret_cast<unsigned char*>(dst) + 16 * k,
               reinterpret_cast<const unsigned char*>(src) + 16 * k);
}

// The spilled quads of one thread in one column group j4: the rows
// i0, i0 + step, ... < M of its row group that lie at or past Ms, in
// increasing order.  begin() issues the first kStages - 1 copies into the
// thread's ring (slot s at ring[s * kThreads + tid]) and returns, so the
// thread can work on its shared-memory rows while they fly; walk(fn)
// keeps kStages - 1 copies ahead and hands each quad to fn(i, x) once it
// has landed.  Only this thread touches these quads and slots.
template <typename T>
struct SpillWalk {
  const Quad<T>* src;   // the walk's first quad in the workspace
  size_t stride;        // quads from one row of the walk to the next
  Quad<T>* slot;
  int i0, step, n;

  // sp4: the CTA's region (row stride S4 quads, row Ms first); first: the
  // thread's first row in any part of the tableau
  __device__ __forceinline__ void init(const Quad<T>* sp4, int S4, Quad<T>* ring, int Ms, int M,
                                       int first, int rstep, int j4) {
    i0 = first < Ms ? first + ((Ms - first + rstep - 1) / rstep) * rstep : first;
    step = rstep;
    n = i0 < M ? (M - 1 - i0) / rstep + 1 : 0;
    src = sp4 + (size_t)(i0 - Ms) * S4 + j4;
    stride = (size_t)rstep * S4;
    slot = ring + threadIdx.x;
  }
  // copy t of the walk (an empty group past its end, so the count of
  // groups in flight stays the same)
  __device__ __forceinline__ void issue(int t) {
    if (t < n) cp_async_quad(slot + (t % kStages) * kThreads, src + (size_t)t * stride);
    cp_async_commit();
  }
  __device__ __forceinline__ void begin() {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) issue(t);
  }
  template <typename F>
  __device__ __forceinline__ void walk(F fn) {
    for (int t = 0; t < n; ++t) {
      issue(t + kStages - 1);
      cp_async_wait<kStages - 1>();   // copy t has landed
      fn(i0 + t * step, slot[(t % kStages) * kThreads]);
    }
  }
};

// acc_j = sum_i W[i][j] * w[i] for the S columns of a CTA's slice, handed
// to fin(j, acc): rows [0, Ms) from the shared slice W (row stride LD),
// rows [Ms, M) (kSpill only) from the spill region sp4 through the ring.
// Each column is summed over Rp interleaved row groups (rows g, g + Rp,
// ...), each group in increasing row order, whose partials are then added
// in group order; at M <= 32, Rp = 1 and each column is one sequential
// sum over the rows.  Ends with a barrier.
template <typename T, bool kSpill, typename F>
__device__ __forceinline__ void column_sums(const T* W, const T* w, T* part, int M, int Ms, int S,
                                            int LD, const Quad<T>* sp4, Quad<T>* ring, F fin) {
  using A = Ar<T>;
  const int S4 = S / 4;
  const int LD4 = LD / 4;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int CW = S4 < nth ? S4 : nth;
  const int Rp = M <= 32 ? 1 : nth / CW;
  const int cl = tid % CW;
  const int rl = tid / CW;
  const Quad<T>* W4 = reinterpret_cast<const Quad<T>*>(W);
  if (rl < Rp) {
    for (int j4 = cl; j4 < S4; j4 += CW) {
      T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
      SpillWalk<T> sw;
      if constexpr (kSpill) {
        sw.init(sp4, S4, ring, Ms, M, rl, Rp, j4);
        sw.begin();
      }
      for (int i = rl; i < Ms; i += Rp) {
        const Quad<T> q = W4[(size_t)i * LD4 + j4];
        const T wi = w[i];
        a0 = A::add(a0, A::mul(q.v[0], wi));
        a1 = A::add(a1, A::mul(q.v[1], wi));
        a2 = A::add(a2, A::mul(q.v[2], wi));
        a3 = A::add(a3, A::mul(q.v[3], wi));
      }
      if constexpr (kSpill) {
        sw.walk([&](int i, const Quad<T>& q) {
          const T wi = w[i];
          a0 = A::add(a0, A::mul(q.v[0], wi));
          a1 = A::add(a1, A::mul(q.v[1], wi));
          a2 = A::add(a2, A::mul(q.v[2], wi));
          a3 = A::add(a3, A::mul(q.v[3], wi));
        });
      }
      if (Rp == 1) {
        fin(4 * j4, a0);
        fin(4 * j4 + 1, a1);
        fin(4 * j4 + 2, a2);
        fin(4 * j4 + 3, a3);
      } else {
        T* p = part + (size_t)rl * S + 4 * j4;
        p[0] = a0;
        p[1] = a1;
        p[2] = a2;
        p[3] = a3;
      }
    }
  }
  if (Rp > 1) {
    __syncthreads();
    for (int j = tid; j < S; j += nth) {
      T acc = part[j];
      for (int g = 1; g < Rp; ++g) acc = A::add(acc, part[(size_t)g * S + j]);
      fin(j, acc);
    }
  }
  __syncthreads();
}

// Dynamic shared memory of the global-memory variant (W not included).
template <typename T>
__host__ __device__ size_t smem_bytes(int M, int NT) {
  return (7 * (size_t)NT + 7 * (size_t)M) * sizeof(T) + (size_t)M * sizeof(int) +
         2 * (size_t)NT;
}

// Dynamic shared memory of one CTA of a C-CTA cluster that keeps rows
// [0, Ms) of its slice in shared memory (Ms = M: the cluster variant):
// the (Ms, S + kPad) slice of W; where rows are spilled (Ms < M), the
// ring of kStages 16-byte slots per thread; four mbarriers; two buffers of
// exchange entries (16 bytes for each warp of the cluster) and of the
// entering column's values (64 bytes); two column buffers of M; seven
// column vectors of the slice; six replicated row vectors; the pricing
// partials; three reduction scratches; basis; in_basis and at_upper.
template <typename T>
__host__ __device__ size_t cluster_smem_bytes(int M, int NT, int C, int Ms) {
  const size_t S = (size_t)(NT / C);
  const size_t LD = S + kPad;
  const size_t nT = (size_t)Ms * LD + 2 * (size_t)M + 7 * S + 6 * (size_t)M +
                    4 * (size_t)kThreads + 3 * 64;
  const size_t ring = Ms < M ? (size_t)kStages * kThreads * sizeof(Quad<T>) : 0;
  const size_t nI = (size_t)M + 3 * 96;
  return nT * sizeof(T) + ring + 4 * 8 + 2 * (size_t)C * kWarps * 16 + 2 * 64 +
         nI * sizeof(int) + 2 * S;
}

template <typename T>
__global__ void __launch_bounds__(kThreadsGlobal)
group_simplex_kernel(const T* __restrict__ W0, const T* __restrict__ c_g,
                     const T* __restrict__ lb_g, const T* __restrict__ ub_g,
                     const int32_t* __restrict__ basis0,
                     const uint8_t* __restrict__ at_upper0, T* __restrict__ Wws,
                     int32_t* __restrict__ status_out, int32_t* __restrict__ basis_out,
                     uint8_t* __restrict__ at_upper_out, int32_t* __restrict__ iters_out,
                     int M, int NT, int max_iter, long long max_loop) {
  using A = Ar<T>;
  const T TOL_BND = T(1e-5);
  const T TOL_DJ = T(1e-5);
  const T TOL_PIV = T(1e-6);
  const T BIG = T(1e30);
  const T TIE = T(1e-12);
  const T ZERO = T(0);
  const T ONE = T(1);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* c = reinterpret_cast<T*>(smem_raw);
  T* lb = c + NT;
  T* ub = lb + NT;
  T* d = ub + NT;
  T* d2 = d + NT;
  T* gamma = d2 + NT;
  T* wrs = gamma + NT;
  T* xb = wrs + NT;
  T* lbB = xb + M;
  T* ubB = lbB + M;
  T* cB = ubB + M;
  T* alpha = cB + M;
  T* cbe = alpha + M;
  T* tt = cbe + M;
  int* basis = reinterpret_cast<int*>(tt + M);
  uint8_t* in_basis = reinterpret_cast<uint8_t*>(basis + M);
  uint8_t* at_upper = in_basis + NT;
  __shared__ T red_v[32];
  __shared__ int red_i[32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  T* W = Wws + (size_t)b * M * NT;

  auto lo_of = [&](int j) -> T {
    const bool lbf = lb[j] > -BIG, ubf = ub[j] < BIG;
    return lbf ? lb[j] : (ubf ? ub[j] : ZERO);
  };
  auto hi_of = [&](int j) -> T {
    const bool lbf = lb[j] > -BIG, ubf = ub[j] < BIG;
    return ubf ? ub[j] : (lbf ? lb[j] : ZERO);
  };

  // ---- initial state -------------------------------------------------
  for (int j = tid; j < NT; j += nth) {
    c[j] = c_g[(size_t)b * NT + j];
    lb[j] = lb_g[(size_t)b * NT + j];
    ub[j] = ub_g[(size_t)b * NT + j];
    gamma[j] = ONE;
    in_basis[j] = 0;
  }
  for (size_t e = tid; e < (size_t)M * NT; e += nth) W[e] = W0[e];
  __syncthreads();
  for (int i = tid; i < M; i += nth) {
    basis[i] = basis0[i];
    in_basis[basis0[i]] = 1;
  }
  __syncthreads();
  int crossed = 0;
  for (int j = tid; j < NT; j += nth) {
    at_upper[j] = (at_upper0[(size_t)b * NT + j] && !in_basis[j]) ? 1 : 0;
    crossed |= lb[j] > ub[j];
  }
  for (int i = tid; i < M; i += nth) {
    lbB[i] = lb[basis[i]];
    ubB[i] = ub[basis[i]];
    cB[i] = c[basis[i]];
  }
  crossed = __syncthreads_or(crossed);
  // xb = -W zn, one warp per row
  for (int i = warp; i < M; i += nwarps) {
    T acc = ZERO;
    for (int j = lane; j < NT; j += 32) {
      const T zn = in_basis[j] ? ZERO : (at_upper[j] ? hi_of(j) : lo_of(j));
      acc = A::add(acc, A::mul(W[(size_t)i * NT + j], zn));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = A::add(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) xb[i] = -acc;
  }
  // carried phase-2 row d2 = c - cB W
  for (int j = tid; j < NT; j += nth) {
    T acc = ZERO;
    for (int i = 0; i < M; ++i) acc = A::add(acc, A::mul(W[(size_t)i * NT + j], cB[i]));
    d2[j] = A::sub(c[j], acc);
  }
  __syncthreads();

  int status = crossed ? kInfeasible : kRunning;
  int stall = 0;
  int it = 0;
  long long k = 0;
  while (status == kRunning && k < max_loop) {
    // ---- feasibility and pricing --------------------------------------
    int viol = 0;
    for (int i = tid; i < M; i += nth)
      viol |= (xb[i] < A::sub(lbB[i], TOL_BND)) || (xb[i] > A::add(ubB[i], TOL_BND));
    const bool feasible = !__syncthreads_or(viol);
    const bool run_pass = !feasible || (k % 128 == 0);
    if (run_pass) {
      for (int i = tid; i < M; i += nth) {
        const bool vlo = xb[i] < A::sub(lbB[i], TOL_BND);
        const bool vup = xb[i] > A::add(ubB[i], TOL_BND);
        cbe[i] = feasible ? cB[i] : A::add(vup ? ONE : ZERO, vlo ? -ONE : ZERO);
      }
      __syncthreads();
      for (int j = tid; j < NT; j += nth) {
        T acc = ZERO;
        for (int i = 0; i < M; ++i) acc = A::add(acc, A::mul(W[(size_t)i * NT + j], cbe[i]));
        d[j] = A::sub(feasible ? c[j] : ZERO, acc);
        if (feasible) d2[j] = d[j];
      }
    } else {
      for (int j = tid; j < NT; j += nth) d[j] = d2[j];
    }

    // ---- entering variable (devex, Bland after a stall) ----------------
    T best = A::neg_inf();
    int best_i = INT_MAX;
    T bbest = A::neg_inf();
    int bbest_i = INT_MAX;
    int any_elig = 0;
    for (int j = tid; j < NT; j += nth) {
      const T v = at_upper[j] ? hi_of(j) : lo_of(j);
      const bool nb = !in_basis[j];
      const bool ei = nb && v < ub[j] && d[j] < -TOL_DJ;
      const bool ed = nb && v > lb[j] && d[j] > TOL_DJ;
      const bool el = ei || ed;
      argmax_merge(best, best_i, el ? A::div(A::mul(d[j], d[j]), gamma[j]) : -BIG, j);
      argmax_merge(bbest, bbest_i, el ? -T(j) : -BIG, j);
      any_elig |= el;
    }
    block_argmax(best, best_i, red_v, red_i);
    block_argmax(bbest, bbest_i, red_v, red_i);
    const bool has_entering = __syncthreads_or(any_elig);
    const bool use_bland = stall > kBlandAfter;
    const int q = use_bland ? bbest_i : best_i;

    const T val_q = at_upper[q] ? hi_of(q) : lo_of(q);
    const bool elig_inc_q = !in_basis[q] && val_q < ub[q] && d[q] < -TOL_DJ;
    const T sigma = elig_inc_q ? ONE : -ONE;
    for (int i = tid; i < M; i += nth) alpha[i] = W[(size_t)i * NT + q];
    __syncthreads();

    // ---- ratio test -----------------------------------------------------
    T tmin = A::pos_inf();
    for (int i = tid; i < M; i += nth) {
      const T rate = A::mul(-sigma, alpha[i]);
      const bool vlo = xb[i] < A::sub(lbB[i], TOL_BND);
      const bool vup = xb[i] > A::add(ubB[i], TOL_BND);
      const T target_inc = vlo ? lbB[i] : ubB[i];
      const T target_dec = vup ? ubB[i] : lbB[i];
      const T t_inc = vup ? BIG : A::div(A::sub(target_inc, xb[i]), rate);
      const T t_dec = vlo ? BIG : A::div(A::sub(target_dec, xb[i]), rate);
      T t = rate > TOL_PIV ? t_inc : (rate < -TOL_PIV ? t_dec : BIG);
      t = t > ZERO ? t : ZERO;   // clip to [0, BIG]
      t = t < BIG ? t : BIG;
      tt[i] = t;
      tmin = t < tmin ? t : tmin;
    }
    tmin = block_min(tmin, red_v);
    const T cut = A::add(tmin, TIE);
    T sbest = A::neg_inf();
    int sbest_i = INT_MAX;
    T lbest = A::neg_inf();
    int lbest_i = INT_MAX;
    for (int i = tid; i < M; i += nth) {
      const bool cand = tt[i] <= cut;
      const T rate = A::mul(-sigma, alpha[i]);
      argmax_merge(sbest, sbest_i, cand ? (rate < ZERO ? -rate : rate) : -ONE, i);
      argmax_merge(lbest, lbest_i, cand ? -T(basis[i]) : -BIG, i);
    }
    block_argmax(sbest, sbest_i, red_v, red_i);
    block_argmax(lbest, lbest_i, red_v, red_i);
    const int r = use_bland ? lbest_i : sbest_i;

    // ---- step, bound flip, status (identical in every thread) ----------
    const T lb_q = lb[q] > -BIG ? lb[q] : -BIG;
    const T ub_q = ub[q] < BIG ? ub[q] : BIG;
    const T span = A::sub(ub_q, lb_q);
    const bool do_flip = span < tmin;
    const T t_star = do_flip ? span : tmin;
    const int finish = feasible ? kOptimal : kInfeasible;
    const bool unbounded = has_entering && feasible && t_star >= BIG;
    const int stat_next =
        !has_entering ? finish
                      : (unbounded ? kUnbounded : (it + 1 >= max_iter ? kItlim : kRunning));
    const bool act = has_entering && t_star < BIG;
    const T delta = act ? A::mul(sigma, t_star) : ZERO;
    const bool do_pivot = act && !do_flip;
    T alpha_r = alpha[r];
    if ((alpha_r < ZERO ? -alpha_r : alpha_r) < TOL_PIV) alpha_r = alpha_r < ZERO ? -TOL_PIV : TOL_PIV;
    const int leaving = basis[r];
    const T xq_new = A::add(val_q, delta);
    const T rate_r = A::mul(-sigma, alpha[r]);
    const bool vlo_r = xb[r] < A::sub(lbB[r], TOL_BND);
    const bool vup_r = xb[r] > A::add(ubB[r], TOL_BND);
    const bool leave_at_upper = rate_r > ZERO ? !vlo_r : vup_r;
    const bool q_at_upper = at_upper[q] != 0;
    const T d2_q = d2[q];
    const T gamma_q = gamma[q];
    const T c_q = c[q];
    const T g_leave_raw = A::div(gamma_q, A::mul(alpha_r, alpha_r));
    const T g_leave = g_leave_raw > ONE ? g_leave_raw : ONE;
    __syncthreads();   // every thread has read the pre-pivot state

    // ---- updates ----------------------------------------------------------
    for (int i = tid; i < M; i += nth) xb[i] = A::sub(xb[i], A::mul(delta, alpha[i]));
    if (do_pivot) {
      const T* wr = W + (size_t)r * NT;
      for (int j = tid; j < NT; j += nth) wrs[j] = A::div(wr[j], alpha_r);
      __syncthreads();
      for (int i = 0; i < M; ++i) {
        T* row = W + (size_t)i * NT;
        if (i == r) {
          for (int j = tid; j < NT; j += nth) row[j] = wrs[j];
        } else {
          const T a = alpha[i];
          for (int j = tid; j < NT; j += nth) row[j] = A::sub(row[j], A::mul(a, wrs[j]));
        }
      }
      for (int j = tid; j < NT; j += nth) {
        d2[j] = A::sub(d2[j], A::mul(d2_q, wrs[j]));
        const T gu = A::mul(A::mul(wrs[j], wrs[j]), gamma_q);
        T g = gamma[j] > gu ? gamma[j] : gu;
        if (j == leaving) g = g_leave;
        gamma[j] = g > T(1e8) ? ONE : g;
      }
      if (tid == 0) {
        xb[r] = xq_new;
        basis[r] = q;
        lbB[r] = lb_q;
        ubB[r] = ub_q;
        cB[r] = c_q;
        in_basis[q] = 1;
        in_basis[leaving] = 0;
        at_upper[leaving] = leave_at_upper ? 1 : 0;
      }
    } else if (act && do_flip && tid == 0) {
      at_upper[q] = q_at_upper ? 0 : 1;
    }
    const bool degen = act && t_star < TOL_BND;
    stall = act ? (degen ? stall + 1 : 0) : stall;
    it += act ? 1 : 0;
    status = stat_next;
    ++k;
    __syncthreads();
  }
  if (status == kRunning) status = kItlim;

  for (int i = tid; i < M; i += nth) basis_out[(size_t)b * M + i] = basis[i];
  for (int j = tid; j < NT; j += nth) at_upper_out[(size_t)b * NT + j] = at_upper[j];
  if (tid == 0) {
    status_out[b] = status;
    iters_out[b] = it;
  }
}

// One LP per cluster of C CTAs (see the note at the top): the body of the
// cluster kernel (kSpill false, Ms = M) and of the spill kernel (kSpill
// true: rows [Ms, M) of each slice in the workspace Wsp).  work_out, when
// not null, receives per LP (loop steps, pricing passes, rank-1 updates)
// for the roofline count of the caller.
template <typename T, bool kSpill>
__device__ __forceinline__ void cluster_body(
    const T* __restrict__ W0, const T* __restrict__ c_g, const T* __restrict__ lb_g,
    const T* __restrict__ ub_g, const int32_t* __restrict__ basis0,
    const uint8_t* __restrict__ at_upper0, int32_t* __restrict__ status_out,
    int32_t* __restrict__ basis_out, uint8_t* __restrict__ at_upper_out,
    int32_t* __restrict__ iters_out, int32_t* __restrict__ work_out, T* Wsp, int M, int Ms_arg,
    int NT, int max_iter, long long max_loop) {
  using A = Ar<T>;
  const T TOL_BND = T(1e-5);
  const T TOL_DJ = T(1e-5);
  const T TOL_PIV = T(1e-6);
  const T BIG = T(1e30);
  const T TIE = T(1e-12);
  const T ZERO = T(0);
  const T ONE = T(1);

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int S = NT / C;        // columns of this CTA's slice
  const int LD = S + kPad;     // row stride of the slice in shared memory
  const int S4 = S / 4;
  const int LD4 = LD / 4;
  const int j0 = rank * S;     // first column of the slice
  const int nX = C * kWarps;   // exchange entries: one per warp of the cluster
  const int Ms = kSpill ? Ms_arg : M;   // rows of the slice in shared memory

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* W = reinterpret_cast<T*>(smem_raw);
  // the spill variant's ring of kStages 16-byte slots per thread
  Quad<T>* ring = reinterpret_cast<Quad<T>*>(W + (size_t)Ms * LD);
  // mbar[0..1]: the exchange of step parity 0/1; mbar[2..3]: the column
  uint64_t* mbar =
      reinterpret_cast<uint64_t*>(ring + (kSpill && Ms < M ? kStages * kThreads : 0));
  // exchange entries, 16 bytes each, two buffers: (score, index, any
  // eligible) from every warp of the cluster
  uint4* xch = reinterpret_cast<uint4*>(mbar + 4);
  // the entering column's values, two buffers of 64 bytes: d, d2, gamma,
  // c, lb, ub as T from byte 0, at_upper and in_basis as ints at 48, 52
  uint4* qbuf = xch + 2 * nX;
  // the entering column alpha, two buffers of M
  T* abuf = reinterpret_cast<T*>(qbuf + 8);
  T* wrs = abuf + 2 * (size_t)M;
  T* c = wrs + S;
  T* lb = c + S;
  T* ub = lb + S;
  T* d = ub + S;
  T* d2 = d + S;
  T* gamma = d2 + S;
  T* xb = gamma + S;
  T* lbB = xb + M;
  T* ubB = lbB + M;
  T* cB = ubB + M;
  T* cbe = cB + M;
  T* tt = cbe + M;   // ratios; before the loop, this CTA's share of W zn
  T* part = tt + M;
  T* red_v = part + 4 * kThreads;
  int* basis = reinterpret_cast<int*>(red_v + 3 * 64);
  int* red_i = basis + M;
  uint8_t* in_basis = reinterpret_cast<uint8_t*>(red_i + 3 * 96);
  uint8_t* at_upper = in_basis + S;

  const int tid = threadIdx.x;
  const int nth = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nth >> 5;
  // 16-byte lanes of the slice: column group cl, row group rl of R
  const int CW = S4 < nth ? S4 : nth;
  const int R = nth / CW;
  const int cl = tid % CW;
  const int rl = tid / CW;
  Quad<T>* W4 = reinterpret_cast<Quad<T>*>(W);
  const size_t ob = (size_t)b * NT;
  // this CTA's spill region: rows [Ms, M) of the slice, row stride S
  T* sp = kSpill ? Wsp + ((size_t)b * C + rank) * (size_t)(M - Ms) * S : nullptr;
  Quad<T>* sp4 = reinterpret_cast<Quad<T>*>(sp);
  // W[i][jl] of the slice, wherever row i lives
  auto w_at = [&](int i, int jl) -> T {
    if (kSpill && i >= Ms) return __ldcg(sp + (size_t)(i - Ms) * S + jl);
    return W[(size_t)i * LD + jl];
  };

  auto lo_of = [&](int jl) -> T {
    const bool lbf = lb[jl] > -BIG, ubf = ub[jl] < BIG;
    return lbf ? lb[jl] : (ubf ? ub[jl] : ZERO);
  };
  auto hi_of = [&](int jl) -> T {
    const bool lbf = lb[jl] > -BIG, ubf = ub[jl] < BIG;
    return ubf ? ub[jl] : (lbf ? lb[jl] : ZERO);
  };
  auto owns = [&](int j) -> bool { return j >= j0 && j < j0 + S; };

  // ---- initial state -------------------------------------------------
  if (tid == 0) {
    for (int m = 0; m < 4; ++m) mbar_init(mbar + m);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int jl = tid; jl < S; jl += nth) {
    c[jl] = c_g[ob + j0 + jl];
    lb[jl] = lb_g[ob + j0 + jl];
    ub[jl] = ub_g[ob + j0 + jl];
    gamma[jl] = ONE;
    in_basis[jl] = 0;
  }
  // the slice of W0, read once from L2/HBM in 16-byte vectors; rows past
  // Ms copied into the spill region
  for (int u = tid; u < Ms * S4; u += nth) {
    const int i = u / S4;
    const int j4 = u - i * S4;
    W4[(size_t)i * LD4 + j4] = reinterpret_cast<const Quad<T>*>(W0 + (size_t)i * NT + j0)[j4];
  }
  if constexpr (kSpill) {
    for (int u = tid; u < (M - Ms) * S4; u += nth) {
      const int i = Ms + u / S4;
      const int j4 = u - (i - Ms) * S4;
      stcg_quad(sp4 + u, reinterpret_cast<const Quad<T>*>(W0 + (size_t)i * NT + j0)[j4]);
    }
  }
  __syncthreads();
  for (int i = tid; i < M; i += nth) {
    const int bi = basis0[i];
    basis[i] = bi;
    if (owns(bi)) in_basis[bi - j0] = 1;
    lbB[i] = lb_g[ob + bi];
    ubB[i] = ub_g[ob + bi];
    cB[i] = c_g[ob + bi];
  }
  int crossed = 0;
  for (int j = tid; j < NT; j += nth) crossed |= lb_g[ob + j] > ub_g[ob + j];
  crossed = __syncthreads_or(crossed);
  for (int jl = tid; jl < S; jl += nth)
    at_upper[jl] = (at_upper0[ob + j0 + jl] && !in_basis[jl]) ? 1 : 0;
  __syncthreads();
  // this slice's share of W zn, one warp per row; xb = -(sum of the
  // CTAs' shares in rank order)
  for (int i = warp; i < M; i += nwarps) {
    T acc = ZERO;
    for (int jl = lane; jl < S; jl += 32) {
      const T zn = in_basis[jl] ? ZERO : (at_upper[jl] ? hi_of(jl) : lo_of(jl));
      acc = A::add(acc, A::mul(w_at(i, jl), zn));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc = A::add(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) tt[i] = acc;
  }
  cluster.sync();   // the shares and every CTA's mbarriers are ready
  for (int i = tid; i < M; i += nth) {
    T acc = *cluster.map_shared_rank(tt + i, 0);
    for (int k2 = 1; k2 < C; ++k2) acc = A::add(acc, *cluster.map_shared_rank(tt + i, k2));
    xb[i] = -acc;
  }
  // carried phase-2 row d2 = c - cB W
  column_sums<T, kSpill>(W, cB, part, M, Ms, S, LD, sp4, ring,
                         [&](int jl, T acc) { d2[jl] = A::sub(c[jl], acc); });

  int status = crossed ? kInfeasible : kRunning;
  int stall = 0;
  int it = 0;
  long long k = 0;
  int n_pass = 0;
  int n_pivot = 0;
  // feasibility of xb, from here on checked where each step updates it
  int viol = 0;
  for (int i = tid; i < M; i += nth)
    viol |= (xb[i] < A::sub(lbB[i], TOL_BND)) || (xb[i] > A::add(ubB[i], TOL_BND));
  bool feasible = !__syncthreads_or(viol);
  // Step k uses buffer k & 1 of the exchange and of the column, and waits
  // for phase parity (k >> 1) & 1 of their mbarriers.  A CTA writes into
  // buffer k & 1 of another only after it has received that CTA's
  // exchange of step k - 1, which the other sends after finishing step
  // k - 2, the last to read the buffer: the data flow alone keeps writes
  // off buffers still in use, and the loop needs no cluster barrier.
  const uint32_t mbar_c = smem_addr(mbar);
  const uint32_t xch_c = smem_addr(xch);
  const uint32_t qbuf_c = smem_addr(qbuf);
  const uint32_t abuf_c = smem_addr(abuf);
  while (status == kRunning && k < max_loop) {
    const int bf = (int)(k & 1);
    const uint32_t parity = (uint32_t)((k >> 1) & 1);
    if (tid == 0) {
      mbar_expect(mbar + bf, (uint32_t)(nX * 16));
      mbar_expect(mbar + 2 + bf, (uint32_t)(M * sizeof(T) + 64));
    }
    // ---- pricing -------------------------------------------------------
    const bool run_pass = !feasible || (k % 128 == 0);
    if (run_pass) {
      for (int i = tid; i < M; i += nth) {
        const bool vlo = xb[i] < A::sub(lbB[i], TOL_BND);
        const bool vup = xb[i] > A::add(ubB[i], TOL_BND);
        cbe[i] = feasible ? cB[i] : A::add(vup ? ONE : ZERO, vlo ? -ONE : ZERO);
      }
      __syncthreads();
      column_sums<T, kSpill>(W, cbe, part, M, Ms, S, LD, sp4, ring, [&](int jl, T acc) {
        const T dj = A::sub(feasible ? c[jl] : ZERO, acc);
        d[jl] = dj;
        if (feasible) d2[jl] = dj;
      });
      ++n_pass;
    } else {
      for (int jl = tid; jl < S; jl += nth) d[jl] = d2[jl];
    }

    // ---- entering variable (devex, Bland after a stall) ----------------
    // each warp's best column under the rule in force goes to every CTA
    const bool use_bland = stall > kBlandAfter;
    T best = A::neg_inf();
    int best_i = INT_MAX;
    int any_elig = 0;
    for (int jl = tid; jl < S; jl += nth) {
      const int j = j0 + jl;
      const T v = at_upper[jl] ? hi_of(jl) : lo_of(jl);
      const bool nb = !in_basis[jl];
      const bool ei = nb && v < ub[jl] && d[jl] < -TOL_DJ;
      const bool ed = nb && v > lb[jl] && d[jl] > TOL_DJ;
      const bool el = ei || ed;
      const T score = use_bland ? -T(j) : A::div(A::mul(d[jl], d[jl]), gamma[jl]);
      argmax_merge(best, best_i, el ? score : -BIG, j);
      any_elig |= el;
    }
    warp_argmax_all(best, best_i);
    any_elig = __any_sync(0xffffffffu, any_elig);
    if (lane < C) {
      uint4 e = make_uint4(0u, 0u, (uint32_t)best_i, (uint32_t)any_elig);
      memcpy(&e, &best, sizeof(T));   // the score in the first 4 or 8 bytes
      const uint32_t off = (uint32_t)((bf * nX + rank * kWarps + warp) * 16);
      st_async16(remote_addr(xch_c + off, lane), remote_addr(mbar_c + 8u * bf, lane), e);
    }
    mbar_wait(mbar + bf, parity);
    // every warp merges the cluster's entries from local memory
    bool has_entering;
    int q;
    {
      T v1 = A::neg_inf();
      int i1 = INT_MAX, e = 0;
      for (int x = lane; x < nX; x += 32) {
        const uint4 en = xch[bf * nX + x];
        T v;
        memcpy(&v, &en, sizeof(T));
        argmax_merge(v1, i1, v, (int)en.z);
        e |= (int)en.w;
      }
      warp_argmax_all(v1, i1);
      has_entering = __any_sync(0xffffffffu, e) != 0;
      q = i1;
    }

    // ---- the entering column, sent by the CTA that owns it ---------------
    const int owner = q / S;
    const int lq = q - owner * S;
    if (rank == owner) {
      if constexpr (kSpill) {
        // the column's spilled entries, gathered in one parallel pass into
        // cbe (free from the end of this step's pricing pass to the start
        // of the next one's, past the ratio test's barriers; tt is not:
        // the ratio test writes it while the last sends may still read)
        if (Ms < M) {
          for (int i = Ms + tid; i < M; i += nth) cbe[i] = __ldcg(sp + (size_t)(i - Ms) * S + lq);
          __syncthreads();
        }
      }
      // 16 bytes of consecutive rows of column q per store, to each CTA
      constexpr int kRows = 16 / sizeof(T);
      const int MQ = M / kRows;
      for (int u = tid; u < MQ * C; u += nth) {
        const int iq = u % MQ;
        const int dst = u / MQ;
        T rows[kRows];
#pragma unroll
        for (int v = 0; v < kRows; ++v) {
          const int i = kRows * iq + v;
          rows[v] = (kSpill && i >= Ms) ? cbe[i] : W[(size_t)i * LD + lq];
        }
        uint4 w4;
        memcpy(&w4, rows, 16);
        st_async16(remote_addr(abuf_c + (uint32_t)((bf * M + kRows * iq) * sizeof(T)), dst),
                   remote_addr(mbar_c + 8u * (2 + bf), dst), w4);
      }
      if (warp == nwarps - 1 && lane < C) {
        uint4 pk[4] = {};
        T vals[6] = {d[lq], d2[lq], gamma[lq], c[lq], lb[lq], ub[lq]};
        memcpy(pk, vals, sizeof(vals));
        pk[3].x = at_upper[lq];
        pk[3].y = in_basis[lq];
        for (int v = 0; v < 4; ++v)
          st_async16(remote_addr(qbuf_c + (uint32_t)((bf * 4 + v) * 16), lane),
                     remote_addr(mbar_c + 8u * (2 + bf), lane), pk[v]);
      }
    }
    mbar_wait(mbar + 2 + bf, parity);
    const T* alpha = abuf + (size_t)bf * M;
    T qvals[6];
    memcpy(qvals, qbuf + bf * 4, sizeof(qvals));
    const T d_q = qvals[0];
    const T d2_q = qvals[1];
    const T gamma_q = qvals[2];
    const T c_q = qvals[3];
    const T lbq_raw = qvals[4];
    const T ubq_raw = qvals[5];
    const bool q_at_upper = qbuf[bf * 4 + 3].x != 0;
    const bool q_in_basis = qbuf[bf * 4 + 3].y != 0;
    const bool lbf_q = lbq_raw > -BIG, ubf_q = ubq_raw < BIG;
    const T lo_q = lbf_q ? lbq_raw : (ubf_q ? ubq_raw : ZERO);
    const T hi_q = ubf_q ? ubq_raw : (lbf_q ? lbq_raw : ZERO);
    const T val_q = q_at_upper ? hi_q : lo_q;
    const bool elig_inc_q = !q_in_basis && val_q < ubq_raw && d_q < -TOL_DJ;
    const T sigma = elig_inc_q ? ONE : -ONE;

    // ---- ratio test (replicated: identical in every CTA) -----------------
    T tmin = A::pos_inf();
    for (int i = tid; i < M; i += nth) {
      const T rate = A::mul(-sigma, alpha[i]);
      const bool vlo = xb[i] < A::sub(lbB[i], TOL_BND);
      const bool vup = xb[i] > A::add(ubB[i], TOL_BND);
      // only the division the sign of the rate selects
      T t = BIG;
      if (rate > TOL_PIV) {
        if (!vup) t = A::div(A::sub(vlo ? lbB[i] : ubB[i], xb[i]), rate);
      } else if (rate < -TOL_PIV) {
        if (!vlo) t = A::div(A::sub(vup ? ubB[i] : lbB[i], xb[i]), rate);
      }
      t = t > ZERO ? t : ZERO;   // clip to [0, BIG]
      t = t < BIG ? t : BIG;
      tt[i] = t;
      tmin = t < tmin ? t : tmin;
    }
    tmin = block_min1(tmin, red_v + 64);
    const T cut = A::add(tmin, TIE);
    T sbest = A::neg_inf();
    int sbest_i = INT_MAX;
    T lbest = A::neg_inf();
    int lbest_i = INT_MAX;
    for (int i = tid; i < M; i += nth) {
      const bool cand = tt[i] <= cut;
      const T rate = A::mul(-sigma, alpha[i]);
      argmax_merge(sbest, sbest_i, cand ? (rate < ZERO ? -rate : rate) : -ONE, i);
      argmax_merge(lbest, lbest_i, cand ? -T(basis[i]) : -BIG, i);
    }
    int unused = 0;
    block_argmax2(sbest, sbest_i, lbest, lbest_i, unused, red_v + 128, red_i + 96);
    const int r = use_bland ? lbest_i : sbest_i;

    // ---- step, bound flip, status (identical in every thread) ----------
    const T lb_q = lbf_q ? lbq_raw : -BIG;
    const T ub_q = ubf_q ? ubq_raw : BIG;
    const T span = A::sub(ub_q, lb_q);
    const bool do_flip = span < tmin;
    const T t_star = do_flip ? span : tmin;
    const int finish = feasible ? kOptimal : kInfeasible;
    const bool unbounded = has_entering && feasible && t_star >= BIG;
    const int stat_next =
        !has_entering ? finish
                      : (unbounded ? kUnbounded : (it + 1 >= max_iter ? kItlim : kRunning));
    const bool act = has_entering && t_star < BIG;
    const T delta = act ? A::mul(sigma, t_star) : ZERO;
    const bool do_pivot = act && !do_flip;
    T alpha_r = alpha[r];
    if ((alpha_r < ZERO ? -alpha_r : alpha_r) < TOL_PIV) alpha_r = alpha_r < ZERO ? -TOL_PIV : TOL_PIV;
    const int leaving = basis[r];
    const T xq_new = A::add(val_q, delta);
    const T rate_r = A::mul(-sigma, alpha[r]);
    const bool vlo_r = xb[r] < A::sub(lbB[r], TOL_BND);
    const bool vup_r = xb[r] > A::add(ubB[r], TOL_BND);
    const bool leave_at_upper = rate_r > ZERO ? !vlo_r : vup_r;
    const T g_leave_raw = A::div(gamma_q, A::mul(alpha_r, alpha_r));
    const T g_leave = g_leave_raw > ONE ? g_leave_raw : ONE;
    // the scaled pivot row, read before anyone writes row r
    if (do_pivot)
      for (int jl = tid; jl < S; jl += nth) wrs[jl] = A::div(w_at(r, jl), alpha_r);
    __syncthreads();   // every thread has read the pre-pivot state

    // ---- updates ----------------------------------------------------------
    // each thread updates its own rows, the leaving row included, and
    // checks them against their bounds for the next step
    viol = 0;
    for (int i = tid; i < M; i += nth) {
      T x = A::sub(xb[i], A::mul(delta, alpha[i]));
      if (do_pivot && i == r) {
        x = xq_new;
        basis[i] = q;
        lbB[i] = lb_q;
        ubB[i] = ub_q;
        cB[i] = c_q;
      }
      xb[i] = x;
      viol |= (x < A::sub(lbB[i], TOL_BND)) || (x > A::add(ubB[i], TOL_BND));
    }
    if (do_pivot) {
      // W_ij -= alpha_i * wrs_j, row r := wrs; each thread keeps its four
      // columns of wrs in registers and walks every R-th row, four rows'
      // loads in flight at a time, then its spilled rows through its ring
      if (rl < R) {
        const Quad<T>* wrs4 = reinterpret_cast<const Quad<T>*>(wrs);
        for (int j4 = cl; j4 < S4; j4 += CW) {
          const Quad<T> w = wrs4[j4];
          SpillWalk<T> sw;
          if constexpr (kSpill) {
            sw.init(sp4, S4, ring, Ms, M, rl, R, j4);
            sw.begin();
          }
          int i = rl;
          for (; i + 3 * R < Ms; i += 4 * R) {
            Quad<T> x[4];
            T a[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              x[u] = W4[(size_t)(i + u * R) * LD4 + j4];
              a[u] = alpha[i + u * R];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int iu = i + u * R;
              W4[(size_t)iu * LD4 + j4] = iu == r ? w : rank1(x[u], a[u], w);
            }
          }
          for (; i < Ms; i += R) {
            const Quad<T> x = W4[(size_t)i * LD4 + j4];
            W4[(size_t)i * LD4 + j4] = i == r ? w : rank1(x, alpha[i], w);
          }
          if constexpr (kSpill) {
            sw.walk([&](int iu, const Quad<T>& x) {
              stcg_quad(sp4 + (size_t)(iu - Ms) * S4 + j4, iu == r ? w : rank1(x, alpha[iu], w));
            });
          }
        }
      }
      for (int jl = tid; jl < S; jl += nth) {
        d2[jl] = A::sub(d2[jl], A::mul(d2_q, wrs[jl]));
        const T gu = A::mul(A::mul(wrs[jl], wrs[jl]), gamma_q);
        T g = gamma[jl] > gu ? gamma[jl] : gu;
        if (j0 + jl == leaving) g = g_leave;
        gamma[jl] = g > T(1e8) ? ONE : g;
      }
      if (tid == 0) {
        if (owns(q)) in_basis[q - j0] = 1;
        if (owns(leaving)) {
          in_basis[leaving - j0] = 0;
          at_upper[leaving - j0] = leave_at_upper ? 1 : 0;
        }
      }
      ++n_pivot;
    } else if (act && do_flip && tid == 0 && owns(q)) {
      at_upper[q - j0] = q_at_upper ? 0 : 1;
    }
    const bool degen = act && t_star < TOL_BND;
    stall = act ? (degen ? stall + 1 : 0) : stall;
    it += act ? 1 : 0;
    status = stat_next;
    ++k;
    feasible = !__syncthreads_or(viol);
  }
  if (status == kRunning) status = kItlim;

  for (int jl = tid; jl < S; jl += nth) at_upper_out[ob + j0 + jl] = at_upper[jl];
  if (rank == 0) {
    for (int i = tid; i < M; i += nth) basis_out[(size_t)b * M + i] = basis[i];
    if (tid == 0) {
      status_out[b] = status;
      iters_out[b] = it;
      if (work_out != nullptr) {
        work_out[3 * b] = (int32_t)k;
        work_out[3 * b + 1] = n_pass;
        work_out[3 * b + 2] = n_pivot;
      }
    }
  }
  cluster.sync();   // no CTA leaves while another may still read its shared memory
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
group_simplex_cluster_kernel(const T* __restrict__ W0, const T* __restrict__ c_g,
                             const T* __restrict__ lb_g, const T* __restrict__ ub_g,
                             const int32_t* __restrict__ basis0,
                             const uint8_t* __restrict__ at_upper0,
                             int32_t* __restrict__ status_out, int32_t* __restrict__ basis_out,
                             uint8_t* __restrict__ at_upper_out, int32_t* __restrict__ iters_out,
                             int32_t* __restrict__ work_out, int M, int NT, int max_iter,
                             long long max_loop) {
  cluster_body<T, false>(W0, c_g, lb_g, ub_g, basis0, at_upper0, status_out, basis_out,
                         at_upper_out, iters_out, work_out, nullptr, M, M, NT, max_iter,
                         max_loop);
}

// The spill variant: C = kSpillC, rows [Ms, M) of each slice in Wsp, a
// (B, kSpillC, M - Ms, NT / kSpillC) workspace.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
group_simplex_spill_kernel(const T* __restrict__ W0, const T* __restrict__ c_g,
                           const T* __restrict__ lb_g, const T* __restrict__ ub_g,
                           const int32_t* __restrict__ basis0,
                           const uint8_t* __restrict__ at_upper0, T* Wsp,
                           int32_t* __restrict__ status_out, int32_t* __restrict__ basis_out,
                           uint8_t* __restrict__ at_upper_out, int32_t* __restrict__ iters_out,
                           int32_t* __restrict__ work_out, int M, int Ms, int NT, int max_iter,
                           long long max_loop) {
  cluster_body<T, true>(W0, c_g, lb_g, ub_g, basis0, at_upper0, status_out, basis_out,
                        at_upper_out, iters_out, work_out, Wsp, M, Ms, NT, max_iter, max_loop);
}

// The launch configuration of a cluster kernel (attributes set): B
// clusters of C CTAs with smem bytes of dynamic shared memory each.
template <typename K>
cudaError_t cluster_config(K kern, size_t smem, int B, int C, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)((B > 0 ? B : 1) * C), 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// cudaOccupancyMaxActiveClusters of a configured cluster kernel into
// *out; the CUDA error (0 on success).
template <typename K>
int max_active(K kern, size_t smem, int C, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(kern, smem, 1, C, nullptr, &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one CTA needs (float32): of a C-CTA
// cluster for C >= 1 that keeps `rows` rows of its slice in shared memory
// (rows = M: the cluster variant; rows < M: the spill variant), of the
// global-memory variant for C == 0 (rows ignored).
size_t group_simplex_smem_bytes_f32(int M, int NT, int C, int rows) {
  return C == 0 ? smem_bytes<float>(M, NT) : cluster_smem_bytes<float>(M, NT, C, rows);
}

// cudaOccupancyMaxActiveClusters for C-CTA clusters of the cluster
// kernel at this shape, into *out.  Returns the CUDA error (0 on success).
int group_simplex_max_active_clusters_f32(int M, int NT, int C, int* out) {
  return max_active(group_simplex_cluster_kernel<float>,
                    cluster_smem_bytes<float>(M, NT, C, M), C, out);
}

// The same for the spill kernel keeping `rows` rows in shared memory.
int group_simplex_spill_max_active_clusters_f32(int M, int NT, int rows, int* out) {
  return max_active(group_simplex_spill_kernel<float>,
                    cluster_smem_bytes<float>(M, NT, kSpillC, rows), kSpillC, out);
}

// Launch one C-CTA cluster per LP on ``stream``.  Returns 0 on success,
// kNoClusterFits (-2) when cudaOccupancyMaxActiveClusters reports 0, else
// the CUDA error of the set-up or of cudaGetLastError() after the launch;
// the launch is asynchronous.  work may be null.
int group_simplex_cluster_f32(const void* W0, const void* c, const void* lb, const void* ub,
                              const void* basis0, const void* at_upper0, void* status,
                              void* basis, void* at_upper, void* iters, void* work, int B,
                              int M, int NT, int C, int max_iter, long long max_loop,
                              void* stream) {
  auto kern = group_simplex_cluster_kernel<float>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(kern, cluster_smem_bytes<float>(M, NT, C, M), B, C,
                                   static_cast<cudaStream_t>(stream), &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return kNoClusterFits;
  if (B > 0) {
    err = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const float*>(W0), static_cast<const float*>(c),
        static_cast<const float*>(lb), static_cast<const float*>(ub),
        static_cast<const int32_t*>(basis0), static_cast<const uint8_t*>(at_upper0),
        static_cast<int32_t*>(status), static_cast<int32_t*>(basis),
        static_cast<uint8_t*>(at_upper), static_cast<int32_t*>(iters),
        static_cast<int32_t*>(work), M, NT, max_iter, max_loop);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Launch the spill variant, one kSpillC-CTA cluster per LP keeping `rows`
// rows of each slice in shared memory, on ``stream``; Wsp is a
// (B, M - rows, NT) float32 workspace (any valid pointer when rows == M).
// Returns as group_simplex_cluster_f32.
int group_simplex_spill_f32(const void* W0, const void* c, const void* lb, const void* ub,
                            const void* basis0, const void* at_upper0, void* Wsp, void* status,
                            void* basis, void* at_upper, void* iters, void* work, int B, int M,
                            int NT, int rows, int max_iter, long long max_loop, void* stream) {
  auto kern = group_simplex_spill_kernel<float>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config(kern, cluster_smem_bytes<float>(M, NT, kSpillC, rows), B,
                                   kSpillC, static_cast<cudaStream_t>(stream), &cfg, attr);
  if (err != cudaSuccess) return (int)err;
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return kNoClusterFits;
  if (B > 0) {
    err = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const float*>(W0), static_cast<const float*>(c),
        static_cast<const float*>(lb), static_cast<const float*>(ub),
        static_cast<const int32_t*>(basis0), static_cast<const uint8_t*>(at_upper0),
        static_cast<float*>(Wsp), static_cast<int32_t*>(status), static_cast<int32_t*>(basis),
        static_cast<uint8_t*>(at_upper), static_cast<int32_t*>(iters),
        static_cast<int32_t*>(work), M, rows, NT, max_iter, max_loop);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Launch the global-memory variant, one block per LP, on ``stream``;
// Wws is a (B, M, NT) workspace.  Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous.
int group_simplex_global_f32(const void* W0, const void* c, const void* lb, const void* ub,
                             const void* basis0, const void* at_upper0, void* Wws, void* status,
                             void* basis, void* at_upper, void* iters, int B, int M, int NT,
                             int max_iter, long long max_loop, void* stream) {
  const size_t smem = smem_bytes<float>(M, NT);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(group_simplex_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (B > 0) {
    group_simplex_kernel<float><<<B, kThreadsGlobal, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(W0), static_cast<const float*>(c),
        static_cast<const float*>(lb), static_cast<const float*>(ub),
        static_cast<const int32_t*>(basis0), static_cast<const uint8_t*>(at_upper0),
        static_cast<float*>(Wws), static_cast<int32_t*>(status), static_cast<int32_t*>(basis),
        static_cast<uint8_t*>(at_upper), static_cast<int32_t*>(iters), M, NT, max_iter,
        max_loop);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
