// Bounded-variable primal simplex, one LP per thread block, every pivot
// inside one launch.
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
// What bounds it on the H100: each pivot streams the LP's tableau about
// three times (pricing pass, column read, rank-1 read + write).  At the
// P2 shape of example10 (Mp = 384, NT = 768, f32) that is ~3.5 MB per LP
// per pivot against ~0.04 flop per byte, so the kernel is bound by memory
// bandwidth, not arithmetic.  The design:
//  * one CTA per LP loops over all its pivots, so there is one launch
//    per batch and no lockstep tail: each LP stops at its own optimum
//    (the TPU kernel's sequential grid over groups becomes the CTA grid);
//  * W lives in a global-memory workspace (one (Mp, NT) slice per LP,
//    read and written with consecutive threads on consecutive columns);
//    the per-LP vectors of length NT (c, lb, ub, d, d2, gamma, w_r/alpha_r,
//    in_basis, at_upper) and of length Mp (xb, lbB, ubB, cB, alpha,
//    ratios, basis) live in dynamic shared memory (~35 KB at that shape);
//  * the pricing pass is skipped on feasible steps (carried d2 row), so
//    most phase-2 pivots stream W twice instead of three times.
//  Keeping the whole tableau in shared memory, which fits only while
//  Mp * NT * 4 <~ 200 KB, is left to a later change.
//
// Arithmetic is IEEE with explicit round-to-nearest intrinsics for the
// products and sums (no contraction into FMA), so the kernel's pivot
// decisions follow the plain PyTorch version closely.  Reductions
// reproduce jnp.argmax: on ties the lowest index wins.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kRunning = 0;
constexpr int kOptimal = 1;
constexpr int kInfeasible = 2;
constexpr int kUnbounded = 3;
constexpr int kItlim = 4;
constexpr int kBlandAfter = 64;
constexpr int kThreads = 256;

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

template <typename T>
__device__ __forceinline__ void argmax_merge(T& v, int& i, T v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// Block-wide argmax over (value, index) pairs; the lowest index wins ties.
template <typename T>
__device__ void block_argmax(T& v, int& i, T* sv, int* si) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    T v2 = __shfl_down_sync(0xffffffffu, v, off);
    int i2 = __shfl_down_sync(0xffffffffu, i, off);
    argmax_merge(v, i, v2, i2);
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? sv[lane] : Ar<T>::neg_inf();
    i = lane < nwarps ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      T v2 = __shfl_down_sync(0xffffffffu, v, off);
      int i2 = __shfl_down_sync(0xffffffffu, i, off);
      argmax_merge(v, i, v2, i2);
    }
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

template <typename T>
__host__ __device__ size_t smem_bytes(int M, int NT) {
  return (7 * (size_t)NT + 7 * (size_t)M) * sizeof(T) + (size_t)M * sizeof(int) +
         2 * (size_t)NT;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
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

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one LP's block needs (float32).
size_t group_simplex_smem_bytes_f32(int M, int NT) { return smem_bytes<float>(M, NT); }

// Launch one block per LP on ``stream``.  Returns cudaGetLastError()
// after the launch (0 on success); the launch is asynchronous.
int group_simplex_f32(const void* W0, const void* c, const void* lb, const void* ub,
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
    group_simplex_kernel<float><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
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
