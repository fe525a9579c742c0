// One pivot of the batched tableau simplex (lp/simplex.py::_step, the
// primal, and lp/dual_simplex.py::_dstep, the dual) as two kernels, in
// float64 and float32.
//
// Replaces no TPU kernel: the JAX package's steps are XLA programs
// (bensolve_tpu/lp/simplex.py::_step, lp/dual_simplex.py::_dstep, looped
// by _tableau_run_jit and _dual_run_jit).  The port ran them as about a
// hundred small torch kernels a step, replayed in CUDA graphs
// (lp/segments.py); most batches are of 8 to 128 LPs, where those
// launches, not the bytes, set the step's time, and the tableau W
// (B, M, NT) was read three times a step (pricing, then the rank-1
// update's read and write).
//
// * primal_choice_kernel / dual_choice_kernel, one block per LP: the whole
//   decision of the step on the LP's (M) and (NT) vectors, one column of
//   W (and, for the dual, one row).  Phase-1 composite costs, the
//   devex/Bland entering choice, the ratio test with bound flips and the
//   Bland leaving rule (dual: the most-violated leaving row and the dual
//   ratio test), the statuses, and the new basis, basic values, bounds,
//   costs, in_basis, at_upper, stall and iters, written to fresh outputs.
//   It writes a pivot record: the rank-1 coefficients (M), the pivot
//   element, its row, the leaving variable, and the NEXT step's effective
//   basic costs (M) with its cost mask (phase 2 or not).
// * tableau_update_kernel, grid (B, column tiles): the rank-1 update
//   W_ij -= coef_i * (w_rj / alpha_r) fused with the next step's pricing,
//   d_j = c_eff_j - sum_i cbe_i W_new_ij, and, for the primal, the devex
//   weights of its columns.  A block reads its tile of row r, then walks
//   the rows once: W is read once and written once a step.  The sum runs
//   in a fixed order (rows g, g + R, ... per thread, then the R partial
//   sums in order), with no atomics, so every run gives the same bits.
//   With no coefficients (price mode) it only prices: the start of every
//   pivot loop, where the reduced costs become loop state.
//
// Every value the torch step computes outside a sum is computed here with
// the same operations in the same order and the same roundings (products
// by __dmul_rn / __fmul_rn, which nvcc never contracts into an FMA; the
// rank-1 update as w - round(coef * w_rs), as torch's addcmul_ kernel
// computes a + value * (b * c) with value -1), so W, the basic values and
// the devex weights match the torch step's bits given the same choices.
// Only the reduced costs differ, by the order of their sum.  Every argmax
// takes the first index on ties and ranks NaN above every number, as
// torch.argmax does; min and max propagate NaN as torch.min and
// torch.maximum do.
//
// What bounds it on the H100: the update kernel streams W (2 B M NT
// elements a step) and does 4 B M NT flop, so it is bound by HBM at
// 3.35 TB/s.  Tiles are one warp wide (32 columns, a 256-byte row segment
// in float64) for wide LPs, with 16 row groups and 4 rows in flight per
// thread, so a batch of 8 LPs still has about 200 blocks and enough loads
// in flight; an LP of at most 128 columns is one tile.  The choice kernel
// reads O(M + NT) per LP and is bound by latency: a few dependent passes
// over the LP's vectors, each a block reduction.
//
// Status codes and BLAND_AFTER are simplex.py's; the tolerances come in
// as arguments (simplex._tols).  Every entry point takes the stream and
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RUNNING = 0;
constexpr int OPTIMAL = 1;
constexpr int INFEASIBLE = 2;
constexpr int UNBOUNDED = 3;

constexpr int kThreadsChoice = 256;
constexpr int kWarps = kThreadsChoice / 32;

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double abs_(double x) { return fabs(x); }
__device__ __forceinline__ float abs_(float x) { return fabsf(x); }

template <typename T>
__device__ __forceinline__ T inf() { return (T)INFINITY; }

template <typename T>
__device__ __forceinline__ bool isnan_(T x) { return x != x; }

template <typename T>
__device__ __forceinline__ bool finite_(T x) { return isfinite(x); }

// torch.minimum / torch.maximum: NaN if either is NaN
template <typename T>
__device__ __forceinline__ T nanmin(T a, T b) {
  if (isnan_(a)) return a;
  if (isnan_(b)) return b;
  return a < b ? a : b;
}
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  if (isnan_(a)) return a;
  if (isnan_(b)) return b;
  return a > b ? a : b;
}

// (a, ia) ranks before (b, ib) as torch.argmax ranks them: NaN above every
// number, then the larger value, then the smaller index
template <typename T>
__device__ __forceinline__ bool beats(T a, int ia, T b, int ib) {
  const bool na = isnan_(a), nb = isnan_(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

// simplex._nb_value: a nonbasic variable's resting value
template <typename T>
__device__ __forceinline__ T nb_value(T lb, T ub, bool at_upper) {
  const bool fl = finite_(lb), fu = finite_(ub);
  const T lo = fl ? lb : (fu ? ub : (T)0);
  const T hi = fu ? ub : (fl ? lb : (T)0);
  return at_upper ? hi : lo;
}

// Block-wide reductions of kThreadsChoice threads; every thread gets the
// result.  Each ends with a barrier, so the scratch may be reused.
template <typename T>
struct Scratch {
  T v[kWarps];
  int i[kWarps];
};

template <typename T>
__device__ void block_argmax(T& v, int& i, Scratch<T>& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) { s.v[warp] = v; s.i[warp] = i; }
  __syncthreads();
  v = s.v[0];
  i = s.i[0];
  for (int w = 1; w < kWarps; ++w)
    if (beats(s.v[w], s.i[w], v, i)) { v = s.v[w]; i = s.i[w]; }
  __syncthreads();
}

template <typename T>
__device__ T block_min(T v, Scratch<T>& s) {
  for (int off = 16; off > 0; off >>= 1)
    v = nanmin(v, __shfl_down_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) s.v[warp] = v;
  __syncthreads();
  v = s.v[0];
  for (int w = 1; w < kWarps; ++w) v = nanmin(v, s.v[w]);
  __syncthreads();
  return v;
}

// The loop state in and out, and the pivot record, of one step.
template <typename T>
struct Step {
  const T* W;            // (B, M, NT)
  const T* d;            // (B, NT) reduced costs of this step
  const T* c;            // (B, NT)
  const T* lb;
  const T* ub;
  const T* gamma;        // (B, NT) devex weights (primal)
  const int64_t* basis;  // (B, M)
  const T* xb;
  const T* lbB;
  const T* ubB;
  const T* cB;
  const bool* in_basis;  // (B, NT)
  const bool* at_upper;
  const int* status;     // (B,)
  const int* stall;
  const int* iters;
  int64_t* basis_o;
  T* xb_o;
  T* lbB_o;
  T* ubB_o;
  T* cB_o;
  bool* in_basis_o;
  bool* at_upper_o;
  int* status_o;
  int* stall_o;
  int* iters_o;
  T* coef;               // (B, M) rank-1 coefficients, 0 off pivot
  T* cbe;                // (B, M) next step's effective basic costs
  T* piv;                // (B, 3) pivot element, gamma_q, leaving weight
  int* pidx;             // (B, 3) pivot row, leaving variable, pivots
  bool* feas;            // (B,) next step's costs are the true ones
};

constexpr int kStepPtrs = 31;

template <typename T>
Step<T> unpack_step(void* const* p) {
  Step<T> s;
  s.W = (const T*)p[0]; s.d = (const T*)p[1]; s.c = (const T*)p[2];
  s.lb = (const T*)p[3]; s.ub = (const T*)p[4]; s.gamma = (const T*)p[5];
  s.basis = (const int64_t*)p[6]; s.xb = (const T*)p[7];
  s.lbB = (const T*)p[8]; s.ubB = (const T*)p[9]; s.cB = (const T*)p[10];
  s.in_basis = (const bool*)p[11]; s.at_upper = (const bool*)p[12];
  s.status = (const int*)p[13]; s.stall = (const int*)p[14];
  s.iters = (const int*)p[15];
  s.basis_o = (int64_t*)p[16]; s.xb_o = (T*)p[17]; s.lbB_o = (T*)p[18];
  s.ubB_o = (T*)p[19]; s.cB_o = (T*)p[20]; s.in_basis_o = (bool*)p[21];
  s.at_upper_o = (bool*)p[22]; s.status_o = (int*)p[23];
  s.stall_o = (int*)p[24]; s.iters_o = (int*)p[25];
  s.coef = (T*)p[26]; s.cbe = (T*)p[27]; s.piv = (T*)p[28];
  s.pidx = (int*)p[29]; s.feas = (bool*)p[30];
  return s;
}

struct Tols {
  double bnd, dj, piv;
  int bland_after;
};

// The primal step's ratio of row i (simplex._pivot): the step length t at
// which basic i reaches its target bound, >= 0, inf where it never does.
template <typename T>
__device__ __forceinline__ T primal_ratio(T a, T sigma, T x, T lo, T hi,
                                          T tol_bnd, T tol_piv, T* rate_out,
                                          bool* vlo_out, bool* vup_out) {
  const T rate = mul_rn(-sigma, a);
  const bool inc = rate > tol_piv, dec = rate < -tol_piv;
  const bool vlo = x < lo - tol_bnd, vup = x > hi + tol_bnd;
  const T target_inc = vlo ? lo : hi;
  const T target_dec = vup ? hi : lo;
  const T t_inc = vup ? inf<T>() : (target_inc - x) / rate;
  const T t_dec = vlo ? inf<T>() : (target_dec - x) / rate;
  T t = inc ? t_inc : (dec ? t_dec : inf<T>());
  t = nanmax(t, (T)0);
  if (isnan_(t)) t = inf<T>();
  *rate_out = rate;
  *vlo_out = vlo;
  *vup_out = vup;
  return t;
}

// What both choice kernels write once the pivot is decided: the basic
// rows (with row r replaced where the basis changes), the coefficients,
// the next step's effective costs, in_basis / at_upper and the scalars.
template <typename T, bool DUAL>
__device__ void write_step(const Step<T>& s, int b, int M,
                           int NT, const T* col, int r, int q,
                           int64_t leaving, bool do_pivot, bool act,
                           bool do_flip, bool leave_at_upper, T step_len,
                           T new_r_val, T lbq, T ubq, T cq, bool auq,
                           int status, int stall, int iters, T alpha_r,
                           T gamma_q, T g_leave, T tol_bnd) {
  const size_t bM = (size_t)b * M, bN = (size_t)b * NT;
  bool viol = false;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const T a = col[(size_t)i * NT];
    const T x0 = s.xb[bM + i];
    // primal: xb - delta * alpha; dual: unchanged unless a step is taken
    T xn = DUAL ? (act ? x0 - mul_rn(step_len, a) : x0)
                : x0 - mul_rn(step_len, a);
    T lo = s.lbB[bM + i], hi = s.ubB[bM + i], cb = s.cB[bM + i];
    int64_t bs = s.basis[bM + i];
    const T co = do_pivot ? (i == r ? a + (T)-1 : a) : (T)0;
    if (do_pivot && i == r) {
      xn = new_r_val;
      bs = q;
      lo = lbq;
      hi = ubq;
      cb = cq;
    }
    s.xb_o[bM + i] = xn;
    s.basis_o[bM + i] = bs;
    s.lbB_o[bM + i] = lo;
    s.ubB_o[bM + i] = hi;
    s.cB_o[bM + i] = cb;
    s.coef[bM + i] = co;
    if (!DUAL) viol |= (xn < lo - tol_bnd) | (xn > hi + tol_bnd);
  }
  // the next step's effective basic costs (simplex._phase_costs): the
  // true costs where the new basis is feasible (and always for the dual),
  // else +-1 on the violating basics; each thread reads back its own rows
  const bool feas_next = DUAL ? true : !__syncthreads_or(viol);
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const T cb = s.cB_o[bM + i];
    if (DUAL || feas_next) {
      s.cbe[bM + i] = cb;
    } else {
      const T xn = s.xb_o[bM + i];
      const bool vlo = xn < s.lbB_o[bM + i] - tol_bnd;
      const bool vup = xn > s.ubB_o[bM + i] + tol_bnd;
      s.cbe[bM + i] = (vup ? (T)1 : (T)0) + (vlo ? (T)-1 : (T)0);
    }
  }
  for (int j = threadIdx.x; j < NT; j += blockDim.x) {
    bool ib = s.in_basis[bN + j], au = s.at_upper[bN + j];
    if (do_pivot && j == q) ib = true;
    if (do_pivot && j == leaving) ib = false;
    if (do_pivot && j == leaving) au = leave_at_upper;
    if (act && do_flip && j == q) au = !auq;
    s.in_basis_o[bN + j] = ib;
    s.at_upper_o[bN + j] = au;
  }
  if (threadIdx.x == 0) {
    s.status_o[b] = status;
    s.stall_o[b] = stall;
    s.iters_o[b] = iters;
    s.piv[3 * b + 0] = alpha_r;
    s.piv[3 * b + 1] = gamma_q;
    s.piv[3 * b + 2] = g_leave;
    s.pidx[3 * b + 0] = r;
    s.pidx[3 * b + 1] = (int)leaving;
    s.pidx[3 * b + 2] = do_pivot ? 1 : 0;
    s.feas[b] = feas_next;
  }
}

// simplex._step's decision for LP blockIdx.x (with _pivot and _phase_costs)
template <typename T>
__global__ void __launch_bounds__(kThreadsChoice)
primal_choice_kernel(Step<T> s, int M, int NT, Tols tl) {
  __shared__ Scratch<T> sc;
  const int b = blockIdx.x;
  const size_t bM = (size_t)b * M, bN = (size_t)b * NT;
  const T tol_bnd = (T)tl.bnd, tol_dj = (T)tl.dj, tol_piv = (T)tl.piv;
  const int status0 = s.status[b];
  const bool running = status0 == RUNNING;

  bool viol = false;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const T x = s.xb[bM + i];
    viol |= (x < s.lbB[bM + i] - tol_bnd) | (x > s.ubB[bM + i] + tol_bnd);
  }
  const bool feasible = !__syncthreads_or(viol);
  const bool use_bland = s.stall[b] > tl.bland_after;

  // entering variable: devex d^2 / gamma, or Bland's smallest index
  T best = -inf<T>();
  int bi = NT;
  bool any = false;
  for (int j = threadIdx.x; j < NT; j += blockDim.x) {
    const T lbj = s.lb[bN + j], ubj = s.ub[bN + j];
    const bool nonb = !s.in_basis[bN + j];
    const T val = nb_value(lbj, ubj, s.at_upper[bN + j]);
    const T dj = s.d[bN + j];
    const bool el = (nonb && val < ubj && dj < -tol_dj) ||
                    (nonb && val > lbj && dj > tol_dj);
    any |= el;
    const T score = !el ? -inf<T>()
                        : use_bland ? -(T)j
                                    : mul_rn(dj, dj) / s.gamma[bN + j];
    if (beats(score, j, best, bi)) { best = score; bi = j; }
  }
  block_argmax(best, bi, sc);
  const bool has_entering = __syncthreads_or(any);
  const int q = bi;

  const T lbq = s.lb[bN + q], ubq = s.ub[bN + q], cq = s.c[bN + q];
  const bool auq = s.at_upper[bN + q];
  const T valq = nb_value(lbq, ubq, auq);
  const bool inc_q = !s.in_basis[bN + q] && valq < ubq && s.d[bN + q] < -tol_dj;
  int status = (running && !has_entering) ? (feasible ? OPTIMAL : INFEASIBLE)
                                          : status0;
  bool act = running && has_entering;
  const T sigma = inc_q ? (T)1 : (T)-1;

  // ratio test over the entering column alpha = W[:, q]
  const T* col = s.W + (size_t)b * M * NT + q;
  T tmin = inf<T>();
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    T rate;
    bool vlo, vup;
    const T t = primal_ratio(col[(size_t)i * NT], sigma, s.xb[bM + i],
                             s.lbB[bM + i], s.ubB[bM + i], tol_bnd, tol_piv,
                             &rate, &vlo, &vup);
    tmin = nanmin(tmin, t);
  }
  tmin = block_min(tmin, sc);
  // leaving row among the near-minimal ratios: largest |rate|, or the
  // smallest basic variable under Bland
  const T thr = tmin + (T)1e-12;
  best = -inf<T>();
  bi = M;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    T rate;
    bool vlo, vup;
    const T t = primal_ratio(col[(size_t)i * NT], sigma, s.xb[bM + i],
                             s.lbB[bM + i], s.ubB[bM + i], tol_bnd, tol_piv,
                             &rate, &vlo, &vup);
    const bool cand = t <= thr;
    const T score = use_bland ? (cand ? -(T)s.basis[bM + i] : -inf<T>())
                              : (cand ? abs_(rate) : (T)-1);
    if (beats(score, i, best, bi)) { best = score; bi = i; }
  }
  block_argmax(best, bi, sc);
  const int r = bi;

  // bound flip of the entering variable, unboundedness, the step
  T span = ubq - lbq;
  if (!finite_(span)) span = inf<T>();
  const bool do_flip = span < tmin;
  const T t_star = do_flip ? span : tmin;
  if (act && feasible && !finite_(t_star)) status = UNBOUNDED;
  act = act && finite_(t_star);
  const T delta = act ? mul_rn(sigma, t_star) : (T)0;
  const bool do_pivot = act && !do_flip;

  const T ar = col[(size_t)r * NT];
  const T alpha_r = abs_(ar) < tol_piv ? (ar < 0 ? -tol_piv : tol_piv) : ar;
  const int64_t leaving = s.basis[bM + r];
  T rate_r;
  bool vlo_r, vup_r;
  primal_ratio(ar, sigma, s.xb[bM + r], s.lbB[bM + r], s.ubB[bM + r],
               tol_bnd, tol_piv, &rate_r, &vlo_r, &vup_r);
  const bool leave_at_upper = rate_r > 0 ? !vlo_r : vup_r;
  const bool degen = act && t_star < tol_bnd;
  const int stall0 = s.stall[b];
  const int stall = act ? (degen ? stall0 + 1 : 0) : stall0;
  const int iters = s.iters[b] + (act ? 1 : 0);
  const T gamma_q = s.gamma[bN + q];
  T g_leave = gamma_q / mul_rn(alpha_r, alpha_r);
  if (g_leave < (T)1) g_leave = (T)1;

  write_step<T, false>(s, b, M, NT, col, r, q, leaving, do_pivot, act,
                       do_flip, leave_at_upper, delta, valq + delta, lbq,
                       ubq, cq, auq, status, stall, iters, alpha_r, gamma_q,
                       g_leave, tol_bnd);
}

// dual_simplex._dstep's decision for LP blockIdx.x
template <typename T>
__global__ void __launch_bounds__(kThreadsChoice)
dual_choice_kernel(Step<T> s, int M, int NT, Tols tl) {
  __shared__ Scratch<T> sc;
  const int b = blockIdx.x;
  const size_t bM = (size_t)b * M, bN = (size_t)b * NT;
  const T tol_bnd = (T)tl.bnd, tol_dj = (T)tl.dj, tol_piv = (T)tl.piv;
  const int status0 = s.status[b];
  const bool running = status0 == RUNNING;
  const bool use_bland = s.stall[b] > tl.bland_after;

  // leaving row: the most primal-infeasible basic (Bland: smallest index)
  T best = -inf<T>();
  int bi = M;
  bool viol_any = false;
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    const T x = s.xb[bM + i], lo = s.lbB[bM + i], hi = s.ubB[bM + i];
    const bool below = x < lo - tol_bnd, above = x > hi + tol_bnd;
    const T viol = below ? lo - x : (above ? x - hi : (T)0);
    const bool pos = viol > 0;
    viol_any |= pos;
    const T score = !pos ? -inf<T>() : (use_bland ? -(T)s.basis[bM + i] : viol);
    if (beats(score, i, best, bi)) { best = score; bi = i; }
  }
  block_argmax(best, bi, sc);
  const bool feasible = !__syncthreads_or(viol_any);
  const int r = bi;
  const T xr = s.xb[bM + r], lbr = s.lbB[bM + r], ubr = s.ubB[bM + r];
  const bool r_below = xr < lbr - tol_bnd;

  // entering column: dual ratio test on row r
  const T* row = s.W + (size_t)b * M * NT + (size_t)r * NT;
  T rmin = inf<T>();
  bool any = false;
  for (int j = threadIdx.x; j < NT; j += blockDim.x) {
    const T a = row[j];
    const T lbj = s.lb[bN + j], ubj = s.ub[bN + j];
    const bool nonb = !s.in_basis[bN + j];
    const T val = nb_value(lbj, ubj, s.at_upper[bN + j]);
    const bool ci = nonb && val < ubj, cd = nonb && val > lbj;
    const bool el = r_below ? ((ci && a < -tol_piv) || (cd && a > tol_piv))
                            : ((ci && a > tol_piv) || (cd && a < -tol_piv));
    any |= el;
    const T ratio = el ? abs_(s.d[bN + j]) / abs_(a) : inf<T>();
    rmin = nanmin(rmin, ratio);
  }
  rmin = block_min(rmin, sc);
  const bool has_entering = __syncthreads_or(any);
  const T thr = rmin + tol_dj;
  best = -inf<T>();
  bi = NT;
  for (int j = threadIdx.x; j < NT; j += blockDim.x) {
    const T a = row[j];
    const T lbj = s.lb[bN + j], ubj = s.ub[bN + j];
    const bool nonb = !s.in_basis[bN + j];
    const T val = nb_value(lbj, ubj, s.at_upper[bN + j]);
    const bool ci = nonb && val < ubj, cd = nonb && val > lbj;
    const bool el = r_below ? ((ci && a < -tol_piv) || (cd && a > tol_piv))
                            : ((ci && a > tol_piv) || (cd && a < -tol_piv));
    const T ratio = el ? abs_(s.d[bN + j]) / abs_(a) : inf<T>();
    const bool near = el && ratio <= thr;
    const T score = use_bland ? (near ? -(T)j : -inf<T>())
                              : (near ? abs_(a) : (T)-1);
    if (beats(score, j, best, bi)) { best = score; bi = j; }
  }
  block_argmax(best, bi, sc);
  const int q = bi;

  int status = (running && feasible) ? OPTIMAL : status0;
  if (running && !feasible && !has_entering) status = INFEASIBLE;
  const bool act = running && !feasible && has_entering;

  const T arq = row[q];
  const T alpha_rq = abs_(arq) < tol_piv ? (arq < 0 ? -tol_piv : tol_piv) : arq;
  const T target = r_below ? lbr : ubr;
  const T dx_q = act ? (xr - target) / alpha_rq : (T)0;
  const T lbq = s.lb[bN + q], ubq = s.ub[bN + q], cq = s.c[bN + q];
  const bool auq = s.at_upper[bN + q];
  const T xq_new = nb_value(lbq, ubq, auq) + dx_q;
  const int64_t leaving = s.basis[bM + r];
  const bool degen = act && abs_(dx_q) < tol_bnd;
  const int stall0 = s.stall[b];
  const int stall = act ? (degen ? stall0 + 1 : 0) : stall0;
  const int iters = s.iters[b] + (act ? 1 : 0);

  const T* col = s.W + (size_t)b * M * NT + q;
  write_step<T, true>(s, b, M, NT, col, r, q, leaving, act, act, false,
                      !r_below, dx_q, xq_new, lbq, ubq, cq, auq, status,
                      stall, iters, alpha_rq, (T)0, (T)0, tol_bnd);
}

// The rank-1 update fused with the next pricing, for LP blockIdx.x and
// columns [blockIdx.y * tile, ... + tile).  Thread t owns column t % tile
// and rows g, g + R, ..., g = t / tile, R = rows.  coef == nullptr: price
// only (W is read, not written); gamma == nullptr: no devex update.
template <typename T>
__global__ void tableau_update_kernel(T* W, const T* coef, const T* cbe,
                                      const T* piv, const int* pidx,
                                      const bool* feas, const T* c, T* gamma,
                                      T* d, int M, int NT, int tile, int rows) {
  extern __shared__ unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);
  const int b = blockIdx.x;
  const int col = threadIdx.x % tile, g = threadIdx.x / tile;
  const int j = blockIdx.y * tile + col;
  const bool ok = j < NT;
  T* Wb = W + (size_t)b * M * NT;
  const bool upd = coef != nullptr;
  const T* co = upd ? coef + (size_t)b * M : nullptr;
  const T* cb = cbe + (size_t)b * M;

  T wrs = 0;
  if (upd && ok) wrs = Wb[(size_t)pidx[3 * b] * NT + j] / piv[3 * b];
  // every thread of the column has read w_rj before row r is written
  __syncthreads();

  T acc = 0;
  if (ok) {
    int i = g;
    for (; i + 3 * rows < M; i += 4 * rows) {
      T* p0 = Wb + (size_t)i * NT + j;
      T* p1 = p0 + (size_t)rows * NT;
      T* p2 = p1 + (size_t)rows * NT;
      T* p3 = p2 + (size_t)rows * NT;
      T w0 = *p0, w1 = *p1, w2 = *p2, w3 = *p3;
      if (upd) {
        w0 = w0 - mul_rn(co[i], wrs);
        w1 = w1 - mul_rn(co[i + rows], wrs);
        w2 = w2 - mul_rn(co[i + 2 * rows], wrs);
        w3 = w3 - mul_rn(co[i + 3 * rows], wrs);
        *p0 = w0;
        *p1 = w1;
        *p2 = w2;
        *p3 = w3;
      }
      acc = fma_(cb[i], w0, acc);
      acc = fma_(cb[i + rows], w1, acc);
      acc = fma_(cb[i + 2 * rows], w2, acc);
      acc = fma_(cb[i + 3 * rows], w3, acc);
    }
    for (; i < M; i += rows) {
      T* p = Wb + (size_t)i * NT + j;
      T w = *p;
      if (upd) {
        w = w - mul_rn(co[i], wrs);
        *p = w;
      }
      acc = fma_(cb[i], w, acc);
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && ok) {
    T sum = part[col];
    for (int k = 1; k < rows; ++k) sum += part[k * tile + col];
    const size_t bj = (size_t)b * NT + j;
    const T ce = feas[b] ? c[bj] : (T)0;
    d[bj] = ce - sum;
    if (upd && gamma != nullptr) {
      // simplex._devex_update
      const T g0 = gamma[bj];
      T gn = g0;
      if (pidx[3 * b + 2]) {
        gn = j == pidx[3 * b + 1]
                 ? piv[3 * b + 2]
                 : nanmax(g0, mul_rn(mul_rn(wrs, wrs), piv[3 * b + 1]));
      }
      if (gn > (T)1e8) gn = (T)1;
      gamma[bj] = gn;
    }
  }
}

template <typename T>
int launch_choice(bool dual, void* const* p, int B, int M, int NT,
                  double tol_bnd, double tol_dj, double tol_piv,
                  int bland_after, void* stream) {
  const Step<T> s = unpack_step<T>(p);
  const Tols tl{tol_bnd, tol_dj, tol_piv, bland_after};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dual)
    dual_choice_kernel<T><<<B, kThreadsChoice, 0, st>>>(s, M, NT, tl);
  else
    primal_choice_kernel<T><<<B, kThreadsChoice, 0, st>>>(s, M, NT, tl);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(void* const* p, int B, int M, int NT, int tile, int rows,
                  void* stream) {
  const dim3 grid(B, (NT + tile - 1) / tile);
  const int threads = tile * rows;
  tableau_update_kernel<T><<<grid, threads, threads * sizeof(T),
                             static_cast<cudaStream_t>(stream)>>>(
      (T*)p[0], (const T*)p[1], (const T*)p[2], (const T*)p[3],
      (const int*)p[4], (const bool*)p[5], (const T*)p[6], (T*)p[7],
      (T*)p[8], M, NT, tile, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The choice kernel of one step over B LPs: p holds kStepPtrs device
// pointers (unpack_step's order); dual != 0 runs _dstep's rules.
int tableau_choice_f64(int dual, void* const* p, int B, int M, int NT,
                       double tol_bnd, double tol_dj, double tol_piv,
                       int bland_after, void* stream) {
  return launch_choice<double>(dual != 0, p, B, M, NT, tol_bnd, tol_dj,
                               tol_piv, bland_after, stream);
}
int tableau_choice_f32(int dual, void* const* p, int B, int M, int NT,
                       double tol_bnd, double tol_dj, double tol_piv,
                       int bland_after, void* stream) {
  return launch_choice<float>(dual != 0, p, B, M, NT, tol_bnd, tol_dj,
                              tol_piv, bland_after, stream);
}

// The update kernel: p = (W, coef or null, cbe, piv, pidx, feas, c,
// gamma or null, d), over B LPs in tiles of `tile` columns with `rows`
// row groups (tile * rows threads a block).
int tableau_update_f64(void* const* p, int B, int M, int NT, int tile,
                       int rows, void* stream) {
  return launch_update<double>(p, B, M, NT, tile, rows, stream);
}
int tableau_update_f32(void* const* p, int B, int M, int NT, int tile,
                       int rows, void* stream) {
  return launch_update<float>(p, B, M, NT, tile, rows, stream);
}

}  // extern "C"
