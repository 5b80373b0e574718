// Water-filling kernels for Hopper (sm_90a): the three bisection solves of
// the paper's General Water-Filling step, in float32.
//
// Every kernel is a bisection whose step is an elementwise map over the
// job axis followed by one sum: K1 and K2 take a fixed count of steps, K3
// stops at its float32 fixed point.  One thread block owns one instance,
// every step ends in a block reduction whose result every thread holds,
// and the bracket stays in registers.  Instances are independent, so the
// grid's order does not matter.
//
// K1 and K2 bisect in L = log2 λ.  Job i's allocation at L is
//   θ_i = clip(σ_i (2^{t_i} − w_i), 0, b),  t_i = (L + log2(c_i/A_i)) / γ_i,
// and 0 where L ≥ P_i = log2(s_i'(0)/c_i) (parked) or c_i = 0 (inactive).
// The first pass derives, per job, 1/γ_i, the pair β_i = bhi + blo (float
// hi and lo words) holding (L_c + log2(c_i/A_i))/γ_i, σ_i, −σ_i w_i and P_i
// − L_c; a pass is then t = fmaf(1/γ, u, bhi) + blo with u = L − L_c, one
// exp2, an fmaf, a clip and a select: no division, no log, and for the
// jobs of the register tile no load.
//
// Precision.  log2 c and log2 A are each taken as frexpf's exponent plus
// log2f of the mantissa in [0.5, 1), so their absolute error stays near
// 1e-7 however large |log2 c| is; β is formed in double and split into
// two floats.  The centre L_c is 0 until step kRecentre and then the
// bracket's midpoint, where β moves by fmaf(1/γ, L_c, bhi) + blo: after
// that u, not L, is bisected, whose float32 spacing is finer than λ's own
// (L's spacing at |L| in [8, 16) is 9.5e-7, a step of 6.6e-7 in λ, five
// times λ's float32 spacing).  So t carries one to two ulp of its own
// value (4.8e-7 at t in [4, 8)) and ex2.approx two ulp of 2^t: a
// saturating job θ = z − 2^t with z up to 80 keeps ~3e-5 of float32
// rounding, as much as the plain version's pow does.  The build passes no
// --use_fast_math.  tools/ablate_kernels.py reads the library exp2f, a
// move in double and no move at all against the plain version in float64.
// chip_smoke.py holds each kernel against its plain version per row in
// units of the mean allocation b / k_act (limits 1e-2 for K1 and K3, 1e-1
// for K2, whose saturating jobs leave that rounding), and K1 and K2 to
// their KKT conditions as well, since the final rescale would hide a
// wrong λ from a row sum; the JAX kernel tests' tolerances stay as outer
// bounds.
//
// The C interface takes raw pointers, sizes, the iteration count, the
// block size, the job tile it was sized for and the stream; every entry
// point launches on that stream and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a block size or tile it was not built for.
// The wrapper in kernel.py allocates the outputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kF32Big = 1e30f;   // float32 stand-in for an infinite s'(0)

// The job tile of K1, K2 and K3: a block holds kTileJobs jobs in registers
// (jobs j ≡ threadIdx.x mod NT, kTileJobs / NT of them a thread), up to
// kSmemBytes of further jobs' state in dynamic shared memory, and derives
// the rest from device memory in every pass.  kernel.py's TILE_JOBS and
// SMEM_BYTES; the entry points refuse a tile sized otherwise.
constexpr int kTileJobs = 4096;
constexpr int kSmemBytes = 196608;
constexpr int kRecentre = 24;      // the step at which L_c moves (see top)

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// ---------------------------------------------------------------------------
// Reductions.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float2 warp_min_max(float2 v) {
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fminf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y = fmaxf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
  }
  return v;
}

// K1 and K2's block reductions, one barrier each.  A warp folds its lanes
// by an xor butterfly (every lane ends with the same bits, as a + b ==
// b + a), lane 0 posts the warp's value, and after the barrier every warp
// folds the posted values the same way: all threads hold the same result
// and take the same branch.  Calls post to alternate halves of `part`: a
// warp that runs on posts to the other half, and cannot post to this one
// again before every warp has passed the next barrier, that is has read it.
template <int NT>
struct BlockReduce {
  float2 (*part)[32];
  int calls;

  __device__ float sum(float v) {
    float2* p = part[calls++ & 1];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) p[threadIdx.x >> 5].x = v;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    return warp_sum(lane < NT / 32 ? p[lane].x : 0.0f);
  }

  // (min of v.x, max of v.y) at once
  __device__ float2 min_max(float2 v) {
    float2* p = part[calls++ & 1];
    v = warp_min_max(v);
    if ((threadIdx.x & 31) == 0) p[threadIdx.x >> 5] = v;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    return warp_min_max(lane < NT / 32
                            ? p[lane]
                            : make_float2(CUDART_INF_F, -CUDART_INF_F));
  }
};

// ---------------------------------------------------------------------------
// K1 and K2's job state and the bisection they share.
// ---------------------------------------------------------------------------

// log2 x (x > 0) as frexpf's exponent plus log2f of a mantissa in [0.5, 1).
__device__ __forceinline__ double log2_split(float x) {
  int e;
  const float m = frexpf(x, &e);
  return static_cast<double>(e) + static_cast<double>(log2f(m));
}

struct Pair { float hi, lo; };

__device__ __forceinline__ Pair split(double x) {
  const float hi = static_cast<float>(x);
  return {hi, static_cast<float>(x - static_cast<double>(hi))};
}

// 2^t by the MUFU alone (ex2.approx.ftz: 2 ulp, as exp2f, which adds
// three instructions a call to keep subnormal results).
__device__ __forceinline__ float exp2_ftz(float t) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return e;
}

// θ of one job at u = L − L_c (see the top of the file).
__device__ __forceinline__ float theta_at(float u, float ginv, float bhi,
                                          float blo, float sg, float nsw,
                                          float park, float b) {
  const float t = fmaf(ginv, u, bhi) + blo;
  const float e = exp2_ftz(t);
  const float th = clip(fmaf(sg, e, nsw), 0.0f, b);
  return u >= park ? 0.0f : th;
}

// Moves a job's centre by Lc: β += Lc/γ, folded into the hi word (after
// the move |β| ≈ |t|, whose ulp bounds t's error anyway), P −= Lc.
__device__ __forceinline__ void move_centre(float ginv, float& bhi,
                                            float& blo, float& park,
                                            float Lc) {
  bhi = fmaf(ginv, Lc, bhi) + blo;
  blo = 0.0f;
  park -= Lc;
}

// [log2 λ_lo, log2 λ_hi], or [0, 1] (λ in [1, 2]) for a degenerate bracket
// (no active job); fabsf(x) < inf is false for inf and NaN alike.
__device__ __forceinline__ float2 log_bracket(float lo, float hi) {
  const bool good = fabsf(lo) < CUDART_INF_F && lo > 0.0f &&
                    fabsf(hi) < CUDART_INF_F;
  return good ? make_float2(log2f(lo), log2f(hi)) : make_float2(0.0f, 1.0f);
}

// The bisection K1 and K2 share, on a family Fam that derives a job from
// device memory (Fam::job, folding it into the bracket's partial min and
// max), turns the bracket's extremes into log2 λ (Fam::bracket), and
// evaluates and re-centres a job's state.
template <class Fam, int NT>
__device__ void bisect(const Fam& fam, float* __restrict__ out, int K,
                       int iters, int smem_jobs, float* tile,
                       BlockReduce<NT>& red) {
  constexpr int kJobs = kTileJobs / NT;   // register-tile jobs a thread
  using Job = typename Fam::Job;
  const int tid = threadIdx.x;
  const int on_chip = kTileJobs + smem_jobs;
  const float b = fam.b;

  // first pass: every job derived once, into registers, shared memory,
  // or (past both) only into the bracket
  float2 br = make_float2(CUDART_INF_F, -CUDART_INF_F);
  Job reg[kJobs];
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    reg[k] = j < K ? fam.job(j, br) : Fam::idle();
  }
  for (int j = kTileJobs + tid; j < K; j += NT) {
    const Job q = fam.job(j, br);
    if (j < on_chip) Fam::put(tile, smem_jobs, j - kTileJobs, q);
  }
  const float2 L = fam.bracket(red.min_max(br));
  float lo = L.x, hi = L.y, centre = 0.0f;

  auto streamed = [&](int j, bool moved) {
    float2 unused = br;
    Job q = fam.job(j, unused);
    if (moved) fam.move(q, centre);
    return q;
  };

  for (int it = 0; it < iters; ++it) {
    if (it == kRecentre) {
      centre = 0.5f * (lo + hi);
      lo -= centre;
      hi -= centre;
#pragma unroll
      for (int k = 0; k < kJobs; ++k) fam.move(reg[k], centre);
      for (int i = tid; i < smem_jobs; i += NT) {
        Job q = Fam::get(tile, smem_jobs, i);
        fam.move(q, centre);
        Fam::put(tile, smem_jobs, i, q);
      }
    }
    const float mid = 0.5f * (lo + hi);
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < kJobs; ++k)
      if (k * NT < K) s += fam.theta(reg[k], mid);
    for (int i = tid; i < smem_jobs; i += NT)
      s += fam.theta(Fam::get(tile, smem_jobs, i), mid);
    for (int j = on_chip + tid; j < K; j += NT)
      s += fam.theta(streamed(j, it >= kRecentre), mid);
    s = red.sum(s);
    if (s > b) lo = mid; else hi = mid;   // β > b ⇒ λ* right of mid
  }

  // last pass: θ kept (registers; shared memory, in the job's first word;
  // θ's own slot when streamed), then one write of the rescaled θ
  const float u = 0.5f * (lo + hi);
  const bool moved = iters > kRecentre;
  float th[kJobs];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    th[k] = k * NT < K ? fam.theta(reg[k], u) : 0.0f;
    s += th[k];
  }
  for (int i = tid; i < smem_jobs; i += NT) {
    const float t = fam.theta(Fam::get(tile, smem_jobs, i), u);
    tile[i] = t;
    s += t;
  }
  for (int j = on_chip + tid; j < K; j += NT) {
    const float t = fam.theta(streamed(j, moved), u);
    out[j] = t;
    s += t;
  }
  const float tot = red.sum(s);
  // exact budget: rescale the float residual onto the positive allocations
  const float scale = tot > 0.0f ? b / tot : 1.0f;
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    if (j < K) out[j] = fminf(th[k] * scale, b);
  }
  for (int i = tid; i < smem_jobs; i += NT)
    out[kTileJobs + i] = fminf(tile[i] * scale, b);
  for (int j = on_chip + tid; j < K; j += NT) out[j] = fminf(out[j] * scale, b);
}

// ---------------------------------------------------------------------------
// K1 — generic_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::generic_waterfill
// (body _generic_wf_kernel).  Batched CAP for one shared regular family
// s'(θ) = A(w + σθ)^γ, A, w, γ and b per instance (each read at its own
// element stride, 0 for a value all instances share): per instance a
// bisection on λ until Σ θ_i(λ) = b with θ_i = clip(σ((c_i λ/A)^{1/γ} −
// w), 0, b), jobs with c_i λ ≥ s'(0) parked, c = 0 inactive; then θ is
// rescaled onto b.  The λ-bracket is lam_bracket's (ref.py): [s'(b)/max c,
// s'(0)/min c · (1 + 1e-6)] over the active c, s'(0) capped at 1e30 and
// s'(ε), ε = b/(8K), standing in for an infinite one; the first pass
// reduces min and max c at once.
// Bound on this card: the 65 dependent steps, not bytes (8 per job, read
// and written once) nor the MUFU (6.5e7 exp2 at 256 × 4096 take ~0.02 ms).
// A step is a pass over the thread's jobs in registers (one exp2 and ~8
// FP32 operations each), one barrier and a branch every thread takes
// alike; a job's state is three words (β's two, P), so at 512 threads
// (8 jobs a thread, 58 registers) two instances share an SM.  By
// tools/ablate_kernels.py the step's reduction is a fifth of the time and
// the first and last passes a quarter; without the exp2 it is hardly faster.
// ---------------------------------------------------------------------------
struct SharedFamily {
  struct Job { float bhi, blo, park; };
  const float* c;        // this instance's row
  float ginv, sg, nsw, b;
  double lA;             // log2 A
  float lds0;            // log2 s'(0)
  float ds_b, ds_top;    // s'(b), and s'(0) or s'(ε)

  __device__ static Job idle() { return {0.0f, 0.0f, -CUDART_INF_F}; }

  __device__ Job job(int j, float2& br) const {
    const float cj = c[j];
    if (!(cj > 0.0f)) return idle();
    br.x = fminf(br.x, cj);
    br.y = fmaxf(br.y, cj);
    const double lc = log2_split(cj);
    const Pair beta = split(static_cast<double>(ginv) * (lc - lA));
    return {beta.hi, beta.lo, static_cast<float>(lds0 - lc)};
  }

  __device__ float2 bracket(float2 c_min_max) const {
    const float lo = ds_b / c_min_max.y;
    const float hi = ds_top / c_min_max.x * (1.0f + 1e-6f);
    // a NaN hi stays NaN (torch.maximum's rule), so it fails the check
    return log_bracket(lo, hi != hi ? hi : fmaxf(hi, lo * (1.0f + 1e-6f)));
  }

  __device__ float theta(const Job& q, float u) const {
    return theta_at(u, ginv, q.bhi, q.blo, sg, nsw, q.park, b);
  }
  __device__ void move(Job& q, float Lc) const {
    move_centre(ginv, q.bhi, q.blo, q.park, Lc);
  }
  __device__ static void put(float* t, int n, int i, const Job& q) {
    t[i] = q.bhi;
    t[n + i] = q.blo;
    t[2 * n + i] = q.park;
  }
  __device__ static Job get(const float* t, int n, int i) {
    return {t[i], t[n + i], t[2 * n + i]};
  }
};

template <int NT>
__global__ void __launch_bounds__(NT)
generic_waterfill_kernel(const float* __restrict__ c,
                         const float* __restrict__ A, int sA,
                         const float* __restrict__ w, int sw,
                         const float* __restrict__ g, int sg,
                         const float* __restrict__ b_arr, int sb,
                         float* __restrict__ theta, int K, int iters,
                         float sigma, int smem_jobs) {
  extern __shared__ float tile[];
  __shared__ float2 part[2][32];
  BlockReduce<NT> red{part, 0};
  const size_t row = blockIdx.x;
  const float Ar = A[row * sA], wr = w[row * sw], gr = g[row * sg];
  SharedFamily fam;
  fam.c = c + row * K;
  fam.b = b_arr[row * sb];
  fam.ginv = 1.0f / gr;
  fam.sg = sigma;
  fam.nsw = -sigma * wr;
  fam.lA = log2_split(Ar);
  const float ds0 = wr > 0.0f ? Ar * powf(wr, gr) : kF32Big;
  fam.lds0 = log2f(ds0);
  fam.ds_b = Ar * powf(wr + sigma * fam.b, gr);
  const float eps = fam.b / (8.0f * K);
  fam.ds_top = wr > 0.0f ? ds0 : Ar * powf(wr + sigma * eps, gr);
  bisect<SharedFamily, NT>(fam, theta + row * K, K, iters, smem_jobs, tile,
                           red);
}

// ---------------------------------------------------------------------------
// K2 — hetero_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::hetero_waterfill
// (body _hetero_wf_kernel).  The same bisection with job-indexed A, w, γ,
// σ (paper §7); the λ-bracket [min_i s_i'(b)/c_i, max_i s_i'(0⁺)/c_i ·
// (1 + 1e-6)] and each job's parking threshold s_i'(0) come from the
// first pass, with ε = b/(8·k_act) after a count of the active jobs.  The
// bracket's powers are guarded (base clamped to 1e-30), so padding lanes
// cannot NaN the reductions; the passes take no log, so they need no guard.
// Bound on this card: as K1, the dependent steps.  A job's state is six
// words (1/γ, β's two, σ, −σw, P): at 256 threads (16 jobs a thread)
// that is 128 registers, just what lets two instances share an SM; at
// 512 or 1024 threads one instance holds an SM and 256 instances take two
// waves (tools/ablate_kernels.py times the three).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float guarded_pow(float base, float e) {
  return expf(e * logf(fmaxf(base, 1e-30f)));
}

struct JobFamily {
  struct Job { float ginv, bhi, blo, sg, nsw, park; };
  const float *c, *A, *w, *g, *s;   // this instance's rows
  float b, eps;

  __device__ static Job idle() {
    return {1.0f, 0.0f, 0.0f, 1.0f, 0.0f, -CUDART_INF_F};
  }

  __device__ Job job(int j, float2& br) const {
    const float cj = c[j], Aj = A[j], wj = w[j], gj = g[j], sj = s[j];
    Job q{1.0f / gj, 0.0f, 0.0f, sj, -sj * wj, -CUDART_INF_F};
    if (!(cj > 0.0f)) return q;
    const float ds0 = wj > 0.0f ? Aj * guarded_pow(wj, gj) : kF32Big;
    const float ds_b = Aj * guarded_pow(wj + sj * b, gj);
    const float ds_top = wj > 0.0f ? ds0 : Aj * guarded_pow(wj + sj * eps, gj);
    br.x = fminf(br.x, ds_b / cj);
    br.y = fmaxf(br.y, ds_top / cj);
    const double lc = log2_split(cj);
    const Pair beta = split(static_cast<double>(q.ginv) *
                            (lc - log2_split(Aj)));
    q.bhi = beta.hi;
    q.blo = beta.lo;
    q.park = static_cast<float>(static_cast<double>(log2f(ds0)) - lc);
    return q;
  }

  __device__ float2 bracket(float2 m) const {
    const float hi = m.y * (1.0f + 1e-6f);
    return log_bracket(m.x, fmaxf(hi, m.x * (1.0f + 1e-6f)));
  }

  __device__ float theta(const Job& q, float u) const {
    return theta_at(u, q.ginv, q.bhi, q.blo, q.sg, q.nsw, q.park, b);
  }
  __device__ void move(Job& q, float Lc) const {
    move_centre(q.ginv, q.bhi, q.blo, q.park, Lc);
  }
  __device__ static void put(float* t, int n, int i, const Job& q) {
    t[i] = q.ginv;
    t[n + i] = q.bhi;
    t[2 * n + i] = q.blo;
    t[3 * n + i] = q.sg;
    t[4 * n + i] = q.nsw;
    t[5 * n + i] = q.park;
  }
  __device__ static Job get(const float* t, int n, int i) {
    return {t[i], t[n + i], t[2 * n + i], t[3 * n + i], t[4 * n + i],
            t[5 * n + i]};
  }
};

template <int NT>
__global__ void __launch_bounds__(NT)
hetero_waterfill_kernel(const float* __restrict__ c,
                        const float* __restrict__ A,
                        const float* __restrict__ w,
                        const float* __restrict__ g,
                        const float* __restrict__ sg,
                        const float* __restrict__ b_arr,
                        float* __restrict__ theta, int K, int iters,
                        int smem_jobs) {
  extern __shared__ float tile[];
  __shared__ float2 part[2][32];
  BlockReduce<NT> red{part, 0};
  const size_t off = static_cast<size_t>(blockIdx.x) * K;
  JobFamily fam{c + off, A + off, w + off, g + off, sg + off,
                b_arr[blockIdx.x], 0.0f};
  float n_act = 0.0f;
  for (int j = threadIdx.x; j < K; j += NT) n_act += fam.c[j] > 0.0f ? 1.0f : 0.0f;
  fam.eps = fam.b / (8.0f * fmaxf(red.sum(n_act), 1.0f));
  bisect<JobFamily, NT>(fam, theta + off, K, iters, smem_jobs, tile, red);
}

// ---------------------------------------------------------------------------
// K3 — gwf_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::gwf_waterfill (body
// _wf_kernel).  Single-instance rectangle-bottle WFP (paper §4.5.1):
// bisection on the level h over [min h0_i, max (h0_i + b/u_i)] (active
// bottles, u_i > 0), lo ← mid where Σ clip(u_i (mid − h0_i), 0, b) < b,
// else hi ← mid, at most iters halvings; then θ_i = clip(u_i (h − h0_i),
// 0, b) at the final bracket's midpoint h, 0 where u_i ≤ 0, and θ = 0
// everywhere when no bottle is active (the plain version's zeros).
// Bound on this card: neither bytes (12 a bottle) nor operations (5 a
// bottle and step) but latency: one instance is one block on one SM and
// every step waits for a block-wide sum.  So the design shortens the chain
// of dependent steps and each step:
//  - the bisection stops at its float32 fixed point.  A step is a function
//    of the bracket's bits alone (the sums are folded in one fixed order
//    that gives every thread the same bits, so every thread also takes the
//    same branch); once a step leaves (lo, hi) as they were, every later
//    step does too, and stopping there gives the bits of all iters steps.
//    From chip_smoke.py's bracket [0.25, 204] that is 29 of 64 steps;
//  - each bottle (u, h0) is loaded once, into registers (the job tile of
//    K1/K2 with two words a bottle), then shared memory, and read from
//    device memory in every step only past both; an inactive one is (0, 0);
//  - the bracket is one min-max reduction;
//  - multi-section: a round evaluates the 2^R − 1 midpoints of the next R
//    steps (a binary tree of brackets), folds their sums with one barrier
//    and walks the tree, which replays the R steps of bisection bit for
//    bit; R = kLevelBits = 2 halves the barriers for three times the
//    pass.  At 512 threads it beat R = 1 and R = 3 on the card
//    (tools/ablate_kernels.py times all three, and fails unless they
//    give the same bits).
// ---------------------------------------------------------------------------
constexpr int kLevelBits = 2;

__device__ __forceinline__ bool same_bits(float x, float y) {
  return __float_as_uint(x) == __float_as_uint(y);
}

// The block's sums of L values with one barrier, folded as BlockReduce::sum
// folds one (lane butterflies, a post a warp, the posts folded alike by
// every warp), into alternate halves of `part`.
template <int NT, int L>
struct LevelSums {
  float (*part)[L][32];
  int calls;

  __device__ void fold(float (&s)[L]) {
    float (*p)[32] = part[calls++ & 1];
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int n = 0; n < L; ++n) s[n] = warp_sum(s[n]);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < L; ++n) p[n][threadIdx.x >> 5] = s[n];
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < L; ++n)
      s[n] = warp_sum(lane < NT / 32 ? p[n][lane] : 0.0f);
  }
};

template <int NT>
__global__ void __launch_bounds__(NT)
gwf_waterfill_kernel(const float* __restrict__ u,
                     const float* __restrict__ h0, float b,
                     float* __restrict__ theta, int M, int iters,
                     int smem_jobs) {
  constexpr int kJobs = kTileJobs / NT;        // register-tile bottles a thread
  constexpr int L = (1 << kLevelBits) - 1;     // levels a round
  extern __shared__ float tile[];              // u, then h0, of smem_jobs
  __shared__ float2 part[2][32];
  __shared__ float level_part[2][L][32];
  BlockReduce<NT> red{part, 0};
  LevelSums<NT, L> sums{level_part, 0};
  const int tid = threadIdx.x;
  const int on_chip = kTileJobs + smem_jobs;

  auto load = [&](int j) {
    const float uj = u[j];
    return uj > 0.0f ? make_float2(uj, h0[j]) : make_float2(0.0f, 0.0f);
  };
  // one load of every bottle, into registers, shared memory, or (past
  // both) only into the bracket
  float2 br = make_float2(CUDART_INF_F, -CUDART_INF_F);
  auto first = [&](int j) {
    const float2 q = load(j);
    if (q.x > 0.0f) {
      br.x = fminf(br.x, q.y);
      br.y = fmaxf(br.y, q.y + b / fmaxf(q.x, 1e-30f));
    }
    return q;
  };
  float ru[kJobs], rh[kJobs];
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    const float2 q = j < M ? first(j) : make_float2(0.0f, 0.0f);
    ru[k] = q.x;
    rh[k] = q.y;
  }
  for (int j = kTileJobs + tid; j < M; j += NT) {
    const float2 q = first(j);
    if (j < on_chip) {
      tile[j - kTileJobs] = q.x;
      tile[smem_jobs + j - kTileJobs] = q.y;
    }
  }
  br = red.min_max(br);
  float lo = br.x, hi = br.y;
  if (lo > hi) {                     // no active bottle: (+inf, −inf)
    for (int j = tid; j < M; j += NT) theta[j] = 0.0f;
    return;
  }

  for (int it = 0; it < iters;) {
    // the round's levels: tree node n (children 2n+1 below, 2n+2 above)
    // holds the midpoint of its bracket [a, c]
    float lv[L], a[L], c[L];
#pragma unroll
    for (int n = 0; n < L; ++n) {
      const int p = (n - 1) / 2;
      a[n] = n == 0 ? lo : (n & 1 ? a[p] : lv[p]);
      c[n] = n == 0 ? hi : (n & 1 ? lv[p] : c[p]);
      lv[n] = 0.5f * (a[n] + c[n]);
    }
    float s[L];
#pragma unroll
    for (int n = 0; n < L; ++n) s[n] = 0.0f;
    auto add = [&](float uj, float hj) {
#pragma unroll
      for (int n = 0; n < L; ++n) s[n] += clip(uj * (lv[n] - hj), 0.0f, b);
    };
#pragma unroll
    for (int k = 0; k < kJobs; ++k)
      if (k * NT < M) add(ru[k], rh[k]);
    for (int i = tid; i < smem_jobs; i += NT)
      add(tile[i], tile[smem_jobs + i]);
    for (int j = on_chip + tid; j < M; j += NT) {
      const float2 q = load(j);
      add(q.x, q.y);
    }
    sums.fold(s);
    // walk the tree: the steps a one-level bisection takes, bit for bit
    bool fixed = false;
    int node = 0;
#pragma unroll
    for (int d = 0; d < kLevelBits; ++d) {
      if (it < iters) {
        float m = lv[0], sm = s[0];
#pragma unroll
        for (int n = 1; n < L; ++n)
          if (n == node) m = lv[n], sm = s[n];
        if (sm < b) {
          fixed |= same_bits(m, lo);
          lo = m;
          node = 2 * node + 2;
        } else {
          fixed |= same_bits(m, hi);
          hi = m;
          node = 2 * node + 1;
        }
        ++it;
      }
    }
    if (fixed) break;   // every later step leaves (lo, hi) as they are
  }

  const float h = 0.5f * (lo + hi);
  auto level_theta = [&](float uj, float hj) {
    return uj > 0.0f ? clip(uj * (h - hj), 0.0f, b) : 0.0f;
  };
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    if (j < M) theta[j] = level_theta(ru[k], rh[k]);
  }
  for (int i = tid; i < smem_jobs; i += NT)
    theta[kTileJobs + i] = level_theta(tile[i], tile[smem_jobs + i]);
  for (int j = on_chip + tid; j < M; j += NT) {
    const float2 q = load(j);
    theta[j] = level_theta(q.x, q.y);
  }
}

// Jobs past the register tile that a block keeps in shared memory, each
// `fields` floats (kernel.py's job_tiles).
constexpr int smem_jobs_for(int K, int fields) {
  const int rest = K > kTileJobs ? K - kTileJobs : 0;
  const int cap = kSmemBytes / (4 * fields);
  return rest < cap ? rest : cap;
}

template <typename Kernel, typename... Args>
cudaError_t launch_tile(Kernel kernel, int threads, int N, int smem_jobs,
                        int fields, cudaStream_t stream, Args... args) {
  const int bytes = smem_jobs * fields * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<N, threads, bytes, stream>>>(args..., smem_jobs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

cudaError_t generic_waterfill_f32(const float* c, const float* A, int sA,
                                  const float* w, int sw, const float* g,
                                  int sg, const float* b, int sb,
                                  float* theta, int N, int K, int iters,
                                  int sigma, int threads, int smem_jobs,
                                  cudaStream_t stream) {
  if (smem_jobs != smem_jobs_for(K, 3) || (sigma != 1 && sigma != -1))
    return cudaErrorInvalidValue;
  if (N <= 0) return cudaGetLastError();
  const float s = static_cast<float>(sigma);
#define K1_LAUNCH(NT)                                                        \
  launch_tile(generic_waterfill_kernel<NT>, NT, N, smem_jobs, 3, stream, c, \
              A, sA, w, sw, g, sg, b, sb, theta, K, iters, s)
  switch (threads) {
    case 256: return K1_LAUNCH(256);
    case 512: return K1_LAUNCH(512);
    case 1024: return K1_LAUNCH(1024);
  }
#undef K1_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t hetero_waterfill_f32(const float* c, const float* A,
                                 const float* w, const float* g,
                                 const float* sg, const float* b,
                                 float* theta, int N, int K, int iters,
                                 int threads, int smem_jobs,
                                 cudaStream_t stream) {
  if (smem_jobs != smem_jobs_for(K, 6)) return cudaErrorInvalidValue;
  if (N <= 0) return cudaGetLastError();
#define K2_LAUNCH(NT)                                                       \
  launch_tile(hetero_waterfill_kernel<NT>, NT, N, smem_jobs, 6, stream, c, \
              A, w, g, sg, b, theta, K, iters)
  switch (threads) {
    case 256: return K2_LAUNCH(256);
    case 512: return K2_LAUNCH(512);
    case 1024: return K2_LAUNCH(1024);
  }
#undef K2_LAUNCH
  return cudaErrorInvalidValue;
}

cudaError_t gwf_waterfill_f32(const float* u, const float* h0, float b,
                              float* theta, int M, int iters, int threads,
                              int smem_jobs, cudaStream_t stream) {
  if (smem_jobs != smem_jobs_for(M, 2)) return cudaErrorInvalidValue;
  if (M <= 0) return cudaGetLastError();
#define K3_LAUNCH(NT)                                                       \
  launch_tile(gwf_waterfill_kernel<NT>, NT, 1, smem_jobs, 2, stream, u, h0, \
              b, theta, M, iters)
  switch (threads) {
    case 256: return K3_LAUNCH(256);
    case 512: return K3_LAUNCH(512);
    case 1024: return K3_LAUNCH(1024);
  }
#undef K3_LAUNCH
  return cudaErrorInvalidValue;
}

}  // extern "C"
