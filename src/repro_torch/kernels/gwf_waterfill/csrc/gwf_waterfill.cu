// Water-filling kernels for Hopper (sm_90a): the three bisection solves of
// the paper's General Water-Filling step, in float32.
//
// Every kernel is a fixed-count bisection whose step is an elementwise map
// over the job axis followed by one sum.  One thread block owns one
// instance: its threads walk the instance's jobs in a strided loop (so any
// K works, with no padding), each step ends in a block reduction (warp
// shuffles, then the per-warp partials through shared memory, summed in
// the same order by every thread), and the bracket stays in registers.
// Instances are independent, so the grid's order does not matter.
//
// Precision: logf/expf (the accurate library versions, not __logf/__expf;
// the build passes no --use_fast_math) stand in for the power function, as
// exp/log did in the TPU kernels.  Each is within 2 ulp, so a power
// x^e = expf(e·logf(x)) carries about (1 + |e ln x|) ulp, and θ = σ(x^e − w)
// that much of |w + σθ| in absolute terms: about 1e-4 for a saturating job
// with w = 80.  chip_smoke.py holds each kernel against its plain version
// per row in units of the mean allocation b / k_act (limits 1e-2 for K1
// and K3, 1e-1 for K2, whose saturating jobs leave that 1e-4), and K1 and
// K2 to their KKT conditions as well, since the final rescale would hide
// a wrong λ from a row sum; the JAX kernel tests' tolerances stay as
// outer bounds.
//
// The C interface takes raw pointers, sizes, the iteration count and the
// stream; every entry point launches on that stream and returns
// cudaGetLastError().  The wrapper in kernel.py allocates the outputs.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr float kF32Big = 1e30f;   // float32 stand-in for an infinite s'(0)

enum Op { kSum, kMin, kMax };

// Block-wide reduction over NT threads; every thread returns the same
// value.  The leading __syncthreads keeps a call from overwriting
// partials an earlier call is still reading.
template <Op op, int NT = kThreads>
__device__ float block_reduce(float v, float* partial) {
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = op == kSum ? v + u : (op == kMin ? fminf(v, u) : fmaxf(v, u));
  }
  __syncthreads();
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = partial[0];
  for (int i = 1; i < NT / 32; ++i) {
    float u = partial[i];
    r = op == kSum ? r + u : (op == kMin ? fminf(r, u) : fmaxf(r, u));
  }
  return r;
}

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float log_mid(float lo, float hi) {
  return expf(0.5f * (logf(lo) + logf(hi)));
}

// ---------------------------------------------------------------------------
// K1 — generic_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::generic_waterfill
// (body _generic_wf_kernel).  Batched CAP for one shared regular family
// s'(θ) = A(w + σθ)^γ: per instance a log-space bisection on λ until
// Σ θ_i(λ) = b with θ_i = clip(σ((c_i λ/A)^{1/γ} − w), 0, b), jobs with
// c_i λ ≥ s'(0) parked, c = 0 inactive; then θ is rescaled onto b.
// Bound on this card: operations.  Each of the iters + 1 passes costs one
// logf and one expf per job against 8 bytes per job moved once, so at
// N·K = 1M jobs the transcendental work outweighs the traffic.  The
// design keeps every pass on chip: c is re-read through L1 (16 KB per
// instance at K = 4096), only the bracket and one partial sum per warp
// leave registers, and θ is written once.
// par is (N, 8): A, w, 1/γ, b, λ_lo, λ_hi, s'(0), unused.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
generic_waterfill_kernel(const float* __restrict__ c,
                         const float* __restrict__ par,
                         float* __restrict__ theta, int K, int iters,
                         float sigma) {
  __shared__ float partial[kThreads / 32];
  const size_t row = blockIdx.x;
  const float* cr = c + row * K;
  float* tr = theta + row * K;
  const float* p = par + row * 8;
  const float A = p[0], w = p[1], ginv = p[2], b = p[3];
  const float ds0 = p[6];
  float lo = p[4], hi = p[5];

  auto theta_of = [&](float ci, float lam) {
    if (!(ci > 0.0f)) return 0.0f;
    float y = ci * lam;
    float th = clip(sigma * (expf(ginv * logf(y / A)) - w), 0.0f, b);
    return y >= ds0 ? 0.0f : th;
  };

  for (int it = 0; it < iters; ++it) {
    float mid = log_mid(lo, hi);
    float s = 0.0f;
    for (int i = threadIdx.x; i < K; i += kThreads) s += theta_of(cr[i], mid);
    s = block_reduce<kSum>(s, partial);
    if (s > b) lo = mid; else hi = mid;   // β > b ⇒ λ* right of mid
  }
  float lam = log_mid(lo, hi);
  float s = 0.0f;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    float th = theta_of(cr[i], lam);
    tr[i] = th;
    s += th;
  }
  float tot = block_reduce<kSum>(s, partial);
  // exact budget: rescale the fp residual onto the positive allocations;
  // each thread rescales only the elements it wrote
  for (int i = threadIdx.x; i < K; i += kThreads) {
    float th = tr[i];
    if (tot > 0.0f) th *= b / tot;
    tr[i] = fminf(th, b);
  }
}

// ---------------------------------------------------------------------------
// K2 — hetero_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::hetero_waterfill
// (body _hetero_wf_kernel).  The same bisection with job-indexed A, w, γ,
// σ (paper §7); the λ-bracket and each job's parking threshold s_i'(0)
// are computed in the kernel.  Every power is guarded (base clamped to
// 1e-30, inactive base 1), so padding lanes cannot NaN the sums.
// Bound on this card: operations (two transcendentals per job and pass
// against 24 bytes per job moved once).  The per-job threshold s_i'(0)
// costs two more transcendentals, so the first pass stores it in θ's own
// slot — each thread later reads back only the slots it wrote — and the
// bisection passes pay for one power each.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float guarded_pow(float base, float e) {
  return expf(e * logf(fmaxf(base, 1e-30f)));
}

__global__ void __launch_bounds__(kThreads)
hetero_waterfill_kernel(const float* __restrict__ c,
                        const float* __restrict__ A,
                        const float* __restrict__ w,
                        const float* __restrict__ g,
                        const float* __restrict__ sg,
                        const float* __restrict__ b_arr,
                        float* __restrict__ theta, int K, int iters) {
  __shared__ float partial[kThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * K;
  const float b = b_arr[blockIdx.x];
  float* tr = theta + off;

  // pass 1: active count, then the bracket and the parking thresholds
  float n_act = 0.0f;
  for (int i = threadIdx.x; i < K; i += kThreads)
    n_act += c[off + i] > 0.0f ? 1.0f : 0.0f;
  n_act = fmaxf(block_reduce<kSum>(n_act, partial), 1.0f);
  const float eps = b / (8.0f * n_act);

  float lo_part = CUDART_INF_F, hi_part = -CUDART_INF_F;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const size_t j = off + i;
    const float ci = c[j], Ai = A[j], wi = w[j], gi = g[j], si = sg[j];
    const float ds_b = Ai * guarded_pow(wi + si * b, gi);
    const float ds0 = wi > 0.0f ? Ai * guarded_pow(wi, gi) : kF32Big;
    const float ds_top = wi > 0.0f ? ds0 : Ai * guarded_pow(wi + si * eps, gi);
    tr[i] = ds0;
    if (ci > 0.0f) {
      lo_part = fminf(lo_part, ds_b / ci);
      hi_part = fmaxf(hi_part, ds_top / ci);
    }
  }
  float lo = block_reduce<kMin>(lo_part, partial);
  float hi = block_reduce<kMax>(hi_part, partial) * (1.0f + 1e-6f);
  hi = fmaxf(hi, lo * (1.0f + 1e-6f));
  // fabsf(x) < inf is false for inf and NaN alike
  const bool good = fabsf(lo) < CUDART_INF_F && lo > 0.0f &&
                    fabsf(hi) < CUDART_INF_F;
  if (!good) { lo = 1.0f; hi = 2.0f; }

  auto theta_of = [&](int i, float lam) {
    const size_t j = off + i;
    const float ci = c[j];
    if (!(ci > 0.0f)) return 0.0f;
    const float y = ci * lam;
    const float th = clip(sg[j] * (guarded_pow(y / A[j], 1.0f / g[j]) - w[j]),
                          0.0f, b);
    return y >= tr[i] ? 0.0f : th;      // tr[i] holds s_i'(0) here
  };

  for (int it = 0; it < iters; ++it) {
    float mid = log_mid(lo, hi);
    float s = 0.0f;
    for (int i = threadIdx.x; i < K; i += kThreads) s += theta_of(i, mid);
    s = block_reduce<kSum>(s, partial);
    if (s > b) lo = mid; else hi = mid;
  }
  const float lam = log_mid(lo, hi);
  float s = 0.0f;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float th = theta_of(i, lam);
    tr[i] = th;                          // s_i'(0) is no longer needed
    s += th;
  }
  const float tot = block_reduce<kSum>(s, partial);
  for (int i = threadIdx.x; i < K; i += kThreads) {
    float th = tr[i];
    if (tot > 0.0f) th *= b / tot;
    tr[i] = fminf(th, b);
  }
}

// ---------------------------------------------------------------------------
// K3 — gwf_waterfill.
// Replaces src/repro/kernels/gwf_waterfill/kernel.py::gwf_waterfill (body
// _wf_kernel).  Single-instance rectangle-bottle WFP (paper §4.5.1):
// bisection on the level h with Σ clip(u_i (h − h0_i), 0, b) = b, then θ
// from h; u = 0 marks an inactive bottle.
// Bound on this card: neither bytes nor operations but latency — one
// instance is one block on one of 132 SMs, and each of the iters steps
// waits for a block reduction.  The design keeps the step short (no
// transcendentals, 1024 threads so K = 4096 is four jobs per thread) and
// leaves batching instances, which would fill the card, to K1.
// ---------------------------------------------------------------------------
constexpr int kLevelThreads = 1024;

__global__ void __launch_bounds__(kLevelThreads)
gwf_waterfill_kernel(const float* __restrict__ u,
                     const float* __restrict__ h0, float b,
                     float* __restrict__ theta, int M, int iters) {
  __shared__ float partial[kLevelThreads / 32];
  // bracket: β(lo) ≤ b ≤ β(hi)
  float lo_part = CUDART_INF_F, hi_part = -CUDART_INF_F;
  for (int i = threadIdx.x; i < M; i += kLevelThreads) {
    if (u[i] > 0.0f) {
      lo_part = fminf(lo_part, h0[i]);
      hi_part = fmaxf(hi_part, h0[i] + b / fmaxf(u[i], 1e-30f));
    }
  }
  float lo = block_reduce<kMin, kLevelThreads>(lo_part, partial);
  float hi = block_reduce<kMax, kLevelThreads>(hi_part, partial);
  for (int it = 0; it < iters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.0f;
    for (int i = threadIdx.x; i < M; i += kLevelThreads)
      s += clip(u[i] * (mid - h0[i]), 0.0f, b);
    s = block_reduce<kSum, kLevelThreads>(s, partial);
    if (s < b) lo = mid; else hi = mid;
  }
  const float h = 0.5f * (lo + hi);
  for (int i = threadIdx.x; i < M; i += kLevelThreads)
    theta[i] = clip(u[i] * (h - h0[i]), 0.0f, b);
}

}  // namespace

extern "C" {

cudaError_t generic_waterfill_f32(const float* c, const float* par,
                                  float* theta, int N, int K, int iters,
                                  int sigma, cudaStream_t stream) {
  if (N > 0)
    generic_waterfill_kernel<<<N, kThreads, 0, stream>>>(
        c, par, theta, K, iters, static_cast<float>(sigma));
  return cudaGetLastError();
}

cudaError_t hetero_waterfill_f32(const float* c, const float* A,
                                 const float* w, const float* g,
                                 const float* sg, const float* b,
                                 float* theta, int N, int K, int iters,
                                 cudaStream_t stream) {
  if (N > 0)
    hetero_waterfill_kernel<<<N, kThreads, 0, stream>>>(c, A, w, g, sg, b,
                                                        theta, K, iters);
  return cudaGetLastError();
}

cudaError_t gwf_waterfill_f32(const float* u, const float* h0, float b,
                              float* theta, int M, int iters,
                              cudaStream_t stream) {
  gwf_waterfill_kernel<<<1, kLevelThreads, 0, stream>>>(u, h0, b, theta, M,
                                                        iters);
  return cudaGetLastError();
}

}  // extern "C"
