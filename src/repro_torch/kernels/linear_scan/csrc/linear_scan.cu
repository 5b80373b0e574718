// Linear recurrence scan for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t,
// h_{-1} = 0, over (B, S, D) inputs, the state in float32 and the output in
// the inputs' type.
//
// Replaces src/repro/kernels/linear_scan/kernel.py::linear_scan (body
// _scan_kernel): the shared recurrence of RG-LRU (D = lru_width) and, in a
// later slice, Mamba-1.  The TPU kernel tiles D onto the vector lanes and
// walks sequence chunks in its sequential grid, with a log-doubling scan
// inside each chunk and the carry in VMEM scratch.
//
// Bound on this card: bytes.  Each (b, t, d) element is read twice (a and
// b) and written once, two operations per element against 12 bytes in
// float32, far below the card's ratio of operations to bytes.
//
// Design: one thread per (b, d) lane walks t = 0 … S-1 in order, so the
// state never leaves a register and nothing crosses threads.  Neighbouring
// threads own neighbouring d, so each step's loads and stores are
// coalesced.  The loads of kUnroll steps are issued before their
// arithmetic, which keeps that many loads in flight per thread while the
// dependent chain of multiply-adds runs.  At B = 2, D = 2560 that is 5,120
// lanes, 40 blocks of 128: less than one wave on 132 SMs, so the kernel
// cannot reach the memory rate; a chunked two-pass scan (per-chunk
// products, then the carry) would fill the card and is left for a later
// change.
//
// Precision: the recurrence is summed in sequence order with fmaf.  The
// JAX model's chunked associative scan sums in another order, so results
// agree to float32 rounding accumulated over the sequence, not bitwise.
//
// C interface: raw pointers, sizes and the stream; each entry point
// launches on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ y, int B, int S, int D) {
  const long lane = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= static_cast<long>(B) * D) return;
  const long bi = lane / D;
  const long d = lane - bi * D;
  const long base = bi * S * D + d;
  float h = 0.0f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long off = base + static_cast<long>(t + u) * D;
      av[u] = to_f32(a[off]);
      bv[u] = to_f32(b[off]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, bv[u]);
      y[base + static_cast<long>(t + u) * D] = from_f32<T>(h);
    }
  }
  for (; t < S; ++t) {
    const long off = base + static_cast<long>(t) * D;
    h = fmaf(to_f32(a[off]), h, to_f32(b[off]));
    y[off] = from_f32<T>(h);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int D,
           void* stream) {
  const long lanes = static_cast<long>(B) * D;
  const int blocks = static_cast<int>((lanes + kThreads - 1) / kThreads);
  if (blocks > 0 && S > 0) {
    linear_scan_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<T*>(y), B, S, D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int linear_scan_f32(const void* a, const void* b, void* y, int B, int S,
                    int D, void* stream) {
  return launch<float>(a, b, y, B, S, D, stream);
}

int linear_scan_bf16(const void* a, const void* b, void* y, int B, int S,
                     int D, void* stream) {
  return launch<__nv_bfloat16>(a, b, y, B, S, D, stream);
}

}  // extern "C"
