// Flash attention forward for Hopper (sm_90a): blocked online-softmax
// attention over pre-scaled q, with GQA/MQA, a causal mask, a sliding
// window and a logit softcap, f32 running statistics and accumulator, and
// the output in q's type.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention
// (body _flash_kernel).  The TPU kernel walks a sequential grid
// (B·H, q tiles, kv tiles) with (m, l, acc) in VMEM scratch carried over
// the innermost kv axis, pads S and T to its tiles, and visits every kv
// tile.
//
// Bound on this card: operations.  At the serving path's shape (q
// (2, 4096, 10, 256), k/v (2, 4096, 1, 256), window 2048) the valid
// (q, k) pairs take 4·hd flops each, ~1.3e11 in all against ~92 MB of
// q, k, v and o.
//
// Design (the simple version; tensor cores, TMA and warp specialisation
// are for a later change):
// - One block of 256 threads per (q tile of 64 rows, q head, batch).  A
//   loop over kv tiles of 64 keys takes the place of the TPU's sequential
//   grid axis; m, l and the 64 × hd accumulator stay on chip for the
//   whole loop (m, l in shared memory, acc in registers, 4 rows × hd/16
//   columns per thread).
// - The kv head is h / (H / K), so MQA and GQA read each kv head's tiles
//   directly; no repeated K/V is materialised.
// - Only the kv tiles that can hold an unmasked key for the tile's rows
//   are visited: from max(0, q_lo - window + 1) to q_hi when causal.
//   Within a tile the mask is by position, as the TPU kernel's is.
// - Ragged S and T are handled by bounds checks (rows and keys past the
//   end load as zeros and are never stored or get p = 0): no padded
//   copies.
// - Masked scores are the -1e30 sentinel of the JAX code, not -inf: a row
//   whose first visited tile is all masked then carries exp(0) garbage in
//   l and acc, which exp(m_old - m_new) = 0 wipes at its first real key;
//   -inf would give -inf - (-inf) = NaN.  Keys past T are -inf instead,
//   which is safe since m never drops below -1e30: they add nothing to l
//   or acc even in a row that has no unmasked key.
// - A row with no unmasked key at all (with a window, row >= T + window
//   - 1) has, in the plain version, the uniform softmax over all T keys.
//   A q tile holding such a row visits every kv tile, so that row sums
//   exp(0) over exactly the T keys and divides by T.
// - p is rounded to the value type before the p·V product (both JAX
//   versions do), while l sums p in f32; the end divides by max(l, 1e-30).
// - q, k and v tiles are held in shared memory as f32 (one row padded by
//   one float against bank conflicts).  At hd = 256 that is 214 KB of
//   dynamic shared memory, above the 48 KB static limit, so the launch
//   raises the limit with cudaFuncSetAttribute and reports a refused
//   launch through cudaGetLastError().
// - QK^T and PV are computed in this kernel's own loops with f32 FMAs.
//
// C interface: raw pointers, sizes, the mask options and the stream; each
// entry point launches on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;         // q rows per block
constexpr int kBKV = 64;        // keys per kv tile
constexpr int kPS = kBKV + 1;   // row stride of the score tile
constexpr float kNegInf = -1e30f;   // a masked key; a key past T is -inf

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
// p rounded to the value type and back (identity for f32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBKV) * (HD + 1) + kBQ * kPS +
          2 * kBQ + kBQ);
}

// Load rows [row0, row0 + nrows) of one head of x (B, L, NH, hd) into
// dst (nrows × (HD + 1) floats); rows past L and columns past hd load 0.
template <typename T, int HD>
__device__ void load_tile(float* dst, const T* __restrict__ x, int b, int L,
                          int NH, int head, int hd, int row0, int nrows) {
  constexpr int HDP = HD + 1;
  for (int e = threadIdx.x; e < nrows * HD; e += kThreads) {
    const int r = e / HD;
    const int d = e - r * HD;
    const int row = row0 + r;
    float val = 0.0f;
    if (row < L && d < hd) {
      val = to_f32(x[((static_cast<long>(b) * L + row) * NH + head) * hd + d]);
    }
    dst[r * HDP + d] = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int T_len, int H, int K, int hd, int causal,
                       int window, float cap) {
  constexpr int HDP = HD + 1;
  constexpr int NJ = HD / 16;   // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * HDP;
  float* Vs = Ks + kBKV * HDP;
  float* Ps = Vs + kBKV * HDP;
  float* row_m = Ps + kBQ * kPS;
  float* row_l = row_m + kBQ;
  float* row_alpha = row_l + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const int tid = threadIdx.x;
  const int ty = tid / 16;      // rows ty*4 .. ty*4+3
  const int tx = tid % 16;      // columns tx + 16*j

  load_tile<T, HD>(Qs, q, b, S, H, h, hd, q0, kBQ);
  if (tid < kBQ) {
    row_m[tid] = kNegInf;
    row_l[tid] = 0.0f;
  }

  // kv range that can hold an unmasked key for rows q0 .. q_hi
  const int q_hi = min(q0 + kBQ, S) - 1;
  const int k_hi = causal ? min(q_hi, T_len - 1) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  // this tile holds a row with no unmasked key: visit every kv tile
  const bool empty_row =
      window > 0 && static_cast<long>(q_hi) >= static_cast<long>(T_len) +
                                                   window - 1;
  const int kt_lo = empty_row ? 0 : k_lo / kBKV;
  const int kt_hi = empty_row ? (T_len + kBKV - 1) / kBKV - 1
                    : k_hi < k_lo ? kt_lo - 1 : k_hi / kBKV;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBKV;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, HD>(Ks, k, b, T_len, K, kvh, hd, k0, kBKV);
    load_tile<T, HD>(Vs, v, b, T_len, K, kvh, hd, k0, kBKV);
    __syncthreads();

    // scores: rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * HDP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * HDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        float x = s[i][j];
        if (cap > 0.0f) x = cap * tanhf(x / cap);
        bool ok = true;
        if (causal) ok = qp >= kp;
        if (window > 0) ok = ok && (qp - kp) < window;
        Ps[r * kPS + c] = kp >= T_len ? -CUDART_INF_F : ok ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: four adjacent lanes per row, 16 keys each
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* prow = Ps + r * kPS + part * 16;
      float mt = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mt = fmaxf(mt, prow[c]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mt);
      float lsum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        lsum += p;
        prow[c] = round_to<T>(p);
      }
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + lsum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + P·V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_alpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < kBKV; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * HDP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qp = q0 + r;
    if (qp >= S) continue;
    const float inv = 1.0f / fmaxf(row_l[r], 1e-30f);
    T* orow = o + ((static_cast<long>(b) * S + qp) * H + h) * hd;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o, int B,
              int S, int T_len, int H, int K, int hd, int causal, int window,
              float cap, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_len, H, K, hd,
      causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_len, int H, int K, int hd, int causal, int window,
           float cap, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (hd <= 64)
    return launch_hd<T, 64>(q, k, v, o, B, S, T_len, H, K, hd, causal,
                            window, cap, stream);
  if (hd <= 128)
    return launch_hd<T, 128>(q, k, v, o, B, S, T_len, H, K, hd, causal,
                             window, cap, stream);
  if (hd <= 256)
    return launch_hd<T, 256>(q, k, v, o, B, S, T_len, H, K, hd, causal,
                             window, cap, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// window <= 0: no window; cap <= 0: no softcap.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T, int H, int K, int hd, int causal,
                        int window, float cap, void* stream) {
  return launch<float>(q, k, v, o, B, S, T, H, K, hd, causal, window, cap,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int B, int S, int T, int H, int K, int hd,
                         int causal, int window, float cap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, hd, causal, window,
                               cap, stream);
}

}  // extern "C"
