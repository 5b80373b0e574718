// Flash attention backward for Hopper (sm_90a): dq, dk, dv of K5's
// forward (flash_attention.cu) over pre-scaled q, with GQA/MQA, a causal
// mask, a sliding window and a logit softcap, from the forward's output O
// and its row log-sum-exp L, f32 inside, the inputs' type out.
//
// Replaces no TPU kernel: the JAX package trains through
// src/repro/models/attention.py::flash_attention_xla, plain jnp that
// autodiff differentiates; its Pallas forward
// (src/repro/kernels/flash_attention/kernel.py::flash_attention) has no
// VJP.  The port's forward is a ctypes call that autograd cannot see
// through, so training on the card needs this kernel behind a
// torch.autograd.Function (kernels/flash_attention/ops.py).
//
// The math, per (batch, query head h, query row i, key j):
//   s = q_i · k_j, s_c = cap·tanh(s / cap) (or s), P = exp(s_c − L_i)
//   where the mask lets (i, j) through, else 0;
//   dP = dO_i · v_j;  D_i = Σ_j P_ij dP_ij;  dS = P (dP − D_i) · s_c'
//   with s_c' = 1 − tanh²(s / cap) (1 without a softcap);
//   dV_j += P dO_i;  dK_j += dS q_i;  dQ_i += dS k_j;
//   dK and dV of kv head j / G sum over its G query heads.
// A row with no unmasked key (with a window, row ≥ T + window − 1) has,
// in the forward and its plain version, the uniform softmax over all T
// keys: there P = 1/T feeds dV, and dS = 0 (the plain version's masked
// scores are a constant, so dQ and dK take nothing from them).  Its L is
// not used: the kernel knows such rows by position.
//
// Bound on this card: operations.  At the training path's shape (llama
// 3.2-1b, q (4, 4096, 32, 64), k/v (4, 4096, 8, 64), causal) the valid
// pairs take 10·hd flops each (QKᵀ and dO·Vᵀ recomputed once, dV, dK,
// dQ: 2·hd each), 6.9e11 in all, 0.70 ms at the 989 TFLOP/s bf16
// tensor-core peak; the bytes (q, k, v, dO, L in; dq, dk, dv out) take
// 0.03 ms at 3.35 TB/s.  The kernels do 14·hd a pair (the products of
// the D pass, and QKᵀ and dO·Vᵀ in both kernels).
//
// D is the softmax backward's row sum Σ_j P_ij dP_ij, as autograd through
// the plain version computes it, and not FlashAttention's shortcut
// rowsum(dO ∘ O): in bf16 O is rounded, and D − dP is a cancellation
// wherever P is near one-hot (early causal rows, a biting softcap), so
// the shortcut moved dq by up to 0.1 of its scale at the training shape
// (a first H100 run).  It costs a second pass of QKᵀ and dO·Vᵀ in the dQ
// kernel, and the forward's output is not read.
//
// Design: right and deterministic first; no wgmma or TMA (a later
// redesign's work).  bf16 at hd ≤ 64 (the training path) runs every
// product on the tensor cores with mma.sync (below, "bf16 at hd ≤ 64");
// f32, and bf16 at hd > 64, run f32 FMAs from shared memory.  Two kernels
// a call either way, no atomics, so the same inputs give the same bits:
// - flash_attention_bwd_dq_kernel (first): one block per (query tile,
//   query head, batch); Q, dO and L stay in shared memory, dQ in
//   registers.  It walks the key tiles the forward's tile_walk visits
//   for its rows (rows with no unmasked key take nothing) twice: first
//   summing D from P and dP (written to a (B, H, S) f32 scratch for the
//   second kernel), then recomputing dS and accumulating dQ += dS K.
// - flash_attention_bwd_dkdv_kernel: one block of 256 threads per (key
//   tile of BK keys, kv head, batch).  K and V tiles stay in shared
//   memory, dK and dV in registers (BK·HD / 256 = 16 of each a thread);
//   the block walks the G query heads of its kv head and, for each, the
//   query tiles of BQ rows that can see its keys (the mirror of the
//   forward's tile_walk: from the tile's first key when causal, to its
//   last key + window − 1 with a window, to S − 1 where rows with no
//   unmasked key exist), loading Q, dO, L and D per tile, recomputing
//   P and dS (BQ × BK) into shared memory and accumulating
//   dV += Pᵀ dO and dK += dSᵀ Q.
// The FMA kernels' products run on a 16 × 16 grid of threads, each
// holding a register tile of rows 16 apart (thread (ty, tx) owns rows
// ty + 16·r and columns tx + 16·c), so that reads of a shared row are
// broadcasts and reads of 16 consecutive rows hit 16 banks (rows padded
// by one word).  Tiles:
// hd ≤ 64: BQ = BK = 64; hd ≤ 128: BQ 64, BK 32; hd ≤ 256: BQ 32, BK 16;
// shared memory 84–114 KB a block.  Columns past hd and rows past S or T
// load as zeros; every hd ≤ 256 runs on the instantiation of the next
// width of 64, 128 or 256.
//
// C interface: raw pointers, sizes, the mask options and the stream; each
// entry point launches its two kernels on that stream and returns the
// first cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;  // threads along each side of a product tile

template <int HD> struct Tiles;
template <> struct Tiles<64> {
  static constexpr int BQ = 64, BK = 64;
};
template <> struct Tiles<128> {
  static constexpr int BQ = 64, BK = 32;
};
template <> struct Tiles<256> {
  static constexpr int BQ = 32, BK = 16;
};

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
  return __float2bfloat16(x);
}

// The mask and the options of one call.
struct Opts {
  int S, T, H, K, hd, causal, window;
  float cap;
  // (i, j) is seen by the forward: j a real key within the causal limit
  // and the window of row i
  __device__ __forceinline__ bool allowed(int i, int j) const {
    if (j >= T) return false;
    if (causal && j > i) return false;
    return window <= 0 || i - j < window;
  }
  // row i has no unmasked key at all (only with a window)
  __device__ __forceinline__ bool keyless(int i) const {
    return window > 0 && static_cast<long>(i) >= static_cast<long>(T) +
                                                     window - 1;
  }
};

// Rows [row0, row0 + NROWS) of head `head` of x (B, L, NH, hd), batch
// row offset row_base = b·L, into the f32 tile dst (row stride LD);
// rows past L and columns past hd are zeros.
template <typename T, int HD, int NROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ x,
                                          long row_base, int L, int NH,
                                          int head, int hd, int row0) {
  constexpr int LD = HD + 1;
  for (int idx = threadIdx.x; idx < NROWS * HD; idx += kThreads) {
    const int r = idx / HD;
    const int c = idx - r * HD;
    const int row = row0 + r;
    dst[r * LD + c] =
        row < L && c < hd
            ? to_f32(x[((row_base + row) * NH + head) * static_cast<long>(hd) +
                       c])
            : 0.0f;
  }
}

// L (and D unless dd is null) of rows [row0, row0 + NROWS) of (b, h)
// into shared memory.
template <int NROWS>
__device__ __forceinline__ void load_rows_stats(float* Ls, float* Ds,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ dd,
                                                long base, int S, int row0) {
  for (int r = threadIdx.x; r < NROWS; r += kThreads) {
    const int row = row0 + r;
    Ls[r] = row < S ? lse[base + row] : 0.0f;
    if (dd != nullptr) Ds[r] = row < S ? dd[base + row] : 0.0f;
  }
}

// Scores and dP of the BQ × BK tile: s[i][j] = Q[ty + 16i] · K[tx + 16j]
// and dp[i][j] = dO[ty + 16i] · V[tx + 16j] over HD columns.
template <int HD, int RQ, int RK>
__device__ __forceinline__ void scores(float (&s)[RQ][RK], float (&dp)[RQ][RK],
                                       const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx) {
  constexpr int LD = HD + 1;
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < RK; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qa[RQ], oa[RQ], kb[RK], vb[RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      qa[i] = Qs[(ty + kGrid * i) * LD + d];
      oa[i] = dOs[(ty + kGrid * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < RK; ++j) {
      kb[j] = Ks[(tx + kGrid * j) * LD + d];
      vb[j] = Vs[(tx + kGrid * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], vb[j], dp[i][j]);
      }
  }
}

// P and dS of one (row i, key j) from its score s and dP (see the top).
__device__ __forceinline__ void p_ds(const Opts& o, int i, int j, float s,
                                     float dp, float L, float D, float& p,
                                     float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (i >= o.S || j >= o.T) return;
  if (o.keyless(i)) {
    p = 1.0f / static_cast<float>(o.T);
    return;
  }
  if (!o.allowed(i, j)) return;
  float sc = s, grad = 1.0f;
  if (o.cap > 0.0f) {
    const float t = tanhf(s / o.cap);
    sc = o.cap * t;
    grad = 1.0f - t * t;
  }
  p = expf(sc - L);
  ds = p * (dp - D) * grad;
}

// True when every (row, key) pair of rows [i_lo, i_hi] and keys [j_lo,
// j_hi] is one the forward saw and no row lacks an unmasked key: then
// P and dS need no mask (p_ds_open).
__device__ __forceinline__ bool pairs_open(const Opts& o, int i_lo, int i_hi,
                                           int j_lo, int j_hi) {
  if (i_hi >= o.S || j_hi >= o.T) return false;
  if (o.causal && j_hi > i_lo) return false;
  return o.window <= 0 || i_hi - j_lo < o.window;
}

// p_ds of a pair that pairs_open vouches for
__device__ __forceinline__ void p_ds_open(const Opts& o, float s, float dp,
                                          float L, float D, float& p,
                                          float& ds) {
  float sc = s, grad = 1.0f;
  if (o.cap > 0.0f) {
    const float t = tanhf(s / o.cap);
    sc = o.cap * t;
    grad = 1.0f - t * t;
  }
  p = expf(sc - L);
  ds = p * (dp - D) * grad;
}

// ---- dK and dV ------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ dd,
                                T* __restrict__ dk, T* __restrict__ dv,
                                const Opts o, int n_kt) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / kGrid, RK = BK / kGrid;  // score tile a thread
  constexpr int RC = HD / kGrid;                   // dK/dV columns a thread
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BQ * LP;
  float* Ls = dSs + BQ * LP;
  float* Ds = Ls + BQ;

  const int kt = blockIdx.x % n_kt;
  const int rest = blockIdx.x / n_kt;
  const int kvh = rest % o.K;
  const int b = rest / o.K;
  const int G = o.H / o.K;
  const int k0 = kt * BK;
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;

  load_tile<T, HD, BK>(Ks, k, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                       o.hd, k0);
  load_tile<T, HD, BK>(Vs, v, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                       o.hd, k0);

  // the query rows that can see keys k0 .. k_hi (the mirror of the
  // forward's tile_walk), and the rows with no unmasked key, which see
  // every key uniformly
  const int k_hi = min(k0 + BK, o.T) - 1;
  const int q_lo = o.causal ? k0 : 0;
  const bool any_keyless = o.keyless(o.S - 1);
  int q_hi = o.S - 1;
  if (o.window > 0 && !any_keyless) q_hi = min(q_hi, k_hi + o.window - 1);

  // dK, dV of key rows k0 + ty + 16r (RK of them), columns tx + 16c
  float accK[RK][RC], accV[RK][RC];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int c = 0; c < RC; ++c) accK[r][c] = accV[r][c] = 0.0f;

  if (q_lo <= q_hi) {
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const long stat = (static_cast<long>(b) * o.H + h) * o.S;
      for (int qt = q_lo / BQ; qt <= q_hi / BQ; ++qt) {
        const int q0 = qt * BQ;
        __syncthreads();  // the previous tile's P, dS, Q, dO are read
        load_tile<T, HD, BQ>(Qs, q, static_cast<long>(b) * o.S, o.S, o.H, h,
                             o.hd, q0);
        load_tile<T, HD, BQ>(dOs, dout, static_cast<long>(b) * o.S, o.S, o.H,
                             h, o.hd, q0);
        load_rows_stats<BQ>(Ls, Ds, lse, dd, stat, o.S, q0);
        __syncthreads();

        float s[RQ][RK], dp[RQ][RK];
        scores<HD, RQ, RK>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const int r = ty + kGrid * i;
#pragma unroll
          for (int j = 0; j < RK; ++j) {
            const int c = tx + kGrid * j;
            float p, ds;
            p_ds(o, q0 + r, k0 + c, s[i][j], dp[i][j], Ls[r], Ds[r], p, ds);
            Ps[r * LP + c] = p;
            dSs[r * LP + c] = ds;
          }
        }
        __syncthreads();

        // dV += Pᵀ dO, dK += dSᵀ Q over the tile's BQ rows
#pragma unroll 2
        for (int i = 0; i < BQ; ++i) {
          float pr[RK], dr[RK], og[RC], qg[RC];
#pragma unroll
          for (int r = 0; r < RK; ++r) {
            pr[r] = Ps[i * LP + ty + kGrid * r];
            dr[r] = dSs[i * LP + ty + kGrid * r];
          }
#pragma unroll
          for (int c = 0; c < RC; ++c) {
            og[c] = dOs[i * LD + tx + kGrid * c];
            qg[c] = Qs[i * LD + tx + kGrid * c];
          }
#pragma unroll
          for (int r = 0; r < RK; ++r)
#pragma unroll
            for (int c = 0; c < RC; ++c) {
              accV[r][c] = fmaf(pr[r], og[c], accV[r][c]);
              accK[r][c] = fmaf(dr[r], qg[c], accK[r][c]);
            }
        }
      }
    }
  }

  const long base = static_cast<long>(b) * o.T;
#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int row = k0 + ty + kGrid * r;
    if (row >= o.T) continue;
    const long off = ((base + row) * o.K + kvh) * static_cast<long>(o.hd);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + kGrid * c;
      if (col < o.hd) {
        dk[off + col] = from_f32<T>(accK[r][c]);
        dv[off + col] = from_f32<T>(accV[r][c]);
      }
    }
  }
}

// ---- dQ --------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              float* __restrict__ dd,
                              T* __restrict__ dq, const Opts o, int n_qt) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / kGrid, RK = BK / kGrid;
  constexpr int RC = HD / kGrid;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  float* Ls = dSs + BQ * LP;
  float* Ds = Ls + BQ;

  // block → (head fastest, then q tile from the last, then batch)
  const int h = blockIdx.x % o.H;
  const int rest = blockIdx.x / o.H;
  const int q0 = (n_qt - 1 - rest % n_qt) * BQ;
  const int b = rest / n_qt;
  const int kvh = h / (o.H / o.K);
  const int ty = threadIdx.x / kGrid, tx = threadIdx.x % kGrid;
  const long stat = (static_cast<long>(b) * o.H + h) * o.S;

  load_tile<T, HD, BQ>(Qs, q, static_cast<long>(b) * o.S, o.S, o.H, h, o.hd,
                       q0);
  load_tile<T, HD, BQ>(dOs, dout, static_cast<long>(b) * o.S, o.S, o.H, h,
                       o.hd, q0);
  load_rows_stats<BQ>(Ls, Ds, lse, nullptr, stat, o.S, q0);

  // the key tiles that hold an unmasked key of rows q0 .. q_hi (the
  // forward's tile_walk without its all-keys case: rows with no unmasked
  // key take nothing here)
  const int q_hi = min(q0 + BQ, o.S) - 1;
  const int k_hi = o.causal ? min(q_hi, o.T - 1) : o.T - 1;
  const int k_lo = o.window > 0 ? max(0, q0 - o.window + 1) : 0;
  auto load_kv = [&](int k0) {
    __syncthreads();  // the previous tile's K, V and dS are read
    load_tile<T, HD, BK>(Ks, k, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                         o.hd, k0);
    load_tile<T, HD, BK>(Vs, v, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                         o.hd, k0);
    __syncthreads();
  };

  // pass 1: D_i = Σ_j P_ij dP_ij; the 16 threads of a row group (one
  // half-warp) hold its partial sums
  float dsum[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) dsum[i] = 0.0f;
  if (k_lo <= k_hi) {
    for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
      const int k0 = kt * BK;
      load_kv(k0);
      float s[RQ][RK], dp[RQ][RK];
      scores<HD, RQ, RK>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          float p, ds;
          p_ds(o, q0 + r, k0 + tx + kGrid * j, s[i][j], dp[i][j], Ls[r],
               0.0f, p, ds);
          dsum[i] = fmaf(p, dp[i][j], dsum[i]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
#pragma unroll
    for (int off = kGrid / 2; off > 0; off >>= 1)
      dsum[i] += __shfl_xor_sync(0xffffffffu, dsum[i], off);
    const int r = ty + kGrid * i;
    if (tx == 0) {
      Ds[r] = dsum[i];
      if (q0 + r < o.S) dd[stat + q0 + r] = dsum[i];
    }
  }
  __syncthreads();

  // pass 2: dQ += dS K
  float acc[RQ][RC];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[i][c] = 0.0f;

  if (k_lo <= k_hi) {
    for (int kt = k_lo / BK; kt <= k_hi / BK; ++kt) {
      const int k0 = kt * BK;
      load_kv(k0);
      float s[RQ][RK], dp[RQ][RK];
      scores<HD, RQ, RK>(s, dp, Qs, dOs, Ks, Vs, ty, tx);
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int r = ty + kGrid * i;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int c = tx + kGrid * j;
          float p, ds;
          p_ds(o, q0 + r, k0 + c, s[i][j], dp[i][j], Ls[r], Ds[r], p, ds);
          dSs[r * LP + c] = ds;
        }
      }
      __syncthreads();

      // dQ += dS K over the tile's BK keys
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float dr[RQ], kg[RC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) dr[i] = dSs[(ty + kGrid * i) * LP + j];
#pragma unroll
        for (int c = 0; c < RC; ++c) kg[c] = Ks[j * LD + tx + kGrid * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < RC; ++c)
            acc[i][c] = fmaf(dr[i], kg[c], acc[i][c]);
      }
    }
  }

  const long base = static_cast<long>(b) * o.S;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + kGrid * i;
    if (row >= o.S) continue;
    const long off = ((base + row) * o.H + h) * static_cast<long>(o.hd);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = tx + kGrid * c;
      if (col < o.hd) dq[off + col] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---- bf16 at hd ≤ 64: the products on the tensor cores ------------------
// The same two kernels with every product an mma.sync.m16n8k16 (bf16 in,
// f32 accumulate) on register fragments gathered from bf16 tiles in
// shared memory.  Blocks of 4 warps own 64 query rows (dQ) or 64 keys
// (dK/dV), 16 a warp, and walk tiles of 64 keys or rows as the f32 kernels
// do.  Scores and dP stay in registers in the accumulator layout (row g
// and g + 8 of the warp's 16, columns 2t and 2t + 1 of each 8-wide
// n-tile, g = lane / 4, t = lane % 4), which is also the A layout of the
// next product once two n-tiles are packed to bf16: P (for dV) and dS
// (for dK and dQ) are rounded to bf16 there, as FlashAttention-2 rounds
// them.  The dK/dV kernel computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ, keys as
// rows, so that Pᵀ and dSᵀ are A operands without a transpose; the B
// operands of dV, dK and dQ read transposed copies (dOᵀ, Qᵀ, Kᵀ) written
// beside the tiles when they are loaded.  Rows of the tiles are padded
// by 16 bytes, so a fragment's 32 lanes read 32 banks.

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMT = 64;        // query rows and keys of a tile; hd ≤ kMT
constexpr int kLDB = kMT + 8;  // bf16 row stride of a shared tile

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 of shared memory as one register, the lower
// address in the low half (mma's order within a register)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_pair(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + kMT) of head `head` of x (B, L, NH, hd ≤ kMT),
// batch row offset row_base, into the bf16 tile dst (row r at r·kLDB) and,
// unless dstT is null, its transpose (column c at c·kLDB); zeros past L
// and hd.
__device__ __forceinline__ void load_tile_mma(
    __nv_bfloat16* dst, __nv_bfloat16* dstT,
    const __nv_bfloat16* __restrict__ x, long row_base, int L, int NH,
    int head, int hd, int row0) {
  if (hd == kMT && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    // 16-byte copies: a row of hd = 64 is eight of them
    for (int idx = threadIdx.x; idx < kMT * kMT / 8; idx += kMmaThreads) {
      const int r = idx / (kMT / 8);
      const int c = (idx - r * (kMT / 8)) * 8;
      const int row = row0 + r;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row < L)
        val = *reinterpret_cast<const uint4*>(
            x + ((row_base + row) * NH + head) * static_cast<long>(kMT) + c);
      *reinterpret_cast<uint4*>(dst + r * kLDB + c) = val;
      if (dstT != nullptr) {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dstT[(c + i) * kLDB + r] = e[i];
      }
    }
    return;
  }
  for (int idx = threadIdx.x; idx < kMT * kMT; idx += kMmaThreads) {
    const int r = idx / kMT;
    const int c = idx - r * kMT;
    const int row = row0 + r;
    const __nv_bfloat16 val =
        row < L && c < hd
            ? x[((row_base + row) * NH + head) * static_cast<long>(hd) + c]
            : __float2bfloat16(0.0f);
    dst[r * kLDB + c] = val;
    if (dstT != nullptr) dstT[c * kLDB + r] = val;
  }
}

// acc (16 × 64) += A · Bᵀ over the tiles' 64 columns: A the warp's rows
// arow .. arow + 15 of tile As, B the 64 rows of tile Bs (acc[j] holds
// Bs rows 8j .. 8j + 7).
__device__ __forceinline__ void mma_rows_by_rows(float (&acc)[kMT / 8][4],
                                                 const __nv_bfloat16* As,
                                                 int arow,
                                                 const __nv_bfloat16* Bs,
                                                 int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kMT / 16; ++kk) {
    const __nv_bfloat16* a0 = As + (arow + g) * kLDB + 16 * kk + 2 * t;
    const uint32_t a[4] = {ld_pair(a0), ld_pair(a0 + 8 * kLDB),
                           ld_pair(a0 + 8), ld_pair(a0 + 8 * kLDB + 8)};
#pragma unroll
    for (int j = 0; j < kMT / 8; ++j) {
      const __nv_bfloat16* b = Bs + (8 * j + g) * kLDB + 16 * kk + 2 * t;
      mma16816(acc[j], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

// acc (16 × 64) += C · Bᵀᵀ: A the bf16 rounding of the warp's 16 × 64
// accumulator-layout tile c (its columns the product's k), B[k][n] =
// BsT[n][k] (a transposed tile).
__device__ __forceinline__ void mma_frags_by_cols(float (&acc)[kMT / 8][4],
                                                  const float (&c)[kMT / 8][4],
                                                  const __nv_bfloat16* BsT,
                                                  int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kMT / 16; ++kk) {
    const uint32_t a[4] = {pack_pair(c[2 * kk][0], c[2 * kk][1]),
                           pack_pair(c[2 * kk][2], c[2 * kk][3]),
                           pack_pair(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                           pack_pair(c[2 * kk + 1][2], c[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < kMT / 8; ++n) {
      const __nv_bfloat16* b = BsT + (8 * n + g) * kLDB + 16 * kk + 2 * t;
      mma16816(acc[n], a, ld_pair(b), ld_pair(b + 8));
    }
  }
}

__device__ __forceinline__ void zero_frags(float (&x)[kMT / 8][4]) {
#pragma unroll
  for (int j = 0; j < kMT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

constexpr size_t kMmaDqSmem =
    5 * kMT * kLDB * sizeof(__nv_bfloat16) + kMT * sizeof(float);
constexpr size_t kMmaDkdvSmem =
    6 * kMT * kLDB * sizeof(__nv_bfloat16) + 2 * kMT * sizeof(float);

__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                  const __nv_bfloat16* __restrict__ k,
                                  const __nv_bfloat16* __restrict__ v,
                                  const __nv_bfloat16* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  float* __restrict__ dd,
                                  __nv_bfloat16* __restrict__ dq,
                                  const Opts o, int n_qt) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* dOs = Qs + kMT * kLDB;
  __nv_bfloat16* Ks = dOs + kMT * kLDB;
  __nv_bfloat16* Vs = Ks + kMT * kLDB;
  __nv_bfloat16* KTs = Vs + kMT * kLDB;
  float* Ls = reinterpret_cast<float*>(KTs + kMT * kLDB);

  const int h = blockIdx.x % o.H;
  const int rest = blockIdx.x / o.H;
  const int q0 = (n_qt - 1 - rest % n_qt) * kMT;
  const int b = rest / n_qt;
  const int kvh = h / (o.H / o.K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;            // the warp's first tile row
  const int qa = q0 + r0 + g;          // the lane's two rows
  const long stat = (static_cast<long>(b) * o.H + h) * o.S;

  load_tile_mma(Qs, nullptr, q, static_cast<long>(b) * o.S, o.S, o.H, h,
                o.hd, q0);
  load_tile_mma(dOs, nullptr, dout, static_cast<long>(b) * o.S, o.S, o.H, h,
                o.hd, q0);
  for (int r = threadIdx.x; r < kMT; r += kMmaThreads)
    Ls[r] = q0 + r < o.S ? lse[stat + q0 + r] : 0.0f;

  const int q_hi = min(q0 + kMT, o.S) - 1;
  const int k_hi = o.causal ? min(q_hi, o.T - 1) : o.T - 1;
  const int k_lo = o.window > 0 ? max(0, q0 - o.window + 1) : 0;
  auto load_kv = [&](int k0, bool transposed) {
    __syncthreads();  // the previous tile is read
    load_tile_mma(Ks, transposed ? KTs : nullptr, k,
                  static_cast<long>(b) * o.T, o.T, o.K, kvh, o.hd, k0);
    load_tile_mma(Vs, nullptr, v, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                  o.hd, k0);
    __syncthreads();
  };
  __syncthreads();
  const float La = Ls[r0 + g], Lb = Ls[r0 + g + 8];

  // pass 1: D of the lane's two rows, summed over its quad
  float da = 0.0f, db = 0.0f;
  float s[kMT / 8][4], dp[kMT / 8][4];
  if (k_lo <= k_hi) {
    for (int kt = k_lo / kMT; kt <= k_hi / kMT; ++kt) {
      const int k0 = kt * kMT;
      load_kv(k0, false);
      zero_frags(s);
      zero_frags(dp);
      mma_rows_by_rows(s, Qs, r0, Ks, lane);
      mma_rows_by_rows(dp, dOs, r0, Vs, lane);
      const bool open = pairs_open(o, q0 + r0, q0 + r0 + 15, k0, k0 + kMT - 1);
#pragma unroll
      for (int j = 0; j < kMT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, ds;
          if (open)
            p_ds_open(o, s[j][e], dp[j][e], e < 2 ? La : Lb, 0.0f, p, ds);
          else
            p_ds(o, e < 2 ? qa : qa + 8, k0 + 8 * j + 2 * t + (e & 1),
                 s[j][e], dp[j][e], e < 2 ? La : Lb, 0.0f, p, ds);
          if (e < 2)
            da = fmaf(p, dp[j][e], da);
          else
            db = fmaf(p, dp[j][e], db);
        }
    }
  }
  da += __shfl_xor_sync(0xffffffffu, da, 1);
  da += __shfl_xor_sync(0xffffffffu, da, 2);
  db += __shfl_xor_sync(0xffffffffu, db, 1);
  db += __shfl_xor_sync(0xffffffffu, db, 2);
  if (t == 0) {
    if (qa < o.S) dd[stat + qa] = da;
    if (qa + 8 < o.S) dd[stat + qa + 8] = db;
  }

  // pass 2: dQ += dS K
  float acc[kMT / 8][4];
  zero_frags(acc);
  if (k_lo <= k_hi) {
    for (int kt = k_lo / kMT; kt <= k_hi / kMT; ++kt) {
      const int k0 = kt * kMT;
      load_kv(k0, true);
      zero_frags(s);
      zero_frags(dp);
      mma_rows_by_rows(s, Qs, r0, Ks, lane);
      mma_rows_by_rows(dp, dOs, r0, Vs, lane);
      const bool open = pairs_open(o, q0 + r0, q0 + r0 + 15, k0, k0 + kMT - 1);
#pragma unroll
      for (int j = 0; j < kMT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, ds;
          if (open)
            p_ds_open(o, s[j][e], dp[j][e], e < 2 ? La : Lb,
                      e < 2 ? da : db, p, ds);
          else
            p_ds(o, e < 2 ? qa : qa + 8, k0 + 8 * j + 2 * t + (e & 1),
                 s[j][e], dp[j][e], e < 2 ? La : Lb, e < 2 ? da : db, p,
                 ds);
          s[j][e] = ds;
        }
      mma_frags_by_cols(acc, s, KTs, lane);
    }
  }

  const long base = static_cast<long>(b) * o.S;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int row = e < 2 ? qa : qa + 8;
    if (row >= o.S) continue;
    const long off = ((base + row) * o.H + h) * static_cast<long>(o.hd);
#pragma unroll
    for (int n = 0; n < kMT / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < o.hd) dq[off + col] = __float2bfloat16(acc[n][e]);
      if (col + 1 < o.hd) dq[off + col + 1] = __float2bfloat16(acc[n][e + 1]);
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads)
flash_attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                                    const __nv_bfloat16* __restrict__ k,
                                    const __nv_bfloat16* __restrict__ v,
                                    const __nv_bfloat16* __restrict__ dout,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ dd,
                                    __nv_bfloat16* __restrict__ dk,
                                    __nv_bfloat16* __restrict__ dv,
                                    const Opts o, int n_kt) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Vs = Ks + kMT * kLDB;
  __nv_bfloat16* Qs = Vs + kMT * kLDB;
  __nv_bfloat16* dOs = Qs + kMT * kLDB;
  __nv_bfloat16* QTs = dOs + kMT * kLDB;
  __nv_bfloat16* dOTs = QTs + kMT * kLDB;
  float* Ls = reinterpret_cast<float*>(dOTs + kMT * kLDB);
  float* Ds = Ls + kMT;

  const int kt = blockIdx.x % n_kt;
  const int rest = blockIdx.x / n_kt;
  const int kvh = rest % o.K;
  const int b = rest / o.K;
  const int G = o.H / o.K;
  const int k0 = kt * kMT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = warp * 16;           // the warp's first key of the tile
  const int ka = k0 + kr0 + g;         // the lane's two keys

  load_tile_mma(Ks, nullptr, k, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                o.hd, k0);
  load_tile_mma(Vs, nullptr, v, static_cast<long>(b) * o.T, o.T, o.K, kvh,
                o.hd, k0);

  const int k_hi = min(k0 + kMT, o.T) - 1;
  const int q_lo = o.causal ? k0 : 0;
  int q_hi = o.S - 1;
  if (o.window > 0 && !o.keyless(o.S - 1))
    q_hi = min(q_hi, k_hi + o.window - 1);

  float accK[kMT / 8][4], accV[kMT / 8][4];
  zero_frags(accK);
  zero_frags(accV);
  float st[kMT / 8][4], dpt[kMT / 8][4];
  if (q_lo <= q_hi) {
    for (int gh = 0; gh < G; ++gh) {
      const int h = kvh * G + gh;
      const long stat = (static_cast<long>(b) * o.H + h) * o.S;
      for (int qt = q_lo / kMT; qt <= q_hi / kMT; ++qt) {
        const int q0 = qt * kMT;
        __syncthreads();  // the previous tile is read
        load_tile_mma(Qs, QTs, q, static_cast<long>(b) * o.S, o.S, o.H, h,
                      o.hd, q0);
        load_tile_mma(dOs, dOTs, dout, static_cast<long>(b) * o.S, o.S, o.H,
                      h, o.hd, q0);
        for (int r = threadIdx.x; r < kMT; r += kMmaThreads) {
          Ls[r] = q0 + r < o.S ? lse[stat + q0 + r] : 0.0f;
          Ds[r] = q0 + r < o.S ? dd[stat + q0 + r] : 0.0f;
        }
        __syncthreads();

        zero_frags(st);
        zero_frags(dpt);
        mma_rows_by_rows(st, Ks, kr0, Qs, lane);   // Sᵀ: keys × rows
        mma_rows_by_rows(dpt, Vs, kr0, dOs, lane); // dPᵀ
        const bool open = pairs_open(o, q0, q0 + kMT - 1, k0 + kr0,
                                     k0 + kr0 + 15);
#pragma unroll
        for (int j = 0; j < kMT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            float p, ds;
            if (open)
              p_ds_open(o, st[j][e], dpt[j][e], Ls[c], Ds[c], p, ds);
            else
              p_ds(o, q0 + c, e < 2 ? ka : ka + 8, st[j][e], dpt[j][e],
                   Ls[c], Ds[c], p, ds);
            st[j][e] = p;
            dpt[j][e] = ds;
          }
        mma_frags_by_cols(accV, st, dOTs, lane);   // dV += Pᵀ dO
        mma_frags_by_cols(accK, dpt, QTs, lane);   // dK += dSᵀ Q
      }
    }
  }

  const long base = static_cast<long>(b) * o.T;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int key = e < 2 ? ka : ka + 8;
    if (key >= o.T) continue;
    const long off = ((base + key) * o.K + kvh) * static_cast<long>(o.hd);
#pragma unroll
    for (int n = 0; n < kMT / 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < o.hd) {
        dk[off + col] = __float2bfloat16(accK[n][e]);
        dv[off + col] = __float2bfloat16(accV[n][e]);
      }
      if (col + 1 < o.hd) {
        dk[off + col + 1] = __float2bfloat16(accK[n][e + 1]);
        dv[off + col + 1] = __float2bfloat16(accV[n][e + 1]);
      }
    }
  }
}

int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* dout,
               const float* lse, float* dd, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, int B, const Opts& o,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_mma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMmaDqSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMmaDkdvSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (o.T + kMT - 1) / kMT;
  const int n_qt = (o.S + kMT - 1) / kMT;
  const long blocks1 = static_cast<long>(n_kt) * o.K * B;
  const long blocks2 = static_cast<long>(n_qt) * o.H * B;
  if (blocks1 > 0x7fffffffL || blocks2 > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_bwd_dq_mma_kernel<<<static_cast<unsigned>(blocks2),
                                      kMmaThreads, kMmaDqSmem, stream>>>(
      q, k, v, dout, lse, dd, dq, o, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks1 == 0) return static_cast<int>(err);
  flash_attention_bwd_dkdv_mma_kernel<<<static_cast<unsigned>(blocks1),
                                        kMmaThreads, kMmaDkdvSmem, stream>>>(
      q, k, v, dout, lse, dd, dk, dv, o, n_kt);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
constexpr size_t dkdv_smem() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * BK * (HD + 1) + 2 * BQ * (HD + 1) +
                          2 * BQ * (BK + 1) + 2 * BQ);
}
template <int HD>
constexpr size_t dq_smem() {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  return sizeof(float) * (2 * BQ * (HD + 1) + 2 * BK * (HD + 1) +
                          BQ * (BK + 1) + 2 * BQ);
}

template <typename T, int HD>
int launch_hd(const T* q, const T* k, const T* v, const T* dout,
              const float* lse, float* dd, T* dq, T* dk, T* dv, int B,
              const Opts& o, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, HD>;
  auto dqk = flash_attention_bwd_dq_kernel<T, HD>;
  constexpr size_t b1 = dkdv_smem<HD>(), b2 = dq_smem<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(b1));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(b2));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (o.T + BK - 1) / BK;
  const int n_qt = (o.S + BQ - 1) / BQ;
  const long blocks1 = static_cast<long>(n_kt) * o.K * B;
  const long blocks2 = static_cast<long>(n_qt) * o.H * B;
  if (blocks1 > 0x7fffffffL || blocks2 > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  // dQ first: it writes D, which dK/dV read
  dqk<<<static_cast<unsigned>(blocks2), kThreads, b2, stream>>>(
      q, k, v, dout, lse, dd, dq, o, n_qt);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks1 == 0) return static_cast<int>(err);
  dkdv<<<static_cast<unsigned>(blocks1), kThreads, b1, stream>>>(
      q, k, v, dout, lse, dd, dk, dv, o, n_kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, void* dd, void* dq, void* dk, void* dv, int B,
           int S, int T_len, int H, int K, int hd, int causal, int window,
           float cap, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || H % K != 0 || hd <= 0 || hd > 256 || T_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Opts o{S, T_len, H, K, hd, causal, window, cap};
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* gp = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  float* dp = static_cast<float*>(dd);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (hd <= kMT)
      return launch_mma(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, o, stream);
  }
  if (hd <= 64)
    return launch_hd<T, 64>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, o,
                            stream);
  if (hd <= 128)
    return launch_hd<T, 128>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, o,
                             stream);
  return launch_hd<T, 256>(qp, kp, vp, gp, lp, dp, dqp, dkp, dvp, B, o,
                           stream);
}

}  // namespace

extern "C" {

// q and dout (B, S, H, hd), k/v (B, T, K, hd) of one dtype; lse (B, H,
// S) f32 from the forward; dd (B, H, S) f32 scratch for D; dq, dk, dv
// outputs shaped as q, k, v.  window <= 0: no window; cap <= 0: no
// softcap.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse, void* dd,
                            void* dq, void* dk, void* dv, int B, int S,
                            int T, int H, int K, int hd, int causal,
                            int window, float cap, void* stream) {
  return launch<float>(q, k, v, dout, lse, dd, dq, dk, dv, B, S, T, H, K, hd,
                       causal, window, cap, stream);
}

int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, void* dd,
                             void* dq, void* dk, void* dv, int B, int S,
                             int T, int H, int K, int hd, int causal,
                             int window, float cap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, dd, dq, dk, dv, B, S, T,
                               H, K, hd, causal, window, cap, stream);
}

}  // extern "C"
