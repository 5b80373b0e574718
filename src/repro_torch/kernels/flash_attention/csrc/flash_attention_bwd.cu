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
// 0.03 ms at 3.35 TB/s.  The kernels do 18·hd a pair: the D pass (QKᵀ
// and dO·Vᵀ, 4·hd), the dQ pass (both again and dS·K, 6·hd) and dK/dV
// (Sᵀ, dPᵀ, Pᵀ·dO and dSᵀ·Q, 8·hd); at the bf16 peak that floor is 1.25
// ms at the path's shape.
//
// D is the softmax backward's row sum Σ_j P_ij dP_ij, as autograd through
// the plain version computes it, and not FlashAttention's shortcut
// rowsum(dO ∘ O): in bf16 O is rounded, and D − dP is a cancellation
// wherever P is near one-hot (early causal rows, a biting softcap), so
// the shortcut moved dq by up to 0.1 of its scale at the training shape
// (a first H100 run).  It costs a second pass of QKᵀ and dO·Vᵀ in the dQ
// kernel, and the forward's output is not read.
//
// Routing, by shape (the wrapper's bwd_geometry, kernel.py, decides and
// passes the route, tiles, grids and shared memory; the entry points
// refuse a geometry that does not match their instantiations):
// - bf16 with rows of whole 16-byte pieces and 16-byte-aligned tensors:
//   the wgmma kernels below (hd ≤ 64 on the instantiation of 64 columns,
//   hd ≤ 128 of 128, else of 256; columns past hd read as zeros).
// - f32, and rows that are not whole 16-byte pieces: the f32-FMA kernels
//   (hd ≤ 64, 128, 256 on the instantiation of that width).
// Two kernels a call either way, dQ first (it writes D to a (B, H, S) f32
// scratch that dK/dV read), no atomics, so the same inputs give the same
// bits.
//
// Design, wgmma (bf16; the tiles below are hd ≤ 128's, hd 256's follow):
// FlashAttention-3's shape on K5's forward's parts (hopper_ptx.cuh).  A
// block is three warpgroups: two consumer warpgroups of 64 rows (or
// keys) each, and a producer
// warpgroup of which one warp starts the copies; setmaxnreg moves
// registers from the producer (24 a thread) to the consumers (240).
// Tiles are TMA boxes of 64 columns in the 128-byte-swizzled layout that
// wgmma reads; copies complete on full mbarriers, and the consumers hand
// a stage back on its empty mbarrier (one arrival a consumer warp), a
// ring of four stages.
// - flash_attention_bwd_dq_wgmma_kernel: one block per (128 query rows,
//   query head, batch), the longest causal walks first.  Q and dO are
//   loaded once; the producer streams 64-key K and V tiles over the key
//   tiles the forward's tile_walk visits for the block's rows, twice.
//   Pass 1: S = Q·Kᵀ and dP = dO·Vᵀ by wgmma with both operands in
//   shared memory (K-major), two tiles in flight (the next tile's
//   products run while P ∘ dP of this one is summed); D summed in
//   registers, reduced over the lanes of a row and written to the
//   scratch.  Pass 2: S and dP again,
//   dS in registers, packed to bf16 as the A operand of dQ += dS·K,
//   with K read MN-major (the transpose bit) from the same tile: no
//   transposed copy; that product runs on while the next tile's S and
//   dP are started.
// - flash_attention_bwd_dkdv_wgmma_kernel: one block per (128 keys, kv
//   head, batch), the key tiles with the longest causal walks first.  K
//   and V are loaded once; the producer warp streams 64-row Q and dO
//   tiles, with their rows' L (times log2 e) and D written to the stage
//   by its lanes, over the G query heads and the query tiles that can
//   see the block's keys (from the first key when causal, to the last
//   key + window − 1 with a window, to S − 1 where rows with no unmasked
//   key exist).  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (keys as rows) from shared
//   memory; Pᵀ and dSᵀ stay in the accumulator layout, which is the A
//   layout of wgmma with A in registers, and dV += Pᵀ·dO, dK += dSᵀ·Q
//   read dO and Q MN-major.
// - Inside a warpgroup the products overlap the exponentials: S and dP
//   are two commit groups, so without a softcap P is formed while dP is
//   still being multiplied, and in dK/dV the product dV += Pᵀ·dO runs
//   while dS is formed.  With a softcap both are waited for first (dS
//   needs tanh's derivative beside P).
// - P and dS are rounded to bf16 where they are packed (as
//   FlashAttention-2 rounds them); P = exp2(s_c·log2 e − L·log2 e) by
//   ex2.approx.
// - A warpgroup skips the products of a tile in which none of its pairs
//   is seen and no row lacks an unmasked key (pairs_closed); a warp
//   whose 16 rows (or keys) see the whole tile skips the mask
//   (pairs_open).
// - Registers at hd = 128: a dK/dV consumer thread holds dK and dV (64 +
//   64 f32), Sᵀ and dPᵀ (32 + 32) and the packed Pᵀ and dSᵀ (16 + 16);
//   none spills at 240.
// - Shared memory (bytes, with 1 KB of alignment slack; 72 more of
//   barriers), 4 stages: dQ kernel Q + dO + the stages' K + V 99,328 at
//   hd 64, 197,632 at hd 128; dK/dV kernel K + V + the stages' Q + dO +
//   L + D 101,376 at hd 64, 199,680 at hd 128.  The wrapper asks for at
//   least 118,784, so that one block holds an SM and setmaxnreg finds
//   the registers it moves.
// - dQ, dK and dV are staged as bf16 in the warpgroup's own Q (or K and
//   V) rows of shared memory and stored in 16-byte pieces.
// - hd 256 (Wg<256>): with the tiles above a dQ stage of 64 keys would
//   be 64 KB, and dK + dV of a warpgroup's 64 keys 256 f32 a thread, past
//   setmaxnreg's 240.  So the dQ kernel keeps its 128 rows (one
//   warpgroup a 64-row half, dQ 128 f32 a thread, as m64n256k16 with dS
//   from registers) and streams tiles of 32 keys (S and dP m64n32k16)
//   through a ring of three stages: Q + dO 131,072 bytes, the stages
//   98,304, 230,400 with the slack.  The D pass keeps its two tiles in
//   flight (S and dP of 32 keys are 16 + 16 f32 a thread).  A dK/dV block
//   owns 64 keys, and both consumer warpgroups take all 64, each its half
//   of dK's and dV's columns (64 + 64 f32 a thread, as at hd 128): each
//   computes the block's whole Sᵀ and dPᵀ (64 keys × 64 rows) and runs
//   dV[:, half] += Pᵀ·dO[:, half] and dK[:, half] += dSᵀ·Q[:, half] with
//   Pᵀ and dSᵀ from its registers.  Sᵀ and dPᵀ are multiplied twice (the
//   pair costs 22·hd flops, not 18·hd), in exchange for no shared P, no
//   barrier between the warpgroups a tile and the registers of hd 128's
//   kernel; the grid is T / 64 × K × B (128 blocks at recurrentgemma's
//   local layer, one wave).  Its ring has two stages of 64 rows of Q and
//   dO: K + V 65,536 bytes, the stages 131,072 and their L and D 1,024,
//   198,656 with the slack.  A pass-2 warpgroup of the dQ kernel holds
//   the stage of the tile whose dQ product is in flight until its next
//   computed tile; the tiles it skips are at the ends of its walk (two at
//   most at the end, causal), fewer than the ring's stages less one, so
//   the producer never waits on a stage so held.
//
// Design, FMA (f32 and bf16 rows that are not 16-byte pieces): the same
// two kernels and walks in f32 FMAs from shared memory, 256 threads a
// block on a 16 × 16 grid of threads, each holding a register tile of
// rows 16 apart (thread (ty, tx) owns rows ty + 16·r and columns tx +
// 16·c), so that reads of a shared row are broadcasts and reads of 16
// consecutive rows hit 16 banks (rows padded by one word).  Tiles: hd ≤ 64: BQ = BK = 64; hd ≤ 128:
// BQ 64, BK 32; hd ≤ 256: BQ 32, BK 16; shared memory 84–114 KB a block.
// Columns past hd and rows past S or T load as zeros.
//
// C interface: raw pointers, sizes, the mask options, the geometry and
// the stream; each entry point launches its two kernels on that stream
// and returns the first cudaGetLastError() that is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"

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
// P and dS need no mask.
__device__ __forceinline__ bool pairs_open(const Opts& o, int i_lo, int i_hi,
                                           int j_lo, int j_hi) {
  if (i_hi >= o.S || j_hi >= o.T) return false;
  if (o.causal && j_hi > i_lo) return false;
  return o.window <= 0 || i_hi - j_lo < o.window;
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
// ---- bf16: wgmma fed by TMA -------------------------------------------------

constexpr int kWgThreads = 384;     // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerRegs = 240;  // setmaxnreg: 2·128·240 + 128·24 ≤ 64 K
constexpr int kProducerRegs = 24;
constexpr int kRowsDq = 128;        // query rows a dQ block
constexpr int kKeysDq = 64;         // keys a streamed K/V tile of the dQ kernel
constexpr int kKeysDkdv = 128;      // keys a dK/dV block
constexpr int kRowsDkdv = 64;       // query rows a streamed Q/dO tile
constexpr int kStages = 4;          // each ring's stages
// at hd 256, where a 64-key K/V stage of the dQ kernel is 64 KB and dK
// and dV of 64 keys are 256 f32 a consumer thread:
constexpr int kKeysDq256 = 32;      // keys a streamed K/V tile of the dQ kernel
constexpr int kKeysDkdv256 = 64;    // keys a dK/dV block, each consumer half
                                    // of the columns of all of them
constexpr int kStagesDq256 = 3;     // the dQ kernel's ring
constexpr int kStagesDkdv256 = 2;   // the dK/dV kernel's ring
constexpr float kLog2e = 1.4426950408889634f;

// The tiles of the wgmma kernels at width HD, and the dynamic shared
// memory they need from a 1 KB alignment slack.
template <int HD> struct Wg {
  static constexpr bool wide = HD > 128;
  static constexpr int keys_dq = wide ? kKeysDq256 : kKeysDq;
  static constexpr int keys_dkdv = wide ? kKeysDkdv256 : kKeysDkdv;
  static constexpr int stages_dq = wide ? kStagesDq256 : kStages;
  static constexpr int stages_dkdv = wide ? kStagesDkdv256 : kStages;
  // the columns of dK and dV a consumer warpgroup holds
  static constexpr int cols_dkdv = wide ? HD / 2 : HD;
  static constexpr size_t smem_dq =
      1024 + sizeof(__nv_bfloat16) * HD *
                 (2 * kRowsDq + stages_dq * 2 * keys_dq);
  static constexpr size_t smem_dkdv =
      1024 +
      sizeof(__nv_bfloat16) * HD *
          (2 * keys_dkdv + stages_dkdv * 2 * kRowsDkdv) +
      sizeof(float) * stages_dkdv * 2 * kRowsDkdv;
};

// TMA maps of q, k, v and dO
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// The position of the n-th tile in a ring of NS stages: its stage, and
// the parity of the stage's phases (the consumers wait for it on full,
// the producer for the one before on empty).
template <int NS> struct Ring {
  int stage;
  uint32_t parity;
  __device__ __forceinline__ explicit Ring(int n)
      : stage(n % NS), parity((n / NS) & 1) {}
};

// True when no (row, key) pair of rows [i_lo, i_hi] and keys [j_lo,
// j_hi] is one the forward saw and no row of them lacks an unmasked key:
// then P = dS = 0 over the whole tile.
__device__ __forceinline__ bool pairs_closed(const Opts& o, int i_lo,
                                             int i_hi, int j_lo, int j_hi) {
  if (i_lo >= o.S || j_lo >= o.T) return true;
  if (o.keyless(min(i_hi, o.S - 1))) return false;  // such rows come last
  if (o.causal && j_lo > i_hi) return true;
  return o.window > 0 && i_lo - j_hi >= o.window;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P of (row i, key j) from its score s without a softcap, L2 = L·log2 e
// (see p_ds at the top for the masked cases)
__device__ __forceinline__ float p_of(const Opts& o, int i, int j, float s,
                                      float L2) {
  if (i >= o.S || j >= o.T) return 0.0f;
  if (o.keyless(i)) return 1.0f / static_cast<float>(o.T);
  return o.allowed(i, j) ? ex2(fmaf(s, kLog2e, -L2)) : 0.0f;
}
// dS from P without a softcap: 0 for a row with no unmasked key (P = 0
// already gives 0 where the mask bites)
__device__ __forceinline__ float ds_of(const Opts& o, int i, float p,
                                       float dp, float D) {
  return o.keyless(i) ? 0.0f : p * (dp - D);
}
// p_ds with a softcap and L2 = L·log2 e; open: a pair pairs_open vouches
// for
__device__ __forceinline__ void p_ds_cap(const Opts& o, bool open, int i,
                                         int j, float s, float dp, float L2,
                                         float D, float& p, float& ds) {
  p = 0.0f;
  ds = 0.0f;
  if (!open) {
    if (i >= o.S || j >= o.T) return;
    if (o.keyless(i)) {
      p = 1.0f / static_cast<float>(o.T);
      return;
    }
    if (!o.allowed(i, j)) return;
  }
  const float t = tanhf(s / o.cap);
  p = ex2(fmaf(o.cap * t, kLog2e, -L2));
  ds = p * (dp - D) * (1.0f - t * t);
}

// Starts d = A · Bᵀ (64 × RB) over HD columns: A the warpgroup's 64 rows
// at shared address a in a tile of RA rows, B a tile of RB rows (32 or
// 64) at b, both K-major (swz_at).  The caller fences, commits and waits.
template <int HD, int RA, int RB>
__device__ __forceinline__ void wgmma_ss_tile(float (&d)[RB / 8][4],
                                              uint32_t a, uint32_t b) {
  using namespace hopper;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    // k16 step ks: 64-column block ks / 4, 32 bytes a step inside it
    const uint32_t off = (ks & 3) * 32;
    wgmma_ss<RB>(d, gmma_desc(a + (ks >> 2) * RA * 128 + off, 16, 1024),
                 gmma_desc(b + (ks >> 2) * RB * 128 + off, 16, 1024), ks > 0);
  }
}

// Starts s = A1 · B1ᵀ and t = A2 · B2ᵀ as two commit groups, in that
// order (wgmma_ss_tile's operands).
template <int HD, int RA, int RB>
__device__ __forceinline__ void wgmma_ss_pair(float (&s)[RB / 8][4],
                                              float (&t)[RB / 8][4],
                                              uint32_t a1, uint32_t b1,
                                              uint32_t a2, uint32_t b2) {
  using namespace hopper;
  hold(s);
  hold(t);
  wgmma_fence();
  wgmma_ss_tile<HD, RA, RB>(s, a1, b1);
  wgmma_commit();
  wgmma_ss_tile<HD, RA, RB>(t, a2, b2);
  wgmma_commit();
  hold(s);
  hold(t);
}

// Starts acc (64 × N) += A · B over KR k: A the packed fragments a
// (pack_a), B N columns of a tile of KR rows (the k) at shared address
// bt, read MN-major: two groups of 8 rows a k16 step (sbo 1 KB), N / 64
// blocks of 64 columns KR rows of 128 bytes apart (lbo).  The caller
// fences, commits and waits.
template <int N, int KR>
__device__ __forceinline__ void wgmma_rs_tile(float (&acc)[N / 8][4],
                                              const uint32_t (&a)[KR / 16][4],
                                              uint32_t bt) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < KR / 16; ++kk)
    wgmma_rs<N>(acc, a[kk], gmma_desc(bt + kk * 16 * 128, KR * 128, 1024));
}

// a consumer warp hands a stage back once its lanes are done with it
__device__ __forceinline__ void release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(bar);
}

// Columns [c0, c0 + NC) of the warp's 16 rows [tr, tr + 16) of a tile of
// R rows in shared memory (swz_at, bf16) to rows row0 + r of head `head`
// of x (B, L, NH, hd): 16-byte pieces, rows past L and columns past hd
// not stored.
template <int NC, int R>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ x,
                                           const __nv_bfloat16* tile, int tr,
                                           long row_base, int row0, int L,
                                           int NH, int head, int hd,
                                           int c0 = 0) {
  constexpr int CPR = NC / 8;  // 16-byte pieces a row
  for (int idx = threadIdx.x & 31; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR;
    const int c = c0 + (idx - r * CPR) * 8;
    const int row = row0 + r;
    if (row < L && c < hd)
      *reinterpret_cast<int4*>(
          x + ((row_base + row) * NH + head) * static_cast<long>(hd) + c) =
          *reinterpret_cast<const int4*>(tile + hopper::swz_at(R, tr + r, c));
  }
}

// the lane's accumulator fragment (rows tr + g and tr + g + 8 of the warp,
// columns c0 + 8n + 2t, + 1) as bf16 into a tile of R rows (swz_at)
template <int NC, int R>
__device__ __forceinline__ void stage_frags(__nv_bfloat16* tile,
                                            const float (&acc)[NC / 8][4],
                                            int tr, int lane, int c0 = 0) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(
        tile + hopper::swz_at(R, tr + g, c0 + 8 * n + 2 * t)) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(
        tile + hopper::swz_at(R, tr + g + 8, c0 + 8 * n + 2 * t)) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dq_wgmma_kernel(const float* __restrict__ lse,
                                    float* __restrict__ dd,
                                    __nv_bfloat16* __restrict__ dq,
                                    const Opts o, int n_qt,
                                    const __grid_constant__ BwdMaps maps) {
  using namespace hopper;
  constexpr int kKeys = Wg<HD>::keys_dq;  // keys a streamed K/V tile
  constexpr int kNJ = kKeys / 8;          // its n-tiles of S and dP
  constexpr int kNS = Wg<HD>::stages_dq;  // the ring's stages
  using Rg = Ring<kNS>;
  constexpr int kTileQ = kRowsDq * HD;  // elements of Q (and of dO)
  constexpr int kTileK = kKeys * HD;    // of a stage's K (and V)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t mis = smem_addr(smem_raw) & 1023;
  __nv_bfloat16* Qs =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (mis ? 1024 - mis : 0));
  __nv_bfloat16* dOs = Qs + kTileQ;
  __nv_bfloat16* KVs = dOs + kTileQ;  // stage s: K at KVs + 2s·kTileK, V after
  __shared__ alignas(8) uint64_t full[kNS], empty[kNS], qbar;

  // block → (head fastest, then q tile from the last, then batch)
  const int h = blockIdx.x % o.H;
  const int rest = blockIdx.x / o.H;
  const int q0 = (n_qt - 1 - rest % n_qt) * kRowsDq;
  const int b = rest / n_qt;
  const int kvh = h / (o.H / o.K);
  // the key tiles that hold an unmasked key of rows q0 .. q_hi (the
  // forward's tile_walk without its all-keys case: rows with no unmasked
  // key take nothing here)
  const int q_hi = min(q0 + kRowsDq, o.S) - 1;
  const int k_hi = o.causal ? min(q_hi, o.T - 1) : o.T - 1;
  const int k_lo = o.window > 0 ? max(0, q0 - o.window + 1) : 0;
  const int kt_lo = k_lo / kKeys;
  const int kt_hi = k_lo <= k_hi ? k_hi / kKeys : kt_lo - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init(&qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // the producer: one thread copies Q and dO, then K and V tiles for
    // both passes
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect(&qbar, 2 * kTileQ * sizeof(__nv_bfloat16));
      for (int kb = 0; kb < HD / 64; ++kb) {
        tma_load(Qs + kb * kRowsDq * 64, &maps.q, &qbar, kb * 64, h, q0, b);
        tma_load(dOs + kb * kRowsDq * 64, &maps.dout, &qbar, kb * 64, h, q0,
                 b);
      }
      int n = 0;
      for (int pass = 0; pass < 2; ++pass) {
        for (int kt = kt_lo; kt <= kt_hi; ++kt, ++n) {
          const Rg r(n);
          mbar_wait(&empty[r.stage], r.parity ^ 1);
          __nv_bfloat16* Ks = KVs + r.stage * 2 * kTileK;
          mbar_expect(&full[r.stage], 2 * kTileK * sizeof(__nv_bfloat16));
          for (int kb = 0; kb < HD / 64; ++kb) {
            tma_load(Ks + kb * kKeys * 64, &maps.k, &full[r.stage], kb * 64,
                     kvh, kt * kKeys, b);
            tma_load(Ks + kTileK + kb * kKeys * 64, &maps.v, &full[r.stage],
                     kb * 64, kvh, kt * kKeys, b);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_wg = q0 + wg * 64;       // the warpgroup's first query row
    const int tr = wg * 64 + warp * 16;  // the warp's first row of the tile
    const int qa = q0 + tr + g;          // the lane's rows qa and qa + 8
    const long stat = (static_cast<long>(b) * o.H + h) * o.S;
    const float La = qa < o.S ? lse[stat + qa] * kLog2e : 0.0f;
    const float Lb = qa + 8 < o.S ? lse[stat + qa + 8] * kLog2e : 0.0f;
    const uint32_t q_addr = smem_addr(Qs) + wg * 64 * 128;
    const uint32_t o_addr = smem_addr(dOs) + wg * 64 * 128;
    const bool cap = o.cap > 0.0f;

    // S = Q Kᵀ and dP = dO Vᵀ of the warpgroup's rows and the tile at
    // stage st; without a softcap s becomes P while dP is multiplied.
    // The lane's (row, key) of element (j, e): (qa + 8·(e >> 1), k0 + 8j
    // + 2t + (e & 1)).
    float s[kNJ][4], dp[kNJ][4];
    auto scores = [&](int st, int k0, bool open) {
      const uint32_t k_addr = smem_addr(KVs + st * 2 * kTileK);
      wgmma_ss_pair<HD, kRowsDq, kKeys>(s, dp, q_addr, k_addr, o_addr,
                                        k_addr + kTileK * 2);
      if (!cap) {
        wgmma_wait<1>();
        hold(s);
        if (open) {
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = ex2(fmaf(s[j][e], kLog2e, e < 2 ? -La : -Lb));
        } else {
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = p_of(o, e < 2 ? qa : qa + 8,
                             k0 + 8 * j + 2 * t + (e & 1), s[j][e],
                             e < 2 ? La : Lb);
        }
      }
      wgmma_wait<0>();
      hold(s);
      hold(dp);
    };
    // s ← P and dp ← dS
    auto probs = [&](int k0, bool open, float Da, float Db) {
      if (!cap) {
        if (open) {
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? Da : Db));
        } else {
#pragma unroll
          for (int j = 0; j < kNJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[j][e] = ds_of(o, e < 2 ? qa : qa + 8, s[j][e], dp[j][e],
                               e < 2 ? Da : Db);
        }
        return;
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p_ds_cap(o, open, e < 2 ? qa : qa + 8, k0 + 8 * j + 2 * t + (e & 1),
                   s[j][e], dp[j][e], e < 2 ? La : Lb, e < 2 ? Da : Db,
                   s[j][e], dp[j][e]);
    };
    mbar_wait(&qbar, 0);

    int n = 0;
    // pass 1: D of the lane's two rows, summed over its quad.  Two tiles
    // are in flight: S and dP of the next tile are multiplied while the
    // lanes form P and P ∘ dP of this one, in the other registers.
    float da = 0.0f, db = 0.0f;
    float s1[kNJ][4], dp1[kNJ][4];
    // waits for tile i's stage and starts its S and dP as one commit
    // group (an empty one where the warpgroup sees none of the tile's
    // pairs); true when started
    auto start = [&](int i, float (&sx)[kNJ][4], float (&dpx)[kNJ][4]) {
      const Rg r(n + i);
      mbar_wait(&full[r.stage], r.parity);
      const int k0 = (kt_lo + i) * kKeys;
      const bool go = !pairs_closed(o, r_wg, r_wg + 63, k0, k0 + kKeys - 1);
      const uint32_t k_addr = smem_addr(KVs + r.stage * 2 * kTileK);
      hold(sx);
      hold(dpx);
      wgmma_fence();
      if (go) {
        wgmma_ss_tile<HD, kRowsDq, kKeys>(sx, q_addr, k_addr);
        wgmma_ss_tile<HD, kRowsDq, kKeys>(dpx, o_addr, k_addr + kTileK * 2);
      }
      wgmma_commit();
      hold(sx);
      hold(dpx);
      return go;
    };
    // once tile i's group is in: hands its stage back and adds its P ∘ dP
    auto finish = [&](int i, bool go, float (&sx)[kNJ][4],
                      float (&dpx)[kNJ][4]) {
      hold(sx);
      hold(dpx);
      release(&empty[Rg(n + i).stage]);
      if (!go) return;
      const int k0 = (kt_lo + i) * kKeys;
      const bool open =
          pairs_open(o, q0 + tr, q0 + tr + 15, k0, k0 + kKeys - 1);
      if (cap) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float ds;
            p_ds_cap(o, open, e < 2 ? qa : qa + 8,
                     k0 + 8 * j + 2 * t + (e & 1), sx[j][e], dpx[j][e],
                     e < 2 ? La : Lb, 0.0f, sx[j][e], ds);
          }
      } else if (open) {
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sx[j][e] = ex2(fmaf(sx[j][e], kLog2e, e < 2 ? -La : -Lb));
      } else {
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sx[j][e] = p_of(o, e < 2 ? qa : qa + 8,
                            k0 + 8 * j + 2 * t + (e & 1), sx[j][e],
                            e < 2 ? La : Lb);
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        da = fmaf(sx[j][0], dpx[j][0], fmaf(sx[j][1], dpx[j][1], da));
        db = fmaf(sx[j][2], dpx[j][2], fmaf(sx[j][3], dpx[j][3], db));
      }
    };
    const int n_kv = kt_hi - kt_lo + 1;  // key tiles a pass (≥ 0)
    if (n_kv > 0) {
      bool go0 = start(0, s, dp), go1 = false;
      for (int i = 0; i < n_kv; i += 2) {
        if (i + 1 < n_kv) {
          go1 = start(i + 1, s1, dp1);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        finish(i, go0, s, dp);
        if (i + 1 == n_kv) break;
        if (i + 2 < n_kv) {
          go0 = start(i + 2, s, dp);
          wgmma_wait<1>();
        } else {
          wgmma_wait<0>();
        }
        finish(i + 1, go1, s1, dp1);
      }
      n += n_kv;
    }
    da += __shfl_xor_sync(0xffffffffu, da, 1);
    da += __shfl_xor_sync(0xffffffffu, da, 2);
    db += __shfl_xor_sync(0xffffffffu, db, 1);
    db += __shfl_xor_sync(0xffffffffu, db, 2);
    if (t == 0) {
      if (qa < o.S) dd[stat + qa] = da;
      if (qa + 8 < o.S) dd[stat + qa + 8] = db;
    }

    // pass 2: dQ += dS K, K read MN-major from its tile.  A tile's dQ
    // product runs on while the next tile's S and dP are started; their
    // waits complete it, and then its stage is handed back.
    float acc[HD / 8][4];
    uint32_t a[kNJ / 2][4];  // dS of the tile whose dQ product is in flight
    int in_flight = -1;   // that tile's stage
    zero(acc);
    for (int kt = kt_lo; kt <= kt_hi; ++kt, ++n) {
      const Rg r(n);
      mbar_wait(&full[r.stage], r.parity);
      const int k0 = kt * kKeys;
      if (pairs_closed(o, r_wg, r_wg + 63, k0, k0 + kKeys - 1)) {
        release(&empty[r.stage]);
        continue;
      }
      const bool open =
          pairs_open(o, q0 + tr, q0 + tr + 15, k0, k0 + kKeys - 1);
      scores(r.stage, k0, open);
      hold(acc);
      hold(a);
      if (in_flight >= 0) release(&empty[in_flight]);
      probs(k0, open, da, db);
      pack_a(a, dp);
      wgmma_fence();
      wgmma_rs_tile<HD, kKeys>(acc, a,
                               smem_addr(KVs + r.stage * 2 * kTileK));
      wgmma_commit();
      in_flight = r.stage;
    }
    wgmma_wait<0>();
    hold(acc);
    hold(a);
    if (in_flight >= 0) release(&empty[in_flight]);

    // dQ through the warpgroup's own Q rows, then 16-byte stores
    named_barrier(1 + wg, 128);
    stage_frags<HD, kRowsDq>(Qs, acc, tr, lane);
    __syncwarp();
    store_rows<HD, kRowsDq>(dq, Qs, tr, static_cast<long>(b) * o.S, q0 + tr,
                            o.S, o.H, h, o.hd);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_bwd_dkdv_wgmma_kernel(const float* __restrict__ lse,
                                      const float* __restrict__ dd,
                                      __nv_bfloat16* __restrict__ dk,
                                      __nv_bfloat16* __restrict__ dv,
                                      const Opts o, int n_kt,
                                      const __grid_constant__ BwdMaps maps) {
  using namespace hopper;
  constexpr int kKeys = Wg<HD>::keys_dkdv;  // keys a block
  constexpr int kNS = Wg<HD>::stages_dkdv;  // the ring's stages
  using Rg = Ring<kNS>;
  // the columns of dK and dV a consumer warpgroup holds: at hd 256 both
  // take all the block's keys and half the columns each
  constexpr int kCols = Wg<HD>::cols_dkdv;
  constexpr bool kSplit = kCols < HD;
  constexpr int kTileK = kKeys * HD;      // elements of K (and of V)
  constexpr int kTileQ = kRowsDkdv * HD;  // of a stage's Q (and dO)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t mis = smem_addr(smem_raw) & 1023;
  __nv_bfloat16* Ks =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (mis ? 1024 - mis : 0));
  __nv_bfloat16* Vs = Ks + kTileK;
  __nv_bfloat16* QOs = Vs + kTileK;  // stage s: Q at QOs + 2s·kTileQ, dO after
  // stage s: L·log2 e of its rows at LDs + 2s·kRowsDkdv, D after
  float* LDs = reinterpret_cast<float*>(QOs + kNS * 2 * kTileQ);
  __shared__ alignas(8) uint64_t full[kNS], empty[kNS], kvbar;

  // block → (kv head fastest, then key tile from the first, then batch)
  const int kvh = blockIdx.x % o.K;
  const int rest = blockIdx.x / o.K;
  const int kt = rest % n_kt;
  const int b = rest / n_kt;
  const int G = o.H / o.K;
  const int k0 = kt * kKeys;
  // the query rows that can see keys k0 .. k_hi (the mirror of the
  // forward's tile_walk), and the rows with no unmasked key, which see
  // every key uniformly
  const int k_hi = min(k0 + kKeys, o.T) - 1;
  const int q_lo = o.causal ? k0 : 0;
  int q_hi = o.S - 1;
  if (o.window > 0 && !o.keyless(o.S - 1))
    q_hi = min(q_hi, k_hi + o.window - 1);
  const int qt_lo = q_lo / kRowsDkdv;
  const int qt_hi = q_lo <= q_hi ? q_hi / kRowsDkdv : qt_lo - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_init(&kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 2) {
    // the producer warp: its lanes write each stage's L and D, one lane
    // copies K and V once and each stage's Q and dO
    setmaxnreg_dec<kProducerRegs>();
    if ((threadIdx.x >> 5) == 8) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_expect(&kvbar, 2 * kTileK * sizeof(__nv_bfloat16));
        for (int kb = 0; kb < HD / 64; ++kb) {
          tma_load(Ks + kb * kKeys * 64, &maps.k, &kvbar, kb * 64, kvh, k0, b);
          tma_load(Vs + kb * kKeys * 64, &maps.v, &kvbar, kb * 64, kvh, k0, b);
        }
      }
      int n = 0;
      for (int gh = 0; gh < G; ++gh) {
        const int h = kvh * G + gh;
        const long stat = (static_cast<long>(b) * o.H + h) * o.S;
        for (int qt = qt_lo; qt <= qt_hi; ++qt, ++n) {
          const Rg r(n);
          const int q0 = qt * kRowsDkdv;
          mbar_wait(&empty[r.stage], r.parity ^ 1);
          float* Ls = LDs + r.stage * 2 * kRowsDkdv;
          for (int i = lane; i < kRowsDkdv; i += 32) {
            const bool in = q0 + i < o.S;
            Ls[i] = in ? lse[stat + q0 + i] * kLog2e : 0.0f;
            Ls[kRowsDkdv + i] = in ? dd[stat + q0 + i] : 0.0f;
          }
          if (lane == 0) {
            __nv_bfloat16* Qs = QOs + r.stage * 2 * kTileQ;
            mbar_expect(&full[r.stage], 2 * kTileQ * sizeof(__nv_bfloat16));
            for (int kb = 0; kb < HD / 64; ++kb) {
              tma_load(Qs + kb * kRowsDkdv * 64, &maps.q, &full[r.stage],
                       kb * 64, h, q0, b);
              tma_load(Qs + kTileQ + kb * kRowsDkdv * 64, &maps.dout,
                       &full[r.stage], kb * 64, h, q0, b);
            }
          } else {
            mbar_arrive(&full[r.stage]);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wk = kSplit ? 0 : wg * 64;     // the warpgroup's first key
    const int wc = kSplit ? wg * kCols : 0;  // and column of the tile
    const int k_wg = k0 + wk;
    const int tr = wk + warp * 16;  // the warp's first key of the tile
    const int kw = k0 + tr;
    const int ka = kw + g;          // the lane's keys ka and ka + 8
    const uint32_t k_addr = smem_addr(Ks) + wk * 128;
    const uint32_t v_addr = smem_addr(Vs) + wk * 128;
    // the warpgroup's columns of a stage's Q and dO: 64-column blocks of
    // kRowsDkdv rows of 128 bytes
    const uint32_t cols = (wc / 64) * kRowsDkdv * 128;
    const bool cap = o.cap > 0.0f;

    float accK[kCols / 8][4], accV[kCols / 8][4];
    zero(accK);
    zero(accV);
    mbar_wait(&kvbar, 0);
    int n = 0;
    for (int gh = 0; gh < G; ++gh) {
      for (int qt = qt_lo; qt <= qt_hi; ++qt, ++n) {
        const Rg r(n);
        const int q0 = qt * kRowsDkdv;
        mbar_wait(&full[r.stage], r.parity);
        if (!pairs_closed(o, q0, q0 + kRowsDkdv - 1, k_wg, k_wg + 63)) {
          const uint32_t q_addr = smem_addr(QOs + r.stage * 2 * kTileQ);
          const uint32_t o_addr = q_addr + kTileQ * 2;
          const float* Ls = LDs + r.stage * 2 * kRowsDkdv;
          const float* Ds = Ls + kRowsDkdv;
          const bool open =
              pairs_open(o, q0, q0 + kRowsDkdv - 1, kw, kw + 15);
          // Sᵀ = K Qᵀ and dPᵀ = V dOᵀ: keys as rows.  The lane's (row,
          // key) of element (j, e): (q0 + 8j + 2t + (e & 1), ka + 8·(e >>
          // 1)).
          float sT[8][4], dpT[8][4];
          uint32_t aP[4][4], aS[4][4];
          wgmma_ss_pair<HD, kKeys, kRowsDkdv>(sT, dpT, k_addr, q_addr,
                                              v_addr, o_addr);
          if (!cap) {
            // Pᵀ while dPᵀ is multiplied, then dV += Pᵀ dO while dSᵀ is
            // formed
            wgmma_wait<1>();
            hold(sT);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = 8 * j + 2 * t;
              const float2 L2 = *reinterpret_cast<const float2*>(Ls + c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float Lc = (e & 1) ? L2.y : L2.x;
                sT[j][e] = open ? ex2(fmaf(sT[j][e], kLog2e, -Lc))
                                : p_of(o, q0 + c + (e & 1),
                                       e < 2 ? ka : ka + 8, sT[j][e], Lc);
              }
            }
            pack_a(aP, sT);
            hold(accV);
            wgmma_fence();
            wgmma_rs_tile<kCols, kRowsDkdv>(accV, aP,
                                            o_addr + cols);  // dV += Pᵀ dO
            wgmma_commit();
            wgmma_wait<1>();                      // dPᵀ is in
            hold(dpT);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = 8 * j + 2 * t;
              const float2 D2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float Dc = (e & 1) ? D2.y : D2.x;
                dpT[j][e] = open ? sT[j][e] * (dpT[j][e] - Dc)
                                 : ds_of(o, q0 + c + (e & 1), sT[j][e],
                                         dpT[j][e], Dc);
              }
            }
          } else {
            wgmma_wait<0>();
            hold(sT);
            hold(dpT);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = 8 * j + 2 * t;
              const float2 L2 = *reinterpret_cast<const float2*>(Ls + c);
              const float2 D2 = *reinterpret_cast<const float2*>(Ds + c);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                p_ds_cap(o, open, q0 + c + (e & 1), e < 2 ? ka : ka + 8,
                         sT[j][e], dpT[j][e], (e & 1) ? L2.y : L2.x,
                         (e & 1) ? D2.y : D2.x, sT[j][e], dpT[j][e]);
            }
            pack_a(aP, sT);
            hold(accV);
            wgmma_fence();
            wgmma_rs_tile<kCols, kRowsDkdv>(accV, aP,
                                            o_addr + cols);  // dV += Pᵀ dO
            wgmma_commit();
          }
          pack_a(aS, dpT);
          hold(accK);
          wgmma_fence();
          wgmma_rs_tile<kCols, kRowsDkdv>(accK, aS,
                                          q_addr + cols);  // dK += dSᵀ Q
          wgmma_commit();
          wgmma_wait<0>();
          hold(accV);
          hold(accK);
          hold(aP);
          hold(aS);
        }
        release(&empty[r.stage]);
      }
    }

    // dK and dV through the warpgroup's own K and V rows (columns at hd
    // 256, once neither warpgroup reads K or V), then 16-byte stores
    if constexpr (kSplit)
      named_barrier(1, 256);
    else
      named_barrier(1 + wg, 128);
    stage_frags<kCols, kKeys>(Ks, accK, tr, lane, wc);
    stage_frags<kCols, kKeys>(Vs, accV, tr, lane, wc);
    __syncwarp();
    const long base = static_cast<long>(b) * o.T;
    store_rows<kCols, kKeys>(dk, Ks, tr, base, kw, o.T, o.K, kvh, o.hd, wc);
    store_rows<kCols, kKeys>(dv, Vs, tr, base, kw, o.T, o.K, kvh, o.hd, wc);
  }
}

// ---- launches ------------------------------------------------------------------------

// What the wrapper's bwd_geometry (kernel.py) decided for one call.
struct Geometry {
  int route;       // 1: the wgmma kernels, 0: the FMA kernels
  int hd_tile;     // the instantiation's width
  int dq_rows, dq_keys;      // a dQ block's query rows, a streamed tile's keys
  int dkdv_keys, dkdv_rows;  // a dK/dV block's keys, a streamed tile's rows
  int stages;      // the dQ kernel's ring (the dK/dV kernel's is Wg's,
                   // which dkdv_smem covers)
  int threads;
  int n_qt, n_kt;            // dQ blocks along S, dK/dV blocks along T
  int dq_blocks, dkdv_blocks;
  int dq_smem, dkdv_smem;    // dynamic shared memory, bytes
};

constexpr int kSmemLimit = 232448;

template <typename KDq, typename KDkdv>
int set_smem(KDq dqk, KDkdv dkdv, const Geometry& geo) {
  cudaError_t err = cudaFuncSetAttribute(
      dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.dq_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, geo.dkdv_smem));
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, float* dd, void* dq,
                 void* dk, void* dv, int B, const Opts& o,
                 const Geometry& geo, cudaStream_t stream) {
  using W = Wg<HD>;
  if (geo.dq_rows != kRowsDq || geo.dq_keys != W::keys_dq ||
      geo.dkdv_keys != W::keys_dkdv || geo.dkdv_rows != kRowsDkdv ||
      geo.stages != W::stages_dq || geo.threads != kWgThreads ||
      geo.dq_smem < static_cast<int>(W::smem_dq) ||
      geo.dkdv_smem < static_cast<int>(W::smem_dkdv) ||
      geo.dq_smem > kSmemLimit || geo.dkdv_smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdMaps m1 = {}, m2 = {};  // boxes of the dQ kernel's and dK/dV's rows
  if (!(hopper::encode_map(&m1.q, q, B, o.S, o.H, o.hd, kRowsDq) &&
        hopper::encode_map(&m1.dout, dout, B, o.S, o.H, o.hd, kRowsDq) &&
        hopper::encode_map(&m1.k, k, B, o.T, o.K, o.hd, W::keys_dq) &&
        hopper::encode_map(&m1.v, v, B, o.T, o.K, o.hd, W::keys_dq) &&
        hopper::encode_map(&m2.q, q, B, o.S, o.H, o.hd, kRowsDkdv) &&
        hopper::encode_map(&m2.dout, dout, B, o.S, o.H, o.hd, kRowsDkdv) &&
        hopper::encode_map(&m2.k, k, B, o.T, o.K, o.hd, W::keys_dkdv) &&
        hopper::encode_map(&m2.v, v, B, o.T, o.K, o.hd, W::keys_dkdv)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto dqk = flash_attention_bwd_dq_wgmma_kernel<HD>;
  auto dkdv = flash_attention_bwd_dkdv_wgmma_kernel<HD>;
  int err = set_smem(dqk, dkdv, geo);
  if (err != 0) return err;
  dqk<<<static_cast<unsigned>(geo.dq_blocks), kWgThreads, geo.dq_smem,
        stream>>>(lse, dd, static_cast<__nv_bfloat16*>(dq), o, geo.n_qt, m1);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || geo.dkdv_blocks == 0) return err;
  dkdv<<<static_cast<unsigned>(geo.dkdv_blocks), kWgThreads, geo.dkdv_smem,
         stream>>>(lse, dd, static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), o, geo.n_kt, m2);
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
int launch_fma(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, float* dd, void* dq, void* dk, void* dv,
               const Opts& o, const Geometry& geo, cudaStream_t stream) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK;
  if (geo.dq_rows != BQ || geo.dq_keys != BK || geo.dkdv_keys != BK ||
      geo.dkdv_rows != BQ || geo.stages != 1 || geo.threads != kThreads ||
      geo.dq_smem < static_cast<int>(dq_smem<HD>()) ||
      geo.dkdv_smem < static_cast<int>(dkdv_smem<HD>()) ||
      geo.dq_smem > kSmemLimit || geo.dkdv_smem > kSmemLimit)
    return static_cast<int>(cudaErrorInvalidValue);
  auto dqk = flash_attention_bwd_dq_kernel<T, HD>;
  auto dkdv = flash_attention_bwd_dkdv_kernel<T, HD>;
  int err = set_smem(dqk, dkdv, geo);
  if (err != 0) return err;
  // dQ first: it writes D, which dK/dV read
  dqk<<<static_cast<unsigned>(geo.dq_blocks), kThreads, geo.dq_smem,
        stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                  dd, static_cast<T*>(dq), o, geo.n_qt);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0 || geo.dkdv_blocks == 0) return err;
  dkdv<<<static_cast<unsigned>(geo.dkdv_blocks), kThreads, geo.dkdv_smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                   dd, static_cast<T*>(dk), static_cast<T*>(dv), o, geo.n_kt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse_ptr, void* dd_ptr, void* dq, void* dk, void* dv,
           int B, int S, int T_len, int H, int K, int hd, int causal,
           int window, float cap, const Geometry& geo, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (K <= 0 || H % K != 0 || hd <= 0 || hd > geo.hd_tile || T_len <= 0 ||
      geo.dq_blocks <= 0 || geo.dkdv_blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Opts o{S, T_len, H, K, hd, causal, window, cap};
  const float* lse = static_cast<const float*>(lse_ptr);
  float* dd = static_cast<float*>(dd_ptr);
  if (geo.route == 1) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (geo.hd_tile == 64)
        return launch_wgmma<64>(q, k, v, dout, lse, dd, dq, dk, dv, B, o, geo,
                                stream);
      if (geo.hd_tile == 128)
        return launch_wgmma<128>(q, k, v, dout, lse, dd, dq, dk, dv, B, o,
                                 geo, stream);
      if (geo.hd_tile == 256)
        return launch_wgmma<256>(q, k, v, dout, lse, dd, dq, dk, dv, B, o,
                                 geo, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (geo.route != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (geo.hd_tile == 64)
    return launch_fma<T, 64>(q, k, v, dout, lse, dd, dq, dk, dv, o, geo,
                             stream);
  if (geo.hd_tile == 128)
    return launch_fma<T, 128>(q, k, v, dout, lse, dd, dq, dk, dv, o, geo,
                              stream);
  if (geo.hd_tile == 256)
    return launch_fma<T, 256>(q, k, v, dout, lse, dd, dq, dk, dv, o, geo,
                              stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q and dout (B, S, H, hd), k/v (B, T, K, hd) of one dtype; lse (B, H,
// S) f32 from the forward; dd (B, H, S) f32 scratch for D; dq, dk, dv
// outputs shaped as q, k, v.  window <= 0: no window; cap <= 0: no
// softcap.  The geometry (route .. dkdv_smem) is the wrapper's
// bwd_geometry, in the order of struct Geometry.
#define BWD_ARGS                                                            \
  const void *q, const void *k, const void *v, const void *dout,            \
      const void *lse, void *dd, void *dq, void *dk, void *dv, int B, int S, \
      int T, int H, int K, int hd, int causal, int window, float cap,       \
      int route, int hd_tile, int dq_rows, int dq_keys, int dkdv_keys,      \
      int dkdv_rows, int stages, int threads, int n_qt, int n_kt,           \
      int dq_blocks, int dkdv_blocks, int dq_smem, int dkdv_smem,           \
      void *stream
#define BWD_GEOMETRY                                                        \
  Geometry {                                                                \
    route, hd_tile, dq_rows, dq_keys, dkdv_keys, dkdv_rows, stages,         \
        threads, n_qt, n_kt, dq_blocks, dkdv_blocks, dq_smem, dkdv_smem     \
  }

int flash_attention_bwd_f32(BWD_ARGS) {
  return launch<float>(q, k, v, dout, lse, dd, dq, dk, dv, B, S, T, H, K, hd,
                       causal, window, cap, BWD_GEOMETRY, stream);
}

int flash_attention_bwd_bf16(BWD_ARGS) {
  return launch<__nv_bfloat16>(q, k, v, dout, lse, dd, dq, dk, dv, B, S, T,
                               H, K, hd, causal, window, cap, BWD_GEOMETRY,
                               stream);
}

}  // extern "C"
