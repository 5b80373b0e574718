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
// (q, k) pairs take 4·hd flops each, 1.29e11 in all, 0.130 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against 92 MB of q, k, v and o
// (0.027 ms at 3.35 TB/s).
//
// Design, bf16 (the serving path): FlashAttention-2's loop on Hopper's
// warpgroup products (wgmma).
// - One block of 2 warpgroups (8 warps) per (q tile of 128 rows, q head,
//   batch); each warpgroup owns 64 query rows.  Blocks are numbered head
//   first, then q tile from the last (the longest walks start first),
//   then batch, so the heads that share a kv head read the same kv tiles
//   at about the same time and find them in L2.
// - Q (128 × hd) is copied to shared memory once; K and V tiles of 64
//   keys are double-buffered: the next tile's copies are in flight while
//   the current tile is multiplied.  The copies are TMA boxes of 64
//   columns, issued by one thread and completed on an mbarrier per
//   stage, so the warps that multiply spend no instructions on them.
//   Tiles are stored as wgmma reads them and TMA writes them: 64-column
//   blocks of 128-byte rows whose 16-byte chunks are XORed with the row
//   mod 8 (the 128-byte swizzle), free of bank conflicts.  Rows and
//   columns past the tensor read as zeros.  Where a row of hd is not
//   whole 16-byte pieces or a tensor is not 16-byte aligned (TMA needs
//   both), the block copies element by element into the same layout.
//   At hd = 256: Q 64 KB + 2 × (K + V) 128 KB = 193 KB of shared memory
//   with the alignment slack, one block (256 threads) per SM.  Each block
//   reads Q once and ~34 kv tiles of 64 KB (K and V) at the serving
//   shape: 2.2 MB a block, 1.4 GB from L2 for the 640 blocks.
// - QKᵀ: wgmma m64n64k16 (bf16 in, f32 accumulate), A = the warpgroup's
//   Q rows and B = the K tile, both K-major from shared memory through
//   descriptors; hd / 16 of them per kv tile.  The 64 × 64 score tile is
//   in registers (32 floats a thread) in the accumulator layout, which
//   is mma.sync's m16n8 C layout per warp.
// - Online softmax in registers: each row belongs to one quad of lanes;
//   its max and sum are shuffle reductions within the quad.
// - P stays in registers: the f32 accumulator layout is the bf16 A
//   register layout of wgmma k16, so two score n-tiles pack into one A
//   fragment.  This is where p is rounded to bf16 (both JAX versions
//   round p to the value type before p·V); l sums p in f32 first.
// - PV: wgmma m64n{hd}k16 with A = P from registers and B = the V tile,
//   read MN-major (the transpose bit) from the same layout as K.  The
//   64 × hd O accumulator stays in registers (128 floats a thread at
//   hd = 256).
// - Shared memory written by element copies is handed to the tensor
//   cores' asynchronous proxy with fence.proxy.async before the barrier.
// - The epilogue stages the normalised O tile through the warp's own Q
//   rows in shared memory and stores 16-byte rows.
// What bounds it now (tools/ablate_kernels.py, PERF.md): no one part.
// Taking out the K/V copies, the softmax or either product each saves a
// sixth to a fifth of the time.  Inside a warpgroup the softmax waits for
// QKᵀ and PV for the softmax; overlapping one tile's softmax with the
// next tile's QKᵀ needs a second score tile in registers, which hd = 256
// does not leave room for.
//
// Design, f32 (run only by the checks): the same tile walk, mask and
// online softmax on the same fragment layout, one block of 4 warps per
// 64 q rows, one K/V buffer in padded row-major tiles filled by 16-byte
// cp.async copies (or element copies), and exact f32 FMAs
// for both products (the PV product reads p from the quad that holds it
// by shuffles).  Only the tile layout and the two product functions
// differ between the instantiations, so the f32 readings cover the
// masking logic that the bf16 path runs.
//
// Shared by both instantiations:
// - The kv head is h / (H / K), so MQA and GQA read each kv head's tiles
//   directly; no repeated K/V is materialised.
// - Only the kv tiles that can hold an unmasked key for the tile's rows
//   are visited: from max(0, q_lo - window + 1) to q_hi when causal.
//   Within a tile the mask is by position, as the TPU kernel's is.  The
//   rows that multiply together (a warpgroup's 64 in bf16, a warp's 16
//   in f32) skip a visited tile in which all of them are masked; that is
//   exact (see tile_masked_for_rows).  A warp whose 16 rows see every key
//   of a tile unmasked skips the mask.
// - Ragged S and T are handled by bounds checks (rows and keys past the
//   end load as zeros and are never stored or get p = 0): no padded
//   copies.  Columns past hd load as zeros, so every hd ≤ 256 runs on
//   the instantiation of the next width of 64, 128 or 256.
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
// - The end divides by max(l, 1e-30).  When the caller asks for it
//   (training), the kernel also writes each row's log-sum-exp
//   m + log max(l, 1e-30) in f32, (B, H, S), for the backward
//   (flash_attention_bwd.cu); serving passes null and writes none.
// - 16-byte copies (TMA, cp.async) need hd to be a multiple of 16 bytes'
//   worth of elements and 16-byte-aligned base pointers; the wrapper
//   checks both and otherwise asks for element copies (`vec`).
//
// C interface: raw pointers, sizes, the mask options and the stream; each
// entry point launches on that stream and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBKV = 64;            // keys per kv tile
constexpr int kNT = kBKV / 8;       // score n-tiles of 8 keys
constexpr float kNegInf = -1e30f;   // a masked key; a key past T is -inf

// Per value type: warps a block (16 q rows each), K/V buffers, the rows
// that multiply together (a warpgroup in bf16, a warp in f32), and the
// alignment slack of the shared-memory tiles.
template <typename T> struct Cfg;
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int kWarps = 8;
  static constexpr int kStages = 2;
  static constexpr int kUnitRows = 64;
  static constexpr int kAlign = 1024;   // the swizzle repeats every 1 KB
};
template <> struct Cfg<float> {
  static constexpr int kWarps = 4;
  static constexpr int kStages = 1;
  static constexpr int kUnitRows = 16;
  static constexpr int kAlign = 16;
};

// Element offset of (row r, column c) in a shared-memory tile of R rows.
template <typename T, int HD> struct Layout;
// f32: row-major, rows padded by 16 bytes against bank conflicts
template <int HD> struct Layout<float, HD> {
  static constexpr int LD = HD + 4;
  __host__ __device__ static constexpr int elems(int R) { return R * LD; }
  static __device__ __forceinline__ int at(int R, int r, int c) {
    (void)R;
    return r * LD + c;
  }
};
// bf16: blocks of 64 columns, each R rows of 128 bytes, the 16-byte
// chunks of row r XORed with r mod 8 (wgmma's 128-byte swizzle; the
// tiles start on 1024-byte boundaries, where the pattern repeats)
template <int HD> struct Layout<__nv_bfloat16, HD> {
  __host__ __device__ static constexpr int elems(int R) { return R * HD; }
  static __device__ __forceinline__ int at(int R, int r, int c) {
    return (c >> 6) * R * 64 + r * 64 + ((((c >> 3) ^ r) & 7) << 3) +
           (c & 7);
  }
};

template <typename T, int HD>
constexpr size_t smem_bytes() {
  using L = Layout<T, HD>;
  return sizeof(T) * static_cast<size_t>(
                         L::elems(Cfg<T>::kWarps * 16) +
                         Cfg<T>::kStages * 2 * L::elems(kBKV)) +
         Cfg<T>::kAlign;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared; src_bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared memory written by this thread's generic stores and cp.async
// copies becomes visible to the tensor cores' asynchronous proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbarriers and TMA tile copies (bf16 with 16-byte rows)
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// One box of a 4-d tensor map (hd, heads, rows, batch) at the given
// coordinates into shared memory; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(col), "r"(head), "r"(row), "r"(batch),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins accumulator registers at this point of the program, so that the
// compiler reads or writes them on the right side of a wgmma wait.
template <int N> __device__ __forceinline__ void hold(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// Descriptor of a 128-byte-swizzled operand at shared byte address addr:
// lbo, sbo the byte strides between 64-column blocks (MN-major; unused
// for K-major) and between groups of 8 rows.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// d (64 × 64, f32) += A · B; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 × 64, f32) += A · B; A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 128, f32) += A · B; A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 256, f32) += A · B; A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else {
    static_assert(N == 256, "hd tile of 64, 128 or 256");
    wgmma_rs_n256(d, a, db);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo, low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- the tile walk, the mask and the online softmax (both types) --------------

struct TileWalk {
  int kt_lo, kt_hi;   // kv tiles visited, inclusive
  bool all_keys;      // the block holds a row with no unmasked key
};

// The kv tiles that can hold an unmasked key for rows q0 .. q0 + rows - 1.
__device__ __forceinline__ TileWalk tile_walk(int q0, int rows, int S,
                                              int T_len, int causal,
                                              int window) {
  const int q_hi = min(q0 + rows, S) - 1;
  const int k_hi = causal ? min(q_hi, T_len - 1) : T_len - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  TileWalk w;
  w.all_keys = window > 0 && static_cast<long>(q_hi) >=
                                 static_cast<long>(T_len) + window - 1;
  w.kt_lo = w.all_keys ? 0 : k_lo / kBKV;
  w.kt_hi = w.all_keys ? (T_len + kBKV - 1) / kBKV - 1
            : k_hi < k_lo ? w.kt_lo - 1
                          : k_hi / kBKV;
  return w;
}

// True when rows r0 .. r0 + rows - 1 need nothing of the kv tile at k0:
// they lie past S, or every (row, key) pair is masked.  Skipping such a
// tile is exact unless the block holds a row with no unmasked key (the
// caller checks all_keys): before a row's first real key its l and acc
// only hold garbage that exp(m_old - m_new) = 0 wipes, and after it a
// masked key adds p = exp(-1e30 - m) = 0.
__device__ __forceinline__ bool tile_masked_for_rows(int r0, int rows,
                                                     int k0, int S,
                                                     int causal,
                                                     int window) {
  if (r0 >= S) return true;
  if (causal && k0 > r0 + rows - 1) return true;
  return window > 0 && r0 - (k0 + kBKV - 1) >= window;
}

// True when no (row, key) pair of the warp's rows r0 .. r0 + 15 and the
// kv tile at k0 is masked: every key is before T, and within the causal
// limit and the window of every row.
__device__ __forceinline__ bool tile_open_for_warp(int r0, int k0, int T_len,
                                                   int causal, int window) {
  if (k0 + kBKV > T_len) return false;
  if (causal && k0 + kBKV - 1 > r0) return false;
  return window <= 0 || r0 + 15 - k0 < window;
}

// Scores s[j][e] of the fragment layout: row qr + 8·(e >> 1), key
// kc + 8·j + (e & 1), with qr = the q position of the lane's first row
// and kc = k0 + 2·(lane % 4).  Softcap, then the mask by position, which
// a tile open to the whole warp (tile_open_for_warp) skips.
__device__ __forceinline__ void mask_scores(float (&s)[kNT][4], int qr,
                                            int kc, int T_len, int causal,
                                            int window, float cap,
                                            bool open) {
  if (open) {
    if (cap > 0.0f) {
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = cap * tanhf(s[j][e] / cap);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = qr + 8 * (e >> 1);
      const int kp = kc + 8 * j + (e & 1);
      float x = s[j][e];
      if (cap > 0.0f) x = cap * tanhf(x / cap);
      bool ok = true;
      if (causal) ok = qp >= kp;
      if (window > 0) ok = ok && (qp - kp) < window;
      s[j][e] = kp >= T_len ? -CUDART_INF_F : ok ? x : kNegInf;
    }
  }
}

// One kv tile of the online softmax for the lane's two rows: s becomes
// p = exp(s - m_new) (not yet rounded), l and m are updated, and alpha =
// exp(m_old - m_new) is returned per row for rescaling the accumulator.
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[j][2 * r + c] - m_new);
        sum += p;
        s[j][2 * r + c] = p;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    alpha[r] = expf(m[r] - m_new);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
  }
}

// ---- the two products ---------------------------------------------------------
// Products<T, HD>::qk(s, Qs, Ks, warp, lane): s = Q · Kᵀ (64 keys)
// Products<T, HD>::pv(o, p, Vs, warp, lane): o += P · V (HD columns)
// over the rows that multiply together, each lane holding its fragment
// (rows g and g + 8 of its warp's 16, columns 8j + 2·(lane % 4) + 0, 1).
// The tiles are in shared memory as Layout<T, HD> places them.

template <typename T, int HD> struct Products;

template <int HD> struct Products<__nv_bfloat16, HD> {
  static constexpr int kBQ = Cfg<__nv_bfloat16>::kWarps * 16;

  // the warpgroup's 64 rows of Q · Kᵀ; Q and K tiles K-major (Layout)
  static __device__ __forceinline__ void qk(float (&s)[kNT][4],
                                            const __nv_bfloat16* Qs,
                                            const __nv_bfloat16* Ks,
                                            int warp, int lane) {
    (void)lane;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const uint32_t qa = smem_addr(Qs) + (warp >> 2) * 64 * 128;
    const uint32_t ka = smem_addr(Ks);
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      // k16 step ks: 64-column block ks / 4, 32 bytes a step inside it
      const uint32_t off = (ks & 3) * 32;
      wgmma_ss_n64(s, gmma_desc(qa + (ks >> 2) * kBQ * 128 + off, 16, 1024),
                   gmma_desc(ka + (ks >> 2) * kBKV * 128 + off, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);
  }

  // o += P · V for the warpgroup's 64 rows; V MN-major from the K layout
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&p)[kNT][4],
                                            const __nv_bfloat16* Vs,
                                            int warp, int lane) {
    (void)warp;
    (void)lane;
    // the C fragments of score n-tiles 2kk and 2kk + 1 are the A
    // fragment of keys 16kk .. 16kk + 15; p is rounded to bf16 here
    uint32_t a[kBKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    }
    const uint32_t va = smem_addr(Vs);
    hold(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      // keys 16kk ..: two groups of 8 rows (sbo 1 KB); hd blocks of 64
      // columns are kBKV rows of 128 bytes apart (lbo)
      wgmma_rs<HD>(o, a[kk],
                   gmma_desc(va + kk * 16 * 128, kBKV * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(o);
  }
};

template <int HD> struct Products<float, HD> {
  static constexpr int LD = Layout<float, HD>::LD;

  static __device__ __forceinline__ void qk(float (&s)[kNT][4],
                                            const float* Qs, const float* Ks,
                                            int warp, int lane) {
    const int g = lane >> 2, tig = lane & 3;
    const float* qa = Qs + (warp * 16 + g) * LD;
    const float* qb = qa + 8 * LD;
    const float* kc = Ks + 2 * tig * LD;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float x0 = qa[d], x1 = qb[d];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float k0 = kc[8 * j * LD + d];
        const float k1 = kc[(8 * j + 1) * LD + d];
        s[j][0] = fmaf(x0, k0, s[j][0]);
        s[j][1] = fmaf(x0, k1, s[j][1]);
        s[j][2] = fmaf(x1, k0, s[j][2]);
        s[j][3] = fmaf(x1, k1, s[j][3]);
      }
    }
  }

  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4],
                                            const float (&p)[kNT][4],
                                            const float* Vs, int warp,
                                            int lane) {
    (void)warp;
    const int tig = lane & 3;
#pragma unroll
    for (int c = 0; c < kBKV; ++c) {
      // p of key c for rows g and g + 8 is held by lane 4g + (c % 8) / 2
      const int src = (lane & ~3) | ((c & 7) >> 1);
      const float pa = __shfl_sync(0xffffffffu, p[c >> 3][c & 1], src);
      const float pb = __shfl_sync(0xffffffffu, p[c >> 3][2 + (c & 1)], src);
      const float* vrow = Vs + c * LD + 2 * tig;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float2 vv = *reinterpret_cast<const float2*>(vrow + 8 * n);
        o[n][0] = fmaf(pa, vv.x, o[n][0]);
        o[n][1] = fmaf(pa, vv.y, o[n][1]);
        o[n][2] = fmaf(pb, vv.x, o[n][2]);
        o[n][3] = fmaf(pb, vv.y, o[n][3]);
      }
    }
  }
};

// ---- copies -------------------------------------------------------------------

// Rows [row0, row0 + NROWS) of head `head` of x (B, L, NH, hd), batch row
// offset row_base = b·L, into the tile dst (Layout); rows past L and
// columns past hd are zeros.  vec (f32 only; bf16 with 16-byte rows is
// copied by TMA): 16-byte cp.async copies, hd a multiple of 4 and x
// 16-byte aligned, each thread keeping one column chunk and walking the
// rows a fixed step apart, so that its destination and source each move
// by a constant.  Else element copies.
template <typename T, int HD, int NTHREADS, int NROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ x,
                                          long row_base, int L, int NH,
                                          int head, int hd, int row0,
                                          bool vec) {
  using Lay = Layout<T, HD>;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      constexpr int CPR = HD / 4;           // 16-byte chunks a row
      constexpr int STEP = NTHREADS / CPR;  // rows between a thread's chunks
      static_assert(NTHREADS % CPR == 0 && NROWS % STEP == 0,
                    "each thread keeps one column chunk");
      const int c = (threadIdx.x % CPR) * 4;
      const int r = threadIdx.x / CPR;
      float* d = dst + Lay::at(NROWS, r, c);
      const long s_step = static_cast<long>(STEP) * NH * hd;
      const float* src = x + ((row_base + row0 + r) * NH + head) *
                                 static_cast<long>(hd) + c;
      const int rows_in = c < hd ? L - row0 - r : 0;  // this thread's rows
#pragma unroll
      for (int j = 0; j < NROWS / STEP; ++j) {
        const bool in = j * STEP < rows_in;
        cp_async16(d + j * STEP * Lay::LD, in ? src + j * s_step : x,
                   in ? 16 : 0);
      }
      return;
    }
  }
  for (int i = threadIdx.x; i < NROWS * HD; i += NTHREADS) {
    const int r = i / HD;
    const int col = i - r * HD;
    const int row = row0 + r;
    dst[Lay::at(NROWS, r, col)] =
        row < L && col < hd
            ? x[((row_base + row) * NH + head) * static_cast<long>(hd) + col]
            : from_f32<T>(0.0f);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ---- the kernel -----------------------------------------------------------------

// TMA descriptors of q, k and v (bf16 with 16-byte rows; unused else)
struct TmaMaps {
  CUtensorMap q, k, v;
};

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<T>::kWarps * 32, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ lse, int S,
                       int T_len, int H, int K, int hd, int causal,
                       int window, float cap, int vec, int n_qt,
                       const __grid_constant__ TmaMaps maps) {
  constexpr int kWarps = Cfg<T>::kWarps;
  constexpr int kThreads = kWarps * 32;
  constexpr int kBQ = kWarps * 16;
  constexpr int kStages = Cfg<T>::kStages;
  constexpr int kUnit = Cfg<T>::kUnitRows;
  using L = Layout<T, HD>;
  constexpr int kTile = L::elems(kBKV);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t mis = smem_addr(smem_raw) & (Cfg<T>::kAlign - 1);
  T* Qs = reinterpret_cast<T*>(smem_raw +
                               (mis ? Cfg<T>::kAlign - mis : 0));
  T* KVs = Qs + L::elems(kBQ);  // stage s: K at KVs + 2s·kTile, V after it
  __shared__ alignas(8) uint64_t bars[3];  // K/V stages 0 and 1, then Q

  // block → (head fastest, then q tile from the last, then batch)
  const int h = blockIdx.x % H;
  const int rest = blockIdx.x / H;
  const int q0 = (n_qt - 1 - rest % n_qt) * kBQ;
  const int b = rest / n_qt;
  const int kvh = h / (H / K);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + warp * 16;           // the warp's first q position
  const int ru = q0 + (warp * 16 / kUnit) * kUnit;  // its unit's first
  const int qr = r0 + (lane >> 2);         // the lane's first row
  const int kc = 2 * (lane & 3);           // the lane's first key column
  const bool v16 = vec != 0;
  // bf16 with 16-byte rows: TMA, one thread issuing one box per 64
  // columns of a tile; f32: 16-byte cp.async; else element copies
  const bool tma = std::is_same<T, __nv_bfloat16>::value && v16;
  if (tma && threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const TileWalk walk = tile_walk(q0, kBQ, S, T_len, causal, window);
  auto load_kv = [&](int kt, int stage) {
    T* Ks = KVs + stage * 2 * kTile;
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_expect(&bars[stage], 2 * kTile * sizeof(T));
        for (int kb = 0; kb < HD / 64; ++kb) {
          tma_load(Ks + kb * kBKV * 64, &maps.k, &bars[stage], kb * 64, kvh,
                   kt * kBKV, b);
          tma_load(Ks + kTile + kb * kBKV * 64, &maps.v, &bars[stage],
                   kb * 64, kvh, kt * kBKV, b);
        }
      }
      return;
    }
    load_rows<T, HD, kThreads, kBKV>(Ks, k, static_cast<long>(b) * T_len,
                                     T_len, K, kvh, hd, kt * kBKV, v16);
    load_rows<T, HD, kThreads, kBKV>(Ks + kTile, v,
                                     static_cast<long>(b) * T_len, T_len, K,
                                     kvh, hd, kt * kBKV, v16);
  };

  if (!tma) {
    load_rows<T, HD, kThreads, kBQ>(Qs, q, static_cast<long>(b) * S, S, H,
                                    h, hd, q0, v16);
  } else if (threadIdx.x == 0) {
    mbar_expect(&bars[2], L::elems(kBQ) * sizeof(T));
    for (int kb = 0; kb < HD / 64; ++kb)
      tma_load(Qs + kb * kBQ * 64, &maps.q, &bars[2], kb * 64, h, q0, b);
  }
  if (walk.kt_lo <= walk.kt_hi) load_kv(walk.kt_lo, 0);
  cp_async_commit();

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};
  if (tma) mbar_wait(&bars[2], 0);

  for (int kt = walk.kt_lo, i = 0; kt <= walk.kt_hi; ++kt, ++i) {
    const int stage = kStages == 2 ? (i & 1) : 0;
    if constexpr (kStages == 2) {
      if (kt < walk.kt_hi) load_kv(kt + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // every group but the one just committed
    } else {
      cp_async_wait<0>();
    }
    if (tma) mbar_wait(&bars[stage], (i >> 1) & 1);
    fence_proxy_async();
    __syncthreads();

    const int k0 = kt * kBKV;
    const T* Ks = KVs + stage * 2 * kTile;
    if (walk.all_keys ||
        !tile_masked_for_rows(ru, kUnit, k0, S, causal, window)) {
      float s[kNT][4];
      Products<T, HD>::qk(s, Qs, Ks, warp, lane);
      mask_scores(s, qr, k0 + kc, T_len, causal, window, cap,
                  tile_open_for_warp(r0, k0, T_len, causal, window));
      float alpha[2];
      softmax_tile(s, m, l, alpha);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      Products<T, HD>::pv(acc, s, Ks + kTile, warp, lane);
    }
    __syncthreads();  // this stage is free to be loaded again

    if constexpr (kStages == 1) {
      if (kt < walk.kt_hi) load_kv(kt + 1, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the row log-sum-exp m + log l for the backward, when asked for: one
  // lane of each quad holds its two rows' m and l (a row with no
  // unmasked key writes -1e30 + log T, which rounds to -1e30)
  if (lse != nullptr && (lane & 3) == 0) {
    const long lrow = (static_cast<long>(b) * H + h) * S;
    if (qr < S) lse[lrow + qr] = m[0] + logf(fmaxf(l[0], 1e-30f));
    if (qr + 8 < S) lse[lrow + qr + 8] = m[1] + logf(fmaxf(l[1], 1e-30f));
  }

  // normalise into the warp's own Q rows, then store whole rows
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
  const int rw = warp * 16 + (lane >> 2);  // the lane's first tile row
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    store_pair(Qs + L::at(kBQ, rw, 8 * n + kc), acc[n][0] * inv0,
               acc[n][1] * inv0);
    store_pair(Qs + L::at(kBQ, rw + 8, 8 * n + kc), acc[n][2] * inv1,
               acc[n][3] * inv1);
  }
  __syncwarp();
  const long row_base = static_cast<long>(b) * S;
  if (v16) {
    constexpr int E = 16 / sizeof(T);
    constexpr int CPR = HD / E;
    for (int idx = lane; idx < 16 * CPR; idx += 32) {
      const int r = idx / CPR;
      const int c = (idx - r * CPR) * E;
      const int qp = r0 + r;
      if (qp < S && c < hd) {
        *reinterpret_cast<int4*>(
            o + ((row_base + qp) * H + h) * static_cast<long>(hd) + c) =
            *reinterpret_cast<const int4*>(Qs + L::at(kBQ, warp * 16 + r, c));
      }
    }
  } else {
    for (int idx = lane; idx < 16 * HD; idx += 32) {
      const int r = idx / HD;
      const int d = idx - r * HD;
      const int qp = r0 + r;
      if (qp < S && d < hd)
        o[((row_base + qp) * H + h) * static_cast<long>(hd) + d] =
            Qs[L::at(kBQ, warp * 16 + r, d)];
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against the driver library); null if the driver does not have it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of x (B, L, NH, hd) bf16 for boxes of 64 columns × rows
// of one head, 128-byte swizzled (Layout<bf16>); past L and hd read 0.
bool encode_map(CUtensorMap* map, const void* x, int B, int L, int NH,
                int hd, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(NH),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row, row * NH, row * NH * L};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(x), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int T_len, int H, int K, int hd,
              int causal, int window, float cap, int vec,
              cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, HD>();
  constexpr int kBQ = Cfg<T>::kWarps * 16;
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (S + kBQ - 1) / kBQ;
  const long blocks = static_cast<long>(n_qt) * H * B;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  TmaMaps maps = {};
  if (std::is_same<T, __nv_bfloat16>::value && vec &&
      !(encode_map(&maps.q, q, B, S, H, hd, kBQ) &&
        encode_map(&maps.k, k, B, T_len, K, hd, kBKV) &&
        encode_map(&maps.v, v, B, T_len, K, hd, kBKV)))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), Cfg<T>::kWarps * 32, bytes,
           stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse, S,
                     T_len, H, K, hd, causal, window, cap, vec, n_qt, maps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse_ptr,
           int B, int S, int T_len, int H, int K, int hd, int causal,
           int window, float cap, int vec, void* stream_ptr) {
  float* lse = static_cast<float*>(lse_ptr);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B == 0 || S == 0 || H == 0) return static_cast<int>(cudaGetLastError());
  if (hd <= 64)
    return launch_hd<T, 64>(q, k, v, o, lse, B, S, T_len, H, K, hd,
                            causal, window, cap, vec, stream);
  if (hd <= 128)
    return launch_hd<T, 128>(q, k, v, o, lse, B, S, T_len, H, K, hd,
                             causal, window, cap, vec, stream);
  if (hd <= 256)
    return launch_hd<T, 256>(q, k, v, o, lse, B, S, T_len, H, K, hd,
                             causal, window, cap, vec, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// window <= 0: no window; cap <= 0: no softcap; vec != 0: 16-byte copies
// (hd a multiple of 16 bytes' worth of elements, q, k, v and o 16-byte
// aligned); lse: null, or an f32 (B, H, S) output of the row log-sum-exp.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int S, int T, int H, int K, int hd,
                        int causal, int window, float cap, int vec,
                        void* stream) {
  return launch<float>(q, k, v, o, lse, B, S, T, H, K, hd, causal, window,
                       cap, vec, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int S, int T, int H,
                         int K, int hd, int causal, int window, float cap,
                         int vec, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, B, S, T, H, K, hd, causal,
                               window, cap, vec, stream);
}

}  // extern "C"
