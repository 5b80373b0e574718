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
// Bound on this card: bytes.  a and b are read once and h written once,
// 12 bytes an element in float32 (252 MB, 0.075 ms at 3.35 TB/s at the
// serving shape (2, 4096, 2560)), against two operations an element.
//
// Design: a chunked scan in one pass with decoupled look-back.
// - A block owns kLanes = 128 neighbouring (b, d) lanes (one thread
//   each) over one chunk of kChunk = 64 steps.  At (2, 4096, 2560) that
//   is 2 × 20 × 64 = 2,560 blocks, several waves on 132 SMs.
// - Each thread loads its chunk's 64 a and 64 b into registers at once
//   (coalesced: a warp reads 32 neighbouring d of one step), so 64 KB a
//   block are in flight; a and b are read from device memory once.
// - It forms the chunk's composite (A, B): A = Π a_t and B = the chunk's
//   h_end from h_in = 0, so that h_end = A · h_in + B.
// - Blocks take their chunk from an atomic ticket in chunk-major order,
//   so every predecessor of a block (same b and d tile, earlier chunk)
//   was scheduled before it and nothing waits on a block that cannot
//   run.  A block publishes its composite (flag 1), looks back over its
//   predecessors — composing their composites until it meets one that
//   has published its inclusive prefix, the true h at its chunk's end
//   (flag 2), or chunk 0 — then publishes its own prefix A · h_in + B.
//   One warp reads the flags of 32 predecessors at once with ld.acquire,
//   so a look-back costs about two L2 round trips however deep it goes;
//   the data go through L2 (st.cg / ld.cg) and __threadfence orders them
//   before the flag.
// - It then rescans the chunk held in registers from h_in and writes h.
// - The flags and composites live in scratch the wrapper allocates
//   (torch.zeros for the ticket and flags, torch.empty for the 3 planes
//   of per-lane floats); the kernel allocates nothing.
// What bounds it now (tools/ablate_kernels.py, PERF.md): streaming a and
// b through registers, a little slower than torch.add over the same
// bytes, and the look-back, which holds a block's lanes idle for about
// two L2 round trips.
//
// Precision: inside a chunk the recurrence is summed in step order with
// fmaf, from h_in.  h_in itself is the predecessor prefix carried through
// the composites of the chunks between: h_in = A_acc · h_prefix + B_acc,
// with (A_acc, B_acc) composed from the nearest chunk back.  The order
// differs from a sequential walk and from the JAX model's associative
// scan, so results agree to float32 rounding, not bitwise.
//
// C interface: raw pointers, sizes, the geometry the wrapper sized the
// scratch for (checked against this file's constants) and the stream;
// each entry point launches on that stream and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // threads a block, one (b, d) lane each
constexpr int kChunk = 64;    // steps a block holds
constexpr int kAggregate = 1; // flag: the chunk's composite is published
constexpr int kPrefix = 2;    // flag: the true h at the chunk's end is

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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// Every thread's stores so far become visible before flag = state.
__device__ __forceinline__ void publish(int* flag, int state) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag, state);
}

template <typename T>
__global__ void __launch_bounds__(kLanes, 3)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ y, int B, int S, int D, int n_dt,
                   int n_chunks, int* __restrict__ ticket_flags,
                   float* __restrict__ carry) {
  __shared__ int s_ticket, s_flag;
  int* flags = ticket_flags + 1;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket_flags, 1);
  __syncthreads();
  // ticket → (chunk, b, d tile), chunk-major: flags are indexed by ticket
  const int ticket = s_ticket;
  const int groups = B * n_dt;
  const int chunk = ticket / groups;
  const int group = ticket - chunk * groups;
  const int bi = group / n_dt;
  const int d = (group - bi * n_dt) * kLanes + threadIdx.x;
  const bool live = d < D;
  const int t0 = chunk * kChunk;
  const int n = min(kChunk, S - t0);
  const long base = (static_cast<long>(bi) * S + t0) * D + d;

  // the chunk in registers; steps past S are the identity (a 1, b 0)
  float av[kChunk], bv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = live && u < n;
    av[u] = in ? to_f32(a[base + static_cast<long>(u) * D]) : 1.0f;
    bv[u] = in ? to_f32(b[base + static_cast<long>(u) * D]) : 0.0f;
  }
  float A = 1.0f, Bc = 0.0f;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    Bc = fmaf(av[u], Bc, bv[u]);
    A *= av[u];
  }

  // carry planes, each (n_chunks, B, D): composite A, composite B, prefix
  const long plane = static_cast<long>(n_chunks) * B * D;
  const long lane_off = static_cast<long>(bi) * D + d;
  float* agg_a = carry;
  float* agg_b = carry + plane;
  float* prefix = carry + 2 * plane;
  const long slot = static_cast<long>(chunk) * B * D + lane_off;

  float h_in = 0.0f;
  if (chunk > 0) {
    if (live) {
      __stcg(agg_a + slot, A);
      __stcg(agg_b + slot, Bc);
    }
    publish(flags + ticket, kAggregate);
    // Look back 32 chunks at a time: lane i of warp 0 reads the flag of
    // chunk j_hi - i, until the nearest prefix in the window (lane `stop`)
    // and every chunk after it have published.  Then each thread composes
    // the composites of chunks j_hi .. j_hi - stop + 1 into (acc_a, acc_b),
    // the map from h at the start of chunk j_hi - stop + 1 to h_in.
    float acc_a = 1.0f, acc_b = 0.0f;
    for (int j_hi = chunk - 1;; j_hi -= 32) {
      if (threadIdx.x < 32) {
        const int j = j_hi - static_cast<int>(threadIdx.x);
        const int* f = flags + static_cast<long>(j) * groups + group;
        int state = j < 0 ? kAggregate : 0;   // never read: chunk 0 is a prefix
        unsigned waiting;
        do {
          if (state == 0) state = load_acquire(f);
          // the lanes before the nearest prefix (all, if none is in sight)
          const unsigned pre = __ballot_sync(0xffffffffu, state == kPrefix);
          const unsigned before = pre ? (pre & -pre) - 1 : 0xffffffffu;
          waiting = __ballot_sync(0xffffffffu, state == 0) & before;
          if (waiting) __nanosleep(32);
        } while (waiting);
        const unsigned pre = __ballot_sync(0xffffffffu, state == kPrefix);
        if (threadIdx.x == 0) s_flag = pre ? __ffs(pre) - 1 : 32;
      }
      __syncthreads();
      const int stop = s_flag;
      __syncthreads();  // s_flag is written again in the next round
      if (live) {
#pragma unroll 8
        for (int i = 0; i < stop; ++i) {
          const long js = static_cast<long>(j_hi - i) * B * D + lane_off;
          acc_b = fmaf(acc_a, __ldcg(agg_b + js), acc_b);
          acc_a *= __ldcg(agg_a + js);
        }
      }
      if (stop < 32) {
        if (live) {
          const long js = static_cast<long>(j_hi - stop) * B * D + lane_off;
          h_in = fmaf(acc_a, __ldcg(prefix + js), acc_b);
        }
        break;
      }
    }
  }
  if (live) __stcg(prefix + slot, fmaf(A, h_in, Bc));
  publish(flags + ticket, kPrefix);

  float h = h_in;
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    if (live && u < n) {
      h = fmaf(av[u], h, bv[u]);
      y[base + static_cast<long>(u) * D] = from_f32<T>(h);
    }
  }
}

// The scratch the wrapper passes: ticket_flags holds 1 + blocks zeroed
// ints, carry 3 · n_chunks · B · D floats.
template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int D,
           int chunk, int lanes, void* ticket_flags, void* carry,
           void* stream) {
  if (chunk != kChunk || lanes != kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_dt = (D + kLanes - 1) / kLanes;
  const long blocks = static_cast<long>(n_chunks) * B * n_dt;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  linear_scan_kernel<T><<<static_cast<unsigned>(blocks), kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      B, S, D, n_dt, n_chunks, static_cast<int*>(ticket_flags),
      static_cast<float*>(carry));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int linear_scan_f32(const void* a, const void* b, void* y, int B, int S,
                    int D, int chunk, int lanes, void* ticket_flags,
                    void* carry, void* stream) {
  return launch<float>(a, b, y, B, S, D, chunk, lanes, ticket_flags, carry,
                       stream);
}

int linear_scan_bf16(const void* a, const void* b, void* y, int B, int S,
                     int D, int chunk, int lanes, void* ticket_flags,
                     void* carry, void* stream) {
  return launch<__nv_bfloat16>(a, b, y, B, S, D, chunk, lanes, ticket_flags,
                               carry, stream);
}

}  // extern "C"
