// Backward of the linear recurrence scan for Hopper (sm_90a): for
// h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, over (B, S, D) inputs and the
// upstream gradient dh,
//   g_t  = dh_t + a_{t+1} * g_{t+1},  g_{S-1} = dh_{S-1},
//   db_t = g_t,
//   da_t = g_t * h_{t-1},              h_{-1} = 0 (da_0 = 0),
// with the state and the carry in float32 and the gradients written in the
// inputs' type.
//
// Replaces no Pallas kernel: src/repro/kernels/linear_scan/kernel.py::
// linear_scan (K4) has no VJP, and the JAX package trains through autodiff
// of its jnp scans (src/repro/models/scan_ops.py).  This kernel computes
// what that autodiff computes, so RG-LRU and Mamba train on the card
// through K4 (kernels/linear_scan/ops.py::LinearScan).
//
// Bound on this card: bytes.  a, h and dh are read once and da and db
// written once, 20 bytes an element in float32 (419 MB, 0.125 ms at 3.35
// TB/s at RG-LRU's training shape (2, 4096, 2560); 1.34 GB, 0.401 ms at
// Mamba's chunk (2, 256, 131072)), against four operations an element.
//
// Design: the forward's chunked scan with decoupled look-back
// (linear_scan.cu), run backwards, with a look-back of fixed depth so that
// two runs give the same bits.  Written as a plain scan:
//   x_t = a_t * g_t = a_t * (dh_t + x_{t+1}),  x_S = 0,  g_t = dh_t + x_{t+1},
// so a chunk [t0, t0 + n) maps the x coming in from the later chunk,
// x_{t0+n}, to the x it passes on, x_{t0} = A * x_{t0+n} + Bc, with
// A = Π a_t and Bc = x_{t0} from a zero carry-in.
// - A block owns kLanes = 128 neighbouring (b, d) lanes over one chunk of
//   kChunk = 32 steps (half the forward's: the block holds three arrays
//   of a chunk, not two).  Each thread holds the chunk's a and dh in
//   registers and stages h_{t-1} in shared memory, its own column, so
//   the look-back runs beside 64 live floats and nothing spills.
//   h_{t0-1} is the previous chunk's last row of the saved h, and 0 at
//   t0 = 0 of every batch row.
// - Blocks take their chunk from an atomic ticket in reverse chunk-major
//   order: the last chunk first.  Count chunks from the end, r = 0, 1,
//   ...; a block's predecessors are the chunks of lower r in its (b, d
//   tile), which hold earlier tickets and so were scheduled before it;
//   nothing waits on a block that cannot run.
// - It publishes its composite (flag 1) and looks back to its anchor,
//   the chunk at the largest multiple of kWindow = 32 below r: one warp
//   reads the flags of the up to 32 chunks in between at once with
//   ld.acquire, until the anchor has published its inclusive prefix
//   (flag 2: the true x at its start) and the chunks between their
//   composites.  It composes those composites in a fixed order onto the
//   anchor's prefix, so x_in does not depend on which flags a run found
//   set first (the forward's look-back stops at the nearest prefix it
//   sees, and its bits vary from run to run), publishes its own prefix
//   A * x_in + Bc, then rescans the chunk from x_in, last step first, and
//   writes db and da.  Anchors wait on the anchor before them: a chain
//   of S / (kChunk * kWindow) links a (b, d tile).
// - The flags and composites live in scratch the wrapper allocates
//   (torch.zeros for the ticket and flags, torch.empty for the 3 planes
//   of per-lane floats); the kernel allocates nothing.
//
// Precision: inside a chunk the recurrence is summed in reverse step
// order from x_in; x_in is the anchor's prefix carried through at most 31
// composites, so results agree with a sequential walk to float32
// rounding, not bitwise, and with themselves bitwise.  The bf16 entry
// reads the saved h in bf16 (the forward's output), a rounding that
// autograd through the plain scan, which keeps its state in float32, does
// not have: its da is held at the bf16 relative limit, not the float32
// one.
//
// C interface: raw pointers, sizes, the geometry the wrapper sized the
// scratch for (checked against this file's constants) and the stream;
// each entry point launches on that stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;   // threads a block, one (b, d) lane each
constexpr int kChunk = 32;    // steps a block holds
constexpr int kWindow = 32;   // chunks from an anchor to the next
constexpr int kAggregate = 1; // flag: the chunk's composite is published
constexpr int kPrefix = 2;    // flag: the true x at the chunk's start is

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
linear_scan_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                       const T* __restrict__ dh, T* __restrict__ da,
                       T* __restrict__ db, int B, int S, int D, int n_dt,
                       int n_chunks, int* __restrict__ ticket_flags,
                       float* __restrict__ carry) {
  __shared__ int s_ticket;
  __shared__ float s_hp[kChunk][kLanes];   // h_{t-1}, a column a thread
  int* flags = ticket_flags + 1;
  if (threadIdx.x == 0) s_ticket = atomicAdd(ticket_flags, 1);
  __syncthreads();
  // ticket → (r, b, d tile), r-major, where r counts chunks from the end:
  // flags and carry slots are indexed by ticket, so by r
  const int ticket = s_ticket;
  const int groups = B * n_dt;
  const int r = ticket / groups;
  const int group = ticket - r * groups;
  const int bi = group / n_dt;
  const int d = (group - bi * n_dt) * kLanes + threadIdx.x;
  const bool live = d < D;
  const int t0 = (n_chunks - 1 - r) * kChunk;
  const int n = min(kChunk, S - t0);
  const long base = (static_cast<long>(bi) * S + t0) * D + d;

  // a and dh in registers, h_{t-1} in shared memory; steps past S are
  // the identity (a 1, dh 0)
  float av[kChunk], gv[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const bool in = live && u < n;
    const long at = base + static_cast<long>(u) * D;
    av[u] = in ? to_f32(a[at]) : 1.0f;
    gv[u] = in ? to_f32(dh[at]) : 0.0f;
    s_hp[u][threadIdx.x] = in && t0 + u > 0 ? to_f32(h[at - D]) : 0.0f;
  }
  // the composite, last step first: x ← a_t (dh_t + x)
  float A = 1.0f, Bc = 0.0f;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    Bc = av[u] * (gv[u] + Bc);
    A *= av[u];
  }

  // carry planes, each (n_chunks, B, D) by r: composite A, composite B,
  // prefix
  const long plane = static_cast<long>(n_chunks) * B * D;
  const long lane_off = static_cast<long>(bi) * D + d;
  float* agg_a = carry;
  float* agg_b = carry + plane;
  float* prefix = carry + 2 * plane;
  const long slot = static_cast<long>(r) * B * D + lane_off;

  float x_in = 0.0f;
  if (r > 0) {
    if (live) {
      __stcg(agg_a + slot, A);
      __stcg(agg_b + slot, Bc);
    }
    publish(flags + ticket, kAggregate);
    // Look back to the anchor: lane i of warp 0 waits on chunk r - 1 - i
    // while that lies at or after the anchor, for the anchor's prefix and
    // the others' composites.  Then each thread composes the composites of
    // r - 1 .. anchor + 1, in that order, onto the anchor's prefix.
    const int anchor = (r - 1) / kWindow * kWindow;
    if (threadIdx.x < 32) {
      const int j = r - 1 - static_cast<int>(threadIdx.x);
      const int need = j == anchor ? kPrefix : kAggregate;
      const int* f = flags + static_cast<long>(j) * groups + group;
      int state = j >= anchor ? 0 : need;   // lanes past the anchor: done
      unsigned waiting;
      do {
        if (state < need) state = load_acquire(f);
        waiting = __ballot_sync(0xffffffffu, state < need);
        if (waiting) __nanosleep(32);
      } while (waiting);
    }
    __syncthreads();
    if (live) {
      float acc_a = 1.0f, acc_b = 0.0f;
#pragma unroll 8
      for (int j = r - 1; j > anchor; --j) {
        const long js = static_cast<long>(j) * B * D + lane_off;
        acc_b = fmaf(acc_a, __ldcg(agg_b + js), acc_b);
        acc_a *= __ldcg(agg_a + js);
      }
      const long js = static_cast<long>(anchor) * B * D + lane_off;
      x_in = fmaf(acc_a, __ldcg(prefix + js), acc_b);
    }
  }
  if (live) __stcg(prefix + slot, fmaf(A, x_in, Bc));
  publish(flags + ticket, kPrefix);

  float x = x_in;
#pragma unroll
  for (int u = kChunk - 1; u >= 0; --u) {
    if (live && u < n) {
      const float g = gv[u] + x;
      const long at = base + static_cast<long>(u) * D;
      db[at] = from_f32<T>(g);
      da[at] = from_f32<T>(g * s_hp[u][threadIdx.x]);
      x = av[u] * g;
    }
  }
}

// The scratch the wrapper passes: ticket_flags holds 1 + blocks zeroed
// ints, carry 3 · n_chunks · B · D floats.
template <typename T>
int launch(const void* a, const void* h, const void* dh, void* da, void* db,
           int B, int S, int D, int chunk, int lanes, void* ticket_flags,
           void* carry, void* stream) {
  if (chunk != kChunk || lanes != kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_dt = (D + kLanes - 1) / kLanes;
  const long blocks = static_cast<long>(n_chunks) * B * n_dt;
  if (blocks > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  linear_scan_bwd_kernel<T><<<static_cast<unsigned>(blocks), kLanes, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(dh), static_cast<T*>(da), static_cast<T*>(db),
      B, S, D, n_dt, n_chunks, static_cast<int*>(ticket_flags),
      static_cast<float*>(carry));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int linear_scan_bwd_f32(const void* a, const void* h, const void* dh,
                        void* da, void* db, int B, int S, int D, int chunk,
                        int lanes, void* ticket_flags, void* carry,
                        void* stream) {
  return launch<float>(a, h, dh, da, db, B, S, D, chunk, lanes,
                       ticket_flags, carry, stream);
}

int linear_scan_bwd_bf16(const void* a, const void* h, const void* dh,
                         void* da, void* db, int B, int S, int D, int chunk,
                         int lanes, void* ticket_flags, void* carry,
                         void* stream) {
  return launch<__nv_bfloat16>(a, h, dh, da, db, B, S, D, chunk, lanes,
                               ticket_flags, carry, stream);
}

}  // extern "C"
