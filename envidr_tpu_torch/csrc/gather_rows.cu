// Row gather from a table, for NVIDIA Hopper (sm_90a).
//
//   out[b, :] = table[idx[b], :]                 gather_rows_f32_launch
//   out[b, :] = f32(bf16(table[idx[b], :]))      gather_rows_round_bf16_launch
//
// table: [S, W] f32 (W a multiple of 4, 16-byte aligned), idx: [B] i32 in
// [0, S) (not checked), out: [B, W] f32 with B * W < 2^31.
//
// Replaces the Pallas TPU kernels of the gather micro-benchmark:
//   tools/bench_scatter.py:182 g_pallas_take   (jnp.take from a VMEM table)
//   tools/bench_scatter.py:209 g_pallas_taa    (take_along_axis, same function)
//   tools/bench_scatter.py:249 g_pallas_onehot (one-hot x table tile on the
//       MXU in bf16 with f32 sums: each output is one table value rounded to
//       bf16, which the round_bf16 instantiation computes directly)
// The TPU kernels keep the [4096, 16] table in VMEM; in f32 that is 256 KiB,
// more than the 227 KB of shared memory a Hopper block may use, and it sits
// in the 50 MB L2 anyway.  The one-hot product (2^19 x B x 16 x 2 = 4.4
// PFLOP at the bench shape) is not carried over.
//
// Bound: bytes (the index, the table rows the indices touch, the output).
// Design: each warp gathers 32 rows.  A lane loads one index of them (one
// coalesced load) and the lanes hand the indices out with __shfl_sync.  The
// rows' P = W / 4 quarters (16 bytes each) are visited as t = s * 32 + lane,
// s < P, so each step stores 32 contiguous quarters of the output; quarter
// t lies in row t / P at t % P, found with one division a thread and a
// carry a step, none an element.  A thread issues all its table loads (P,
// 4 for W = 16) before its first store; stores are streaming
// (st.global.cs), as nothing reads the output again.  Offsets are 32-bit.
// One 256-thread block a 256 rows: at the bench shape (B = 262,144) the grid
// is 1024 blocks, one wave of 132 SMs x 8 blocks.  W = 16 is instantiated
// with P known to the compiler; every other width takes the generic
// instantiation (P read at run time).
// Table loads: <f32> through the read-only path (each of the bench's 4096
// rows is read 64 times); <round_bf16> with L1::no_allocate (a cold 33.5 MB
// table, no reuse).  Rounding is round-to-nearest-even, as
// jnp.astype(bfloat16) and torch.bfloat16 do.
//
// C interface for ctypes; each launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;            // 8 warps of 32 rows

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

template <bool ROUND>
__device__ __forceinline__ float4 load_quarter(const float4* p) {
  if (!ROUND) return __ldg(p);
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// (row, quarter) of the lane's quarter t = s * 32 + lane among rows of P
// quarters each; next() steps s by one.
struct Walk {
  int r, q, dr, dq, P;
  __device__ __forceinline__ Walk(int lane, int P_) : P(P_) {
    r = lane / P;
    q = lane - r * P;
    dr = 32 / P;
    dq = 32 - dr * P;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    q += dq;
    if (q >= P) {
      q -= P;
      ++r;
    }
  }
};

template <int P_, bool ROUND>               // P_ = 0: P read at run time
__global__ void __launch_bounds__(THREADS, P_ ? 8 : 4)
gather_rows_kernel(const float4* __restrict__ table,
                   const int32_t* __restrict__ idx, float4* __restrict__ out,
                   int B, int P_rt) {
  constexpr int BATCH = 4;                 // loads in flight before the stores
  const int P = P_ ? P_ : P_rt;
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5)) * 32;
  if (row0 >= B) return;                   // whole warps
  const int n = min(32, B - row0);         // rows of this warp
  const int mine = lane < n ? __ldg(idx + row0 + lane) : 0;
  float4* dst = out + row0 * P;
  Walk w(lane, P);
  for (int s0 = 0; s0 < P; s0 += BATCH) {
    float4 v[BATCH];
    bool ok[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int row = __shfl_sync(FULL, mine, w.r & 31);
      ok[j] = s0 + j < P && w.r < n;
      if (ok[j]) v[j] = load_quarter<ROUND>(table + (size_t)row * P + w.q);
      w.next();
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (ok[j]) __stcs(dst + (s0 + j) * 32 + lane, ROUND ? round4(v[j]) : v[j]);
  }
}

template <int P_, bool ROUND>
int launch_p(const void* table, const void* idx, void* out, int B, int P,
             cudaStream_t stream) {
  gather_rows_kernel<P_, ROUND><<<(B + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(idx),
      static_cast<float4*>(out), B, P);
  return (int)cudaGetLastError();
}

template <bool ROUND>
int launch(const void* table, const void* idx, void* out, int64_t B, int64_t W,
           void* stream) {
  if (W <= 0 || W % 4 || B < 0 || B * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W == 16) return launch_p<4, ROUND>(table, idx, out, (int)B, 4, s);
  return launch_p<0, ROUND>(table, idx, out, (int)B, (int)(W / 4), s);
}

// An empty kernel on the same C interface: the fixed cost of one launch
// through ctypes and ops/_cuda.py:launch, the floor of every timed gather.
__global__ void empty_kernel() {}

}  // namespace

extern "C" int gather_rows_empty_launch(const void*, const void*, void*, int64_t,
                                        int64_t, void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int gather_rows_f32_launch(const void* table, const void* idx,
                                      void* out, int64_t B, int64_t W,
                                      void* stream) {
  return launch<false>(table, idx, out, B, W, stream);
}

extern "C" int gather_rows_round_bf16_launch(const void* table, const void* idx,
                                             void* out, int64_t B, int64_t W,
                                             void* stream) {
  return launch<true>(table, idx, out, B, W, stream);
}
