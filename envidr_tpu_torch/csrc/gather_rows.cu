// Row gather from a table, for NVIDIA Hopper (sm_90a).
//
//   out[b, :] = table[idx[b], :]                 gather_rows_f32_launch
//   out[b, :] = f32(bf16(table[idx[b], :]))      gather_rows_round_bf16_launch
//
// table: [S, W] f32, idx: [B] i32 in [0, S) (not checked), out: [B, W] f32.
//
// Replaces the Pallas TPU kernels of the gather micro-benchmark:
//   tools/bench_scatter.py:182 g_pallas_take   (jnp.take from a VMEM table)
//   tools/bench_scatter.py:209 g_pallas_taa    (take_along_axis, same function)
//   tools/bench_scatter.py:249 g_pallas_onehot (one-hot x table tile on the
//       MXU in bf16 with f32 sums: each output is one table value rounded to
//       bf16, which the round_bf16 instantiation computes directly)
// The TPU kernels keep the [4096, 16] table in VMEM; in f32 that is 256 KiB,
// more than the 227 KB of shared memory a Hopper block may use, and it sits
// in the 50 MB L2 anyway, so the table is read through the read-only path.
// The one-hot product (2^19 x B x 16 x 2 = 4.4 PFLOP at the bench shape) is
// not carried over.
//
// Bound: bytes (the index, the table rows the indices touch, the output).
// Design: one thread per 16-byte quarter of an output row, so a warp writes
// 8 whole rows (W = 16) with contiguous float4 stores; the 4 threads of a
// row read the same index (a broadcast).  Rounding is round-to-nearest-even,
// as jnp.astype(bfloat16) and torch.bfloat16 do.
//
// C interface for ctypes; each launcher returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool ROUND>
__global__ void gather_rows_kernel(const float4* __restrict__ table,
                                   const int32_t* __restrict__ idx,
                                   float4* __restrict__ out, int64_t B,
                                   int64_t Wq) {
  const int64_t total = B * Wq;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t b = t / Wq;
    const int64_t q = t - b * Wq;
    const int64_t row = (int64_t)__ldg(idx + b);
    float4 v = __ldg(table + row * Wq + q);
    if (ROUND) {
      v.x = round_bf16(v.x);
      v.y = round_bf16(v.y);
      v.z = round_bf16(v.z);
      v.w = round_bf16(v.w);
    }
    out[t] = v;
  }
}

template <bool ROUND>
int launch(const void* table, const void* idx, void* out, int64_t B, int64_t W,
           void* stream) {
  const int64_t Wq = W / 4;
  const int64_t total = B * Wq;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;   // grid-stride beyond this
  gather_rows_kernel<ROUND><<<(unsigned)blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int32_t*>(idx),
      static_cast<float4*>(out), B, Wq);
  return (int)cudaGetLastError();
}

}  // namespace

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
