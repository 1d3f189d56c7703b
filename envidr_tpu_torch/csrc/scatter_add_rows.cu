// Batched scatter-add of hash-table gradient rows, for NVIDIA Hopper (sm_90a).
//
//   out[l, idx[l, b], :] += rows[l, b, :]      out: [L, S_max, W] f32, zeroed here
//
// Replaces the Pallas TPU kernel envidr_tpu/ops/pallas_scatter.py:scatter_add_rows
// (body _kernel, :45-61).  The TPU version keeps K accumulator copies of one
// level's table in VMEM because a TPU has no atomics; on Hopper every level
// goes through this one launch, and the sum is made by atomicAdd in device
// memory (L2 resolves the atomics).
//
// Bound: bytes.  The call reads L*B*(4 + 4W) bytes of indices and rows and
// writes L*S_max*W*4 bytes of output (the memset included); nothing is
// computed but the adds.  Design: one thread per 16-byte quarter of a row,
// so a warp reads 8 whole rows (W = 16) as contiguous float4 loads; the index
// is read once per thread (a broadcast within the row's 4 threads).  Atomic
// contention is highest on the small dense levels (level 0 has 4096 slots for
// 262,144 rows); privatising those levels in shared memory is a later step.
//
// A second entry point, scatter_add_rows_round_bf16_launch, rounds each row
// value to bf16 (round-to-nearest-even) before the f32 atomicAdd.  It replaces
// tools/bench_scatter.py:287 s_pallas_onehot, the micro-benchmark's scatter
// as onehot^T @ bf16(rows) on the MXU with f32 sums; the one-hot product is
// not carried over.  The f32 instantiation is the train step's.
//
// C interface for ctypes; returns the cudaError_t of the memset and launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool ROUND>
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ idx,
                                        const float4* __restrict__ rows,
                                        float* __restrict__ out,
                                        int64_t L, int64_t B, int64_t S_max,
                                        int64_t Wq) {
  const int64_t total = L * B * Wq;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / Wq;         // flat (l, b)
    const int64_t q = t - row * Wq;     // which float4 of the row
    const int64_t l = row / B;
    const int64_t slot = (int64_t)__ldg(idx + row);
    float4 v = __ldg(rows + t);
    if (ROUND) {
      v.x = round_bf16(v.x);
      v.y = round_bf16(v.y);
      v.z = round_bf16(v.z);
      v.w = round_bf16(v.w);
    }
    float* dst = out + ((l * S_max + slot) * Wq + q) * 4;
    atomicAdd(dst + 0, v.x);
    atomicAdd(dst + 1, v.y);
    atomicAdd(dst + 2, v.z);
    atomicAdd(dst + 3, v.w);
  }
}

template <bool ROUND>
int launch(const void* idx, const void* rows, void* out, int64_t L, int64_t B,
           int64_t S_max, int64_t W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)(L * S_max * W) * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  const int64_t Wq = W / 4;
  const int64_t total = L * B * Wq;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;   // grid-stride beyond this
  scatter_add_rows_kernel<ROUND><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const float4*>(rows),
      static_cast<float*>(out), L, B, S_max, Wq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_add_rows_launch(const void* idx, const void* rows,
                                       void* out, int64_t L, int64_t B,
                                       int64_t S_max, int64_t W,
                                       void* stream) {
  return launch<false>(idx, rows, out, L, B, S_max, W, stream);
}

extern "C" int scatter_add_rows_round_bf16_launch(const void* idx, const void* rows,
                                                  void* out, int64_t L, int64_t B,
                                                  int64_t S_max, int64_t W,
                                                  void* stream) {
  return launch<true>(idx, rows, out, L, B, S_max, W, stream);
}
