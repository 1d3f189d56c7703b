// Row scatter-add with 16-byte vector atomics, for NVIDIA Hopper (sm_90a).
//
//   out[l * S + idx[l, b], :] += Acc(rows[l, b, :])
//   idx: [L, B] i32 in [0, S) (not checked), rows: [L, B, W] f32 (W % 4 == 0),
//   out: [L * S, W] f32, every row written (rows no index hits are 0)
//
// Replaces the Pallas TPU kernels
//   envidr_tpu/ops/pallas_scatter.py:64 scatter_add_rows (body _kernel, :45)
//       -> scatter_add_rows_launch (the train step's hash-table gradient)
//   tools/bench_scatter.py:287 s_pallas_onehot
//       -> scatter_add_rows_round_bf16_launch (onehot^T @ bf16(rows) with f32
//          sums: each row value is rounded to bf16 before the f32 add; the
//          one-hot product is not carried over)
//   tools/bench_scatter.py:324 s_pallas_fori, tools/bench_scatter2.py:126
//   make_pallas_multi, tools/bench_gs4.py:51 make_tiled
//       -> scatter_rows_tiled_f32_launch / scatter_rows_tiled_bf16_launch
//          (one level; the bf16 accumulator sums in bf16, as make_tiled does
//          in acc_dtype; "tiled" is the TPU kernels' name, not this design's)
// A TPU has no atomics, so those kernels keep K accumulator copies in VMEM
// and, for tables larger than VMEM, scan the batch once per table tile.
// Neither is carried over.
//
// Bound: bytes.  A call reads L*B*(4 + 4W) bytes of indices and rows and
// writes L*S*W*4 bytes of output; nothing is computed but the adds.
//
// Design: level by level, the level's output is zeroed and each thread adds
// one 16-byte quarter of a row with one vector atomicAdd(float4*) into device
// memory, which L2 resolves.  The zeros are written just before the atomics
// that need them, by a memset for level 0 and, for each next level, by the
// previous level's launch after its atomics, so the atomics find the zeroed
// lines in L2 (a level of the train step's output is 33.5 MB; zeroing all
// 537 MB first left every atomic to fetch its line back from device memory).
// The rows are read once, as streaming loads, which leaves L2 to the output.
// A call is one memset and L launches.
//
// With the bf16 accumulator each value is rounded to bf16 and added in bf16
// into the high half of its f32 output word, one 16-byte bf16x2 vector
// atomic for the four words: the low halves get +0 and stay 0, so every word
// holds its bf16 sum widened to f32 (a bf16 is the high half of the f32 of
// the same value).  Each sum is thus rounded to bf16, as in a bf16 table.
//
// A design that sorts the rows by output tile first (a counting sort, then
// one shared-memory sum and one plain write per tile) was built and timed
// against this one on an H100 and lost at every shape the port runs
// (PERF.md); it would only win on tables denser than 2048 rows a slot.
//
// C interface for ctypes; each launcher returns the first cudaError_t of its
// memset and launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 round_bf16(float4 v) {
  v.x = __bfloat162float(__float2bfloat16_rn(v.x));
  v.y = __bfloat162float(__float2bfloat16_rn(v.y));
  v.z = __bfloat162float(__float2bfloat16_rn(v.z));
  v.w = __bfloat162float(__float2bfloat16_rn(v.w));
  return v;
}

// Add a quarter row into the f32 output: one 16-byte vector atomic
// (compute capability 9.x).
__device__ __forceinline__ void add_quarter(float4* dst, float4 v, float) {
  atomicAdd(dst, v);
}

__device__ __forceinline__ uint32_t high_half_bf16(float v) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(0.0f, v);     // .x low, .y high
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The bf16 accumulator's add: in bf16, into the high half of each f32 word.
__device__ __forceinline__ void add_quarter(float4* dst, float4 v, __nv_bfloat16) {
  asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};"
               :: "l"(dst), "r"(high_half_bf16(v.x)), "r"(high_half_bf16(v.y)),
                  "r"(high_half_bf16(v.z)), "r"(high_half_bf16(v.w)) : "memory");
}

// One level: its B rows' atomics into out, then the zeros of the next
// level's output (n_zero float4s at zero).
template <typename Acc, bool ROUND>
__global__ void __launch_bounds__(kThreads)
level_kernel(const int32_t* __restrict__ idx, const float4* __restrict__ rows,
             float4* __restrict__ out, uint32_t B, uint32_t Wq,
             float4* __restrict__ zero, uint64_t n_zero) {
  const uint64_t n = (uint64_t)B * Wq;
  const uint64_t stride = (uint64_t)gridDim.x * blockDim.x;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; t < n; t += stride) {
    const uint32_t e = (uint32_t)(t / Wq), q = (uint32_t)(t % Wq);
    float4 v = __ldcs(rows + t);
    if (ROUND) v = round_bf16(v);
    add_quarter(out + (uint64_t)__ldg(idx + e) * Wq + q, v, Acc());
  }
  for (uint64_t i = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n_zero; i += stride)
    zero[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename Acc, bool ROUND>
int launch(const void* idx_, const void* rows_, void* out_, int64_t L, int64_t B, int64_t S,
           int64_t W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L == 0 || W == 0) return (int)cudaSuccess;              // nothing to write
  const int32_t* idx = static_cast<const int32_t*>(idx_);
  const float4* rows = static_cast<const float4*>(rows_);
  float4* out = static_cast<float4*>(out_);
  const int64_t Wq = W / 4, per_level = S * Wq;
  // One block per resident slot (asked once per device): every block
  // finishes its share of the atomics before it writes the next level's
  // zeros.
  static int blocks_of[64] = {};
  int dev = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64) blocks = blocks_of[dev];
  if (!blocks) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_kernel<Acc, ROUND>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    blocks = sms * std::max(per_sm, 1);
    if (dev < 64) blocks_of[dev] = blocks;
  }
  if ((err = cudaMemsetAsync(out, 0, per_level * sizeof(float4), s)) != cudaSuccess)
    return (int)err;
  for (int64_t l = 0; l < L; ++l) {
    float4* o = out + l * per_level;
    level_kernel<Acc, ROUND><<<(unsigned)blocks, kThreads, 0, s>>>(
        idx + l * B, rows + l * B * Wq, o, (uint32_t)B, (uint32_t)Wq, o + per_level,
        l + 1 < L ? (uint64_t)per_level : 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

#define SCATTER_ENTRY(name, Acc, ROUND)                                                \
  extern "C" int name(const void* idx, const void* rows, void* out, int64_t L,         \
                      int64_t B, int64_t S, int64_t W, void* stream) {                 \
    return launch<Acc, ROUND>(idx, rows, out, L, B, S, W, stream);                     \
  }

SCATTER_ENTRY(scatter_add_rows_launch, float, false)
SCATTER_ENTRY(scatter_add_rows_round_bf16_launch, float, true)
SCATTER_ENTRY(scatter_rows_tiled_f32_launch, float, false)
SCATTER_ENTRY(scatter_rows_tiled_bf16_launch, __nv_bfloat16, false)
