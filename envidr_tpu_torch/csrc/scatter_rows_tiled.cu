// Row-tiled scatter-add through shared memory, for NVIDIA Hopper (sm_90a).
//
//   out[idx[b], :] += Acc(rows[b, :])        out: [S, W] f32, idx: [B] i32
//
// with an f32 accumulator (scatter_rows_tiled_f32_launch) or a bf16 one
// (scatter_rows_tiled_bf16_launch: each row value is rounded to bf16 and
// added in bf16, as tools/bench_gs4.py:make_tiled accumulates in acc_dtype;
// the sums are widened to f32 on the way out).  Indices lie in [0, S) (not
// checked).
//
// Replaces the Pallas TPU kernels of the scatter micro-benchmarks:
//   tools/bench_scatter.py:324  s_pallas_fori     (one VMEM accumulator, S = 4096)
//   tools/bench_scatter2.py:126 make_pallas_multi (K VMEM accumulators, summed)
//   tools/bench_gs4.py:51       make_tiled        (S-tiled K accumulators,
//                                                  f32 or bf16)
// A TPU has no atomics, so those kernels keep K accumulator copies and, for
// tables larger than VMEM, scan the batch once per table tile.  Here the
// K copies and the n_tiles grid of the TPU kernels are not carried over:
// shared-memory atomics take the place of the accumulator copies.
//
// Bound: bytes (the index and rows read once, the output written once).
// Design: each block owns a tile of output rows (as many as fit in 192 KB of
// dynamic shared memory: 2891 rows of 16 f32, 5461 in bf16, each row padded
// by one word) and one share of the batch.  It zeroes its tile, scans its
// share of the indices (one per thread and step), adds each row that falls
// in its tile with shared-memory atomics, and flushes the tile: plain stores
// when one block covers the whole batch for that tile, global atomicAdd
// (into an output zeroed first) otherwise.  The batch
// is split only while each block still receives about two rows for each row
// of its tile, so that the flush costs no more than the scan.  At S = 2^19
// this rereads the 1 MB index array once per tile (182 tiles, mostly from
// L2); a bucketing pass would remove that.
//
// C interface for ctypes; each launcher returns the cudaError_t of its
// attribute call (made once per device), memset and launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int64_t kTileBytes = 192 * 1024;

// A tile row is padded by one 32-bit word so that its length in words is odd
// (W + 1 floats, or W + 2 bf16 for W a multiple of 4): the rows that the
// threads of a warp add to then start in different banks.  Unpadded, element
// k of every row would sit in banks k and k + 16 (W = 16), a 16-way conflict.
template <typename Acc> constexpr int64_t kPad = 4 / sizeof(Acc);

__device__ __forceinline__ void zero(float* p) { *p = 0.0f; }
__device__ __forceinline__ void zero(__nv_bfloat16* p) { *p = __float2bfloat16_rn(0.0f); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void add4(float* dst, float4 v) {
  atomicAdd(dst + 0, v.x);
  atomicAdd(dst + 1, v.y);
  atomicAdd(dst + 2, v.z);
  atomicAdd(dst + 3, v.w);
}

__device__ __forceinline__ void add4(__nv_bfloat16* dst, float4 v) {
  // two bf16x2 atomics; each half is rounded to nearest even, added and
  // rounded again in bf16
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  atomicAdd(d + 0, __floats2bfloat162_rn(v.x, v.y));
  atomicAdd(d + 1, __floats2bfloat162_rn(v.z, v.w));
}

// Adds batch row b to tile row r if r lies in the tile: the row's float4s are
// all loaded before the first atomic.
template <typename Acc>
__device__ __forceinline__ void add_if_in_tile(Acc* tile, const float4* __restrict__ rows,
                                               int64_t b, int64_t r, int64_t T, int W) {
  if (r < 0 || r >= T) return;
  const float4* src = rows + b * (W / 4);
  Acc* dst = tile + r * (W + kPad<Acc>);
  if (W == 16) {
    float4 v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(src + q);
#pragma unroll
    for (int q = 0; q < 4; ++q) add4(dst + 4 * q, v[q]);
  } else {
    for (int q = 0; q < W / 4; ++q) add4(dst + 4 * q, __ldg(src + q));
  }
}

template <typename Acc>
__global__ void __launch_bounds__(kThreads)
scatter_rows_tiled_kernel(const int32_t* __restrict__ idx,
                          const float4* __restrict__ rows,
                          float* __restrict__ out, int64_t B, int64_t S,
                          int W, int64_t tile_rows, int64_t rows_per_split,
                          int atomic_flush) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* tile = reinterpret_cast<Acc*>(smem);
  const int64_t t0 = (int64_t)blockIdx.x * tile_rows;
  const int T = (int)min(tile_rows, S - t0);
  const int stride = W + (int)kPad<Acc>;
  for (int i = threadIdx.x; i < T * stride; i += blockDim.x) zero(tile + i);
  __syncthreads();

  // the scan of this block's share of the batch
  const int64_t b0 = (int64_t)blockIdx.y * rows_per_split;
  const int64_t b1 = min(B, b0 + rows_per_split);
  for (int64_t b = b0 + threadIdx.x; b < b1; b += blockDim.x)
    add_if_in_tile(tile, rows, b, (int64_t)__ldg(idx + b) - t0, T, W);
  __syncthreads();

  // the flush
  float* o = out + t0 * W;
  for (int i = threadIdx.x; i < T * W; i += blockDim.x) {
    const float v = widen(tile[(i / W) * stride + i % W]);
    if (!atomic_flush) {
      o[i] = v;
    } else if (v != 0.0f) {
      atomicAdd(o + i, v);
    }
  }
}

// Raise the kernel's dynamic shared memory limit to kTileBytes, once per
// instantiation and device.
template <typename Acc>
cudaError_t allow_tile_smem(int dev) {
  static bool done[64] = {};
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(scatter_rows_tiled_kernel<Acc>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kTileBytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename Acc>
int launch(const void* idx, const void* rows, void* out, int64_t B, int64_t S,
           int64_t W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0 || W == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = allow_tile_smem<Acc>(dev);
  if (err != cudaSuccess) return (int)err;

  const int64_t row_bytes = (W + kPad<Acc>) * (int64_t)sizeof(Acc);
  int64_t tile_rows = kTileBytes / row_bytes;
  if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  if (tile_rows > S) tile_rows = S;
  const int64_t n_tiles = (S + tile_rows - 1) / tile_rows;
  tile_rows = (S + n_tiles - 1) / n_tiles;          // even tiles
  int64_t n_splits = B / (2 * S);
  const int64_t max_splits = (2 * (int64_t)sms + n_tiles - 1) / n_tiles;
  if (n_splits > max_splits) n_splits = max_splits;
  if (n_splits < 1) n_splits = 1;
  const int64_t rows_per_split = (B + n_splits - 1) / n_splits;
  const int atomic_flush = n_splits > 1;

  if (atomic_flush) {
    err = cudaMemsetAsync(out, 0, (size_t)(S * W) * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)(tile_rows * row_bytes);
  const dim3 grid((unsigned)n_tiles, (unsigned)n_splits);
  scatter_rows_tiled_kernel<Acc><<<grid, kThreads, smem, s>>>(
      static_cast<const int32_t*>(idx), static_cast<const float4*>(rows),
      static_cast<float*>(out), B, S, (int)W, tile_rows, rows_per_split,
      atomic_flush);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scatter_rows_tiled_f32_launch(const void* idx, const void* rows,
                                             void* out, int64_t B, int64_t S,
                                             int64_t W, void* stream) {
  return launch<float>(idx, rows, out, B, S, W, stream);
}

extern "C" int scatter_rows_tiled_bf16_launch(const void* idx, const void* rows,
                                              void* out, int64_t B, int64_t S,
                                              int64_t W, void* stream) {
  return launch<__nv_bfloat16>(idx, rows, out, B, S, W, stream);
}
