// The CP tables' two-tap row gather and its adjoint scatter, for NVIDIA
// Hopper (sm_90a).
//
//   cp_rows_gather_launch:   v0[n, :] = T[i0[n], :],  v1[n, :] = T[i0[n] + 1, :]
//   cp_rows_scatter_launch:  dT = 0;  dT[i0[n], :] += dv0[n, :];
//                            dT[i0[n] + 1, :] += dv1[n, :]
//
// T, dT: [R, rank] f32 (R >= 2, rank a positive multiple of 4, T 16-byte
// aligned); i0: [N] i64, clamped into [0, R - 2] (the encoder's indices lie
// there already; a NaN position's index does not, and is read as a row of
// the table instead of an address outside it); v0, v1, dv0, dv1: [N, rank]
// f32, N * rank < 2^31; dv0 or dv1 may be null (a tap with no gradient).
//
// Replaces no TPU kernel: the JAX package interpolates the CP tables with a
// dense two-hot matmul (envidr_tpu/ops/cp.py) that XLA fuses.  These two
// replace the port's index_select pair in ops/cp.py:_axis_feat and the two
// index_add_s autograd made of it.  Each is the other's adjoint, so the
// autograd pair built on them (ops/cp_rows.py) is differentiable to any order.
//
// Bound: bytes.  A gather reads the index and writes 2 N rows; a scatter
// reads the index and 2 N rows and writes R rows.  At the train step's
// shape (N = 524,288, rank 32) that is 138 MB a call, 41 us at 3.35 TB/s.
//
// What is in the way of that bound is the data, not the bytes.  87% of the
// step's slots are empty and all encode the same point, so in every table
// ~457,000 of the 524,288 indices are the same row pair, in runs of about 28
// (K = 32 slots a ray, 4.1 live).  index_add_ adds each of those rows with
// its own atomics into the same two rows of device memory, where they
// serialise in one L2 slice; index_select reads those two rows from every SM
// through the same slice.
//
// Gather: one thread a 16-byte quarter of an output row (a warp stores 4
// contiguous rows of each tap).  The table is read through L1 with
// ld.global.nc (__ldg): the hot row pair then hits in each SM's own L1 and
// L2 sees one miss an SM.  Copying the table into shared memory was not
// chosen: every block would read the whole table (up to 256 KB at R = 2048,
// which does not fit) to use a few of its rows.
//
// Scatter: one warp takes a contiguous chunk of slots, lane = rank column,
// so each slot's row is one coalesced 128-byte load per tap (streaming
// loads, read once); the loads of 8 slots are issued before they are summed.
// While i0 repeats, the warp keeps a running sum in registers and adds it
// once when the run ends: an empty run of ~28 slots costs one add instead of
// 28.  Where the table fits a block's dynamic shared memory (R * rank * 4
// bytes, up to 227 KB: levels 0-14 of the train step's 16, up to 190 KB),
// the runs' sums go into a block-private shared copy of the table (shared
// atomics), and each block adds its copy's touched 16-byte quarters into
// device memory once, with 16-byte vector atomics.  A larger table (level
// 15, 256 KB) takes the runs' sums into device memory directly, with the
// same vector atomics (four lanes' columns gathered into one lane by
// shuffles).  The launcher picks the path from the table's size and the
// device's limit and reports it.  One memset and one launch a call.
// Either path sums in f32 in another order than index_add_.
//
// C interface for ctypes; each launcher returns the first cudaError_t of its
// memset, attribute calls and launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kGatherThreads = 256;
constexpr int kScatterThreads = 512;     // 16 warps share a block's table copy
constexpr int kBatch = 8;                // slots loaded before they are summed

__device__ __forceinline__ int clamp_row(long long r, int last) {
  return r < 0 ? 0 : (r > last ? last : (int)r);
}

template <int WQ_>                       // quarters a row; 0: read at run time
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float4* __restrict__ table, const long long* __restrict__ i0,
              float4* __restrict__ v0, float4* __restrict__ v1, int total, int wq_rt,
              int last) {
  const int wq = WQ_ ? WQ_ : wq_rt;
  const int t = blockIdx.x * kGatherThreads + threadIdx.x;
  if (t >= total) return;
  const int n = t / wq, q = t - n * wq;
  const float4* row = table + (size_t)clamp_row(__ldg(i0 + n), last) * wq + q;
  const float4 a = __ldg(row), b = __ldg(row + wq);
  v0[t] = a;
  v1[t] = b;
}

// A run's column sum (one column a lane, columns c0 + lane) into device
// memory: lanes 0-7 each add four neighbouring columns, one vector atomic.
__device__ __forceinline__ void add_global(float* dT, int row, int rank, int c0, float a,
                                           int lane) {
  const int src = (4 * lane) & 31;
  const float x = __shfl_sync(FULL, a, src), y = __shfl_sync(FULL, a, src + 1);
  const float z = __shfl_sync(FULL, a, src + 2), w = __shfl_sync(FULL, a, src + 3);
  if (lane < 8 && c0 + 4 * lane < rank)
    atomicAdd(reinterpret_cast<float4*>(dT + (size_t)row * rank + c0 + 4 * lane),
              make_float4(x, y, z, w));
}

template <bool SHARED>
__device__ __forceinline__ void flush(float* acc, int row, int rank, int c0, int lane,
                                      float a0, float a1, bool tap0, bool tap1) {
  if (SHARED) {
    if (c0 + lane < rank) {
      if (tap0) atomicAdd(acc + row * rank + c0 + lane, a0);
      if (tap1) atomicAdd(acc + (row + 1) * rank + c0 + lane, a1);
    }
  } else {
    if (tap0) add_global(acc, row, rank, c0, a0, lane);
    if (tap1) add_global(acc, row + 1, rank, c0, a1, lane);
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(kScatterThreads, 2)
scatter_kernel(const float* __restrict__ dv0, const float* __restrict__ dv1,
               const long long* __restrict__ i0, float* __restrict__ dT, int N, int R,
               int rank, int chunk) {
  extern __shared__ float4 shared4[];
  float* const tab = SHARED ? reinterpret_cast<float*>(shared4) : dT;
  const int quarters = R * rank / 4;
  if (SHARED) {
    for (int i = threadIdx.x; i < quarters; i += kScatterThreads)
      shared4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (kScatterThreads / 32) + (threadIdx.x >> 5);
  const int begin = (int)min((long long)N, (long long)warp * chunk);
  const int end = min(N, begin + chunk);
  const bool tap0 = dv0 != nullptr, tap1 = dv1 != nullptr;
  const int last = R - 2;
  for (int c0 = 0; c0 < rank; c0 += 32) {
    const int col = c0 + lane;
    const bool on = col < rank;
    int cur = -1;
    float a0 = 0.f, a1 = 0.f;
    for (int base = begin; base < end; base += 32) {
      const int m = min(32, end - base);
      const int mine = lane < m ? clamp_row(__ldg(i0 + base + lane), last) : 0;
      for (int j0 = 0; j0 < m; j0 += kBatch) {
        float x0[kBatch], x1[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool ok = on && j0 + j < m;
          const size_t off = (size_t)(base + j0 + j) * rank + col;
          x0[j] = ok && tap0 ? __ldcs(dv0 + off) : 0.f;
          x1[j] = ok && tap1 ? __ldcs(dv1 + off) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = __shfl_sync(FULL, mine, (j0 + j) & 31);
          if (j0 + j < m) {                        // the same for the whole warp
            if (r != cur) {
              if (cur >= 0) flush<SHARED>(tab, cur, rank, c0, lane, a0, a1, tap0, tap1);
              cur = r;
              a0 = a1 = 0.f;
            }
            a0 += x0[j];
            a1 += x1[j];
          }
        }
      }
    }
    if (cur >= 0) flush<SHARED>(tab, cur, rank, c0, lane, a0, a1, tap0, tap1);
  }
  if (SHARED) {
    __syncthreads();
    float4* d4 = reinterpret_cast<float4*>(dT);
    for (int i = threadIdx.x; i < quarters; i += kScatterThreads) {
      const float4 v = shared4[i];
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) atomicAdd(d4 + i, v);
    }
  }
}

// Per device: SMs and the opt-in dynamic shared memory of a block; per
// (device, shared bytes): resident scatter blocks an SM.  Asked once each.
struct DeviceInfo {
  int sms = 0, shared_optin = 0;
};

std::mutex cache_mutex;
std::map<int, DeviceInfo> devices;
std::map<std::pair<int, int64_t>, int> blocks_per_sm;

cudaError_t device_info(int dev, DeviceInfo* out) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  auto it = devices.find(dev);
  if (it == devices.end()) {
    DeviceInfo info;
    cudaError_t err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&info.shared_optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(scatter_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 info.shared_optin);
    if (err != cudaSuccess) return err;
    it = devices.emplace(dev, info).first;
  }
  *out = it->second;
  return cudaSuccess;
}

template <bool SHARED>
cudaError_t scatter_blocks(int dev, int64_t shared, int* out) {
  std::lock_guard<std::mutex> lock(cache_mutex);
  const auto key = std::make_pair(dev, SHARED ? shared : -1);
  auto it = blocks_per_sm.find(key);
  if (it == blocks_per_sm.end()) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scatter_kernel<SHARED>, kScatterThreads, SHARED ? (size_t)shared : 0);
    if (err != cudaSuccess) return err;
    it = blocks_per_sm.emplace(key, std::max(per_sm, 1)).first;
  }
  *out = it->second;
  return cudaSuccess;
}

bool bad_shape(int64_t N, int64_t R, int64_t rank) {
  return N < 0 || R < 2 || rank <= 0 || rank % 4 || N * rank >= (1LL << 31) ||
         R * rank >= (1LL << 31);
}

}  // namespace

extern "C" int cp_rows_gather_launch(const void* table, const void* i0, void* v0, void* v1,
                                     int64_t N, int64_t R, int64_t rank, void* stream) {
  if (bad_shape(N, R, rank)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = (int)(N * rank / 4), wq = (int)(rank / 4), last = (int)(R - 2);
  const unsigned blocks = (unsigned)((total + kGatherThreads - 1) / kGatherThreads);
  const float4* t = static_cast<const float4*>(table);
  const long long* i = static_cast<const long long*>(i0);
  float4* a = static_cast<float4*>(v0);
  float4* b = static_cast<float4*>(v1);
  if (wq == 8)
    gather_kernel<8><<<blocks, kGatherThreads, 0, s>>>(t, i, a, b, total, wq, last);
  else
    gather_kernel<0><<<blocks, kGatherThreads, 0, s>>>(t, i, a, b, total, wq, last);
  return (int)cudaGetLastError();
}

// *took_shared is set to 1 when the block-private shared copy was used, 0
// when the runs' sums went to device memory directly.
extern "C" int cp_rows_scatter_launch(const void* dv0, const void* dv1, const void* i0,
                                      void* dT, int64_t N, int64_t R, int64_t rank,
                                      void* took_shared, void* stream) {
  if (bad_shape(N, R, rank)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  DeviceInfo info;
  if ((err = device_info(dev, &info)) != cudaSuccess) return (int)err;
  const int64_t bytes = R * rank * 4;
  const bool shared = bytes <= info.shared_optin;
  *static_cast<int32_t*>(took_shared) = shared ? 1 : 0;
  if ((err = cudaMemsetAsync(dT, 0, (size_t)bytes, s)) != cudaSuccess) return (int)err;
  if (N == 0 || (dv0 == nullptr && dv1 == nullptr)) return (int)cudaSuccess;
  int per_sm = 0;
  err = shared ? scatter_blocks<true>(dev, bytes, &per_sm)
               : scatter_blocks<false>(dev, 0, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t warps_needed = N;                  // at most one warp a slot
  const int64_t blocks = std::min<int64_t>(
      (int64_t)info.sms * per_sm, (warps_needed + kScatterThreads / 32 - 1) /
                                      (kScatterThreads / 32));
  const int64_t warps = blocks * (kScatterThreads / 32);
  const int chunk = (int)((N + warps - 1) / warps);
  const float* g0 = static_cast<const float*>(dv0);
  const float* g1 = static_cast<const float*>(dv1);
  const long long* i = static_cast<const long long*>(i0);
  float* out = static_cast<float*>(dT);
  if (shared)
    scatter_kernel<true><<<(unsigned)blocks, kScatterThreads, (size_t)bytes, s>>>(
        g0, g1, i, out, (int)N, (int)R, (int)rank, chunk);
  else
    scatter_kernel<false><<<(unsigned)blocks, kScatterThreads, 0, s>>>(
        g0, g1, i, out, (int)N, (int)R, (int)rank, chunk);
  return (int)cudaGetLastError();
}
