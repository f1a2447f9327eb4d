// Hopper counterpart of the reference's Pallas fused scoring update
// (dst_libp2p_test_node_tpu/native/score_update.py, `_compiled`'s
// pallas_call), elementwise over the (N, C) counters:
//   f = fmd * scales[0],  s = slow * scales[1], each flushed to 0 below
//   decay_to_zero;  score = fmd_weight * min(f, fmd_cap) + slow_weight * s.
//
// What bounds it on the H100: bytes. 8 bytes in and 12 bytes out per
// element (8 out in the decay-only form, which writes no score), a handful
// of flops: at 1M x 40 that is 800 MB per call, about 0.24 ms at 3.35 TB/s.
// The design keeps enough bytes in flight per SM to reach that rate with as
// few instructions and blocks as it can:
//
// 1. 128-bit streaming. Each thread moves float4s, kUnroll of them per
//    array per iteration, all loads issued before the first store. Inputs
//    are read once, through the non-coherent path without L1 allocation.
// 2. A persistent grid: as many blocks as the SMs hold at once at the
//    caller's threads per block (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//    fewer when the work is smaller; the grid-stride loop covers the rest,
//    so no block is launched and retired per 256 elements.
// 3. Alignment. When every pointer is 16-byte aligned (the caching
//    allocator's tensors always are) the float4 body covers all but the
//    last numel % 4 elements, which a scalar tail takes; otherwise (a row
//    slice x[1:] of an (n, 37) tensor) the kernel runs a scalar
//    grid-stride loop instead.
// 4. The decay-only form (score_out == nullptr) is the same kernel with the
//    score store compiled out (kScore = false): what the port's callers
//    need (ops/heartbeat.run_heartbeats, ops/telemetry), 16 bytes an
//    element.
//
// On an H100 80GB HBM3 at 700 W both forms reach about 83% of the byte
// bound at 1M x 40, the share PyTorch's own copy_ reaches on one counter:
// the memory's rate for a mix of reads and writes, not the kernel's
// instructions, is what is left (native/score_bench.py times the load and
// store hints, the unroll and the grid beside it; none moved it by 1%).
//
// The two scales arrive as a float pair on the device, like the TPU
// kernel's (2,) scale block, so the caller's carried f32 scalars never
// leave the device. Multiplies and the add use the _rn intrinsics so nvcc
// cannot contract them into an FMA: f and s are then bitwise the plain
// formula's, and so is the score.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 2;      // float4s per array per thread and iteration
constexpr int kMaxDevices = 64;
constexpr int kMaxWarps = 32;   // 1024 threads

struct Decay {
  float f_scale, s_scale, fmd_weight, slow_weight, fmd_cap, decay_to_zero;

  __device__ __forceinline__ float f(float x) const {
    const float v = __fmul_rn(x, f_scale);
    return v < decay_to_zero ? 0.0f : v;
  }
  __device__ __forceinline__ float s(float x) const {
    const float v = __fmul_rn(x, s_scale);
    return v < decay_to_zero ? 0.0f : v;
  }
  __device__ __forceinline__ float score(float f, float s) const {
    return __fadd_rn(__fmul_rn(fmd_weight, fminf(f, fmd_cap)),
                     __fmul_rn(slow_weight, s));
  }
};

// Read-once loads: non-coherent path, no L1 allocation.
__device__ __forceinline__ float4 ld4(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ float ld1(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

template <bool kScore>
__device__ __forceinline__ void one(const Decay& d, const float* fmd,
                                    const float* slow, float* f_out,
                                    float* s_out, float* score_out,
                                    int64_t i) {
  const float f = d.f(ld1(fmd + i));
  const float s = d.s(ld1(slow + i));
  f_out[i] = f;
  s_out[i] = s;
  if (kScore) score_out[i] = d.score(f, s);
}

template <bool kScore>
__device__ __forceinline__ void four(const Decay& d, float4 a, float4 b,
                                     float4* f_out, float4* s_out,
                                     float4* score_out, int64_t v) {
  const float4 f = make_float4(d.f(a.x), d.f(a.y), d.f(a.z), d.f(a.w));
  const float4 s = make_float4(d.s(b.x), d.s(b.y), d.s(b.z), d.s(b.w));
  f_out[v] = f;
  s_out[v] = s;
  if (kScore) {
    const float4 sc = make_float4(d.score(f.x, s.x), d.score(f.y, s.y),
                                  d.score(f.z, s.z), d.score(f.w, s.w));
    score_out[v] = sc;
  }
}

// The first n_vec float4s vectorized and elements [4 n_vec, total) scalar;
// or, when !vec, every element scalar.
template <bool kScore>
__global__ void __launch_bounds__(1024) score_update_kernel(
    const float* __restrict__ fmd, const float* __restrict__ slow,
    const float* __restrict__ scales, float* __restrict__ f_out,
    float* __restrict__ s_out, float* __restrict__ score_out, int64_t total,
    bool vec, int64_t n_vec, float fmd_weight, float slow_weight,
    float fmd_cap, float decay_to_zero) {
  const Decay d{scales[0], scales[1], fmd_weight, slow_weight, fmd_cap,
                decay_to_zero};
  const int64_t bd = blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * bd + threadIdx.x;
  if (!vec) {
    const int64_t step = (int64_t)gridDim.x * bd;
    for (int64_t i = tid; i < total; i += step)
      one<kScore>(d, fmd, slow, f_out, s_out, score_out, i);
    return;
  }
  if (tid < total - 4 * n_vec)
    one<kScore>(d, fmd, slow, f_out, s_out, score_out, 4 * n_vec + tid);

  const float4* fmd4 = reinterpret_cast<const float4*>(fmd);
  const float4* slow4 = reinterpret_cast<const float4*>(slow);
  float4* f4 = reinterpret_cast<float4*>(f_out);
  float4* s4 = reinterpret_cast<float4*>(s_out);
  float4* score4 = reinterpret_cast<float4*>(score_out);
  // a chunk is kUnroll * blockDim float4s; thread t takes t, t + blockDim..
  const int64_t step = (int64_t)gridDim.x * bd * kUnroll;
  int64_t v = (int64_t)blockIdx.x * bd * kUnroll + threadIdx.x;
  for (; v + (kUnroll - 1) * bd < n_vec; v += step) {
    float4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = ld4(fmd4 + v + u * bd);
      b[u] = ld4(slow4 + v + u * bd);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      four<kScore>(d, a[u], b[u], f4, s4, score4, v + u * bd);
  }
  // this thread's share of the last, partial chunk
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t w = v + u * bd;
    if (w < n_vec)
      four<kScore>(d, ld4(fmd4 + w), ld4(slow4 + w), f4, s4, score4, w);
  }
}

// Per device, queried once: the SM count and, per form and threads per
// block, the most blocks one SM holds at once.
int sm_count[kMaxDevices];
int resident[kMaxDevices][2][kMaxWarps + 1];

cudaError_t grid_limit(int threads, bool with_score, int64_t* out) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sm_count[dev] = sms;
  }
  int& occ = resident[dev][with_score][threads / 32];
  if (occ == 0) {
    err = with_score ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &occ, score_update_kernel<true>, threads, 0)
                     : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &occ, score_update_kernel<false>, threads, 0);
    if (err != cudaSuccess) return err;
    if (occ == 0) return cudaErrorInvalidConfiguration;
  }
  *out = (int64_t)occ * sm_count[dev];
  return cudaSuccess;
}

}  // namespace

// `threads` per block (a launch argument: 256 unless the wrapper's
// override or the tuning table says otherwise; whole warps, 32 to 1024).
// score_out == nullptr launches the decay-only form. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int score_update_launch(const float* fmd, const float* slow,
                                   const float* scales, float* f_out,
                                   float* s_out, float* score_out,
                                   int64_t total, float fmd_weight,
                                   float slow_weight, float fmd_cap,
                                   float decay_to_zero, int threads,
                                   void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidConfiguration;
  if (total == 0) return 0;
  const bool with_score = score_out != nullptr;
  int64_t grid;
  cudaError_t err = grid_limit(threads, with_score, &grid);
  if (err != cudaSuccess) return (int)err;

  const uintptr_t bits = reinterpret_cast<uintptr_t>(fmd) |
                         reinterpret_cast<uintptr_t>(slow) |
                         reinterpret_cast<uintptr_t>(f_out) |
                         reinterpret_cast<uintptr_t>(s_out) |
                         reinterpret_cast<uintptr_t>(score_out);
  const bool vec = bits % 16 == 0;
  const int64_t n_vec = vec ? total / 4 : 0;
  const int64_t work = vec ? (n_vec + kUnroll - 1) / kUnroll : total;
  const int64_t need = (work + threads - 1) / threads;
  if (need < grid) grid = need > 0 ? need : 1;
  cudaStream_t st = (cudaStream_t)stream;
  if (with_score)
    score_update_kernel<true><<<(unsigned)grid, threads, 0, st>>>(
        fmd, slow, scales, f_out, s_out, score_out, total, vec, n_vec,
        fmd_weight, slow_weight, fmd_cap, decay_to_zero);
  else
    score_update_kernel<false><<<(unsigned)grid, threads, 0, st>>>(
        fmd, slow, scales, f_out, s_out, nullptr, total, vec, n_vec,
        fmd_weight, slow_weight, fmd_cap, decay_to_zero);
  return (int)cudaGetLastError();
}

extern "C" const char* score_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
