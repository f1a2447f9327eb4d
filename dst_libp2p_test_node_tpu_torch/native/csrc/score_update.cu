// Hopper counterpart of the reference's Pallas fused scoring update
// (dst_libp2p_test_node_tpu/native/score_update.py, `_compiled`'s
// pallas_call), elementwise over the (N, C) counters:
//   f = fmd * scales[0],  s = slow * scales[1], each flushed to 0 below
//   decay_to_zero;  score = fmd_weight * min(f, fmd_cap) + slow_weight * s.
//
// What bounds it on the H100: bytes. 8 bytes in and 12 bytes out per
// element, a handful of flops: at 1M x 40 that is 800 MB per call, about
// 0.24 ms at 3.35 TB/s. The design streams each counter through registers
// once (the point of the fusion) with one thread per element.
//
// The two scales arrive as a float pair on the device, like the TPU
// kernel's (2,) scale block, so the caller's carried f32 scalars never
// leave the device. Multiplies and the add use the _rn intrinsics so nvcc
// cannot contract them into an FMA: f and s are then bitwise the plain
// formula's, and so is the score.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void score_update_kernel(const float* __restrict__ fmd,
                                    const float* __restrict__ slow,
                                    const float* __restrict__ scales,
                                    float* __restrict__ f_out,
                                    float* __restrict__ s_out,
                                    float* __restrict__ score_out,
                                    int64_t total, float fmd_weight,
                                    float slow_weight, float fmd_cap,
                                    float decay_to_zero) {
  const float f_scale = scales[0];
  const float s_scale = scales[1];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (; i < total; i += step) {
    float f = __fmul_rn(fmd[i], f_scale);
    float s = __fmul_rn(slow[i], s_scale);
    f = f < decay_to_zero ? 0.0f : f;
    s = s < decay_to_zero ? 0.0f : s;
    f_out[i] = f;
    s_out[i] = s;
    score_out[i] = __fadd_rn(__fmul_rn(fmd_weight, fminf(f, fmd_cap)),
                             __fmul_rn(slow_weight, s));
  }
}

// `threads` per block (a launch argument: 256 unless the wrapper's
// override or the tuning table says otherwise; whole warps, 32 to 1024).
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
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) blocks = 0x7FFFFFFF;  // grid-stride beyond this
  score_update_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      fmd, slow, scales, f_out, s_out, score_out, total, fmd_weight,
      slow_weight, fmd_cap, decay_to_zero);
  return (int)cudaGetLastError();
}

extern "C" const char* score_update_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
