// Hopper counterpart of the reference's Pallas VMEM gather
// (dst_libp2p_test_node_tpu/native/vmem_gather.py, `_compiled`'s
// pallas_call): out[b, q, j] = t[b, clamp(src[b, q, j], 0, n_src - 1)].
//
// What bounds it on the H100: bytes. Each output element reads one int32
// index and writes one float; the t vector (4 MB at 1M peers) is read at
// random, but it fits the 50 MB L2 and is read through the read-only path
// (__ldg), so after the first touch the random reads hit L2. This is the
// counterpart of the TPU kernel pinning t in VMEM for the whole row sweep.
// The streamed bytes are 8 per element: at 1M x 40 that is 320 MB per
// sweep, plus the 4 MB table once.
//
// Design: one thread per output element over the flattened (B, N*C)
// index space (a grid-stride loop only past 2^31 blocks), and a leading batch
// dimension (t_stride = 0 shares one t across the batch; t_stride = n_src
// gives each batch row its own t), so a fragment loop or one batched call
// both work. The clamp to [0, n_src - 1] keeps -1 pad slots (dead behind
// the caller's validity flags) and any stray index inside the table.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void vmem_gather_kernel(const float* __restrict__ t,
                                   const int32_t* __restrict__ src,
                                   float* __restrict__ out,
                                   int64_t total, int64_t per_batch,
                                   int64_t n_src, int64_t t_stride) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (; i < total; i += step) {
    int64_t s = src[i];
    s = s < 0 ? 0 : (s >= n_src ? n_src - 1 : s);
    const int64_t b = i / per_batch;
    out[i] = __ldg(t + b * t_stride + s);
  }
}

extern "C" int vmem_gather_launch(const float* t, const int32_t* src,
                                  float* out, int64_t batch,
                                  int64_t per_batch, int64_t n_src,
                                  int64_t t_stride, void* stream) {
  const int64_t total = batch * per_batch;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) blocks = 0x7FFFFFFF;  // grid-stride beyond this
  vmem_gather_kernel<<<(unsigned)blocks, threads, 0,
                       (cudaStream_t)stream>>>(t, src, out, total, per_batch,
                                               n_src, t_stride);
  return (int)cudaGetLastError();
}

extern "C" const char* vmem_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
