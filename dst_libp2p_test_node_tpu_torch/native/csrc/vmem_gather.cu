// Hopper counterpart of the reference's Pallas VMEM gather
// (dst_libp2p_test_node_tpu/native/vmem_gather.py, `_compiled`'s
// pallas_call): out[b, q, j] = t[b, clamp(src[b, q, j], 0, n_src - 1)].
//
// What bounds it on the H100: the random reads of t, served from L2. Each
// element streams one int32 index in and one float out (8 bytes: 320 MB at
// 1M x 40, 0.097 ms at 3.35 TB/s) and makes one random 4-byte read of t.
// t (4 MB at 1M peers) stays in the 50 MB L2, but each read is an L2
// request for a 32-byte sector of its own: 40M requests per call, which the
// L1 (5% of a 4 MB t) barely thins. native/gather_bench.py measures it, on
// an H100 SXM at 700 W: this kernel takes about 0.30 ms at 1M x 40; the
// same bytes with src sorted (sequential t reads) 0.11 ms, and random reads
// into an 8 KB t that the L1 holds 0.12 ms. So the stream runs near its
// bound and the L2 requests for t take the rest; no stream design removes
// them, and every variant of this design (stage count, tile size, blocks
// per SM, output path) and the one-thread-per-element kernel it replaced
// land within 12% of 0.30 ms.
//
// The design, part by part:
// 1. Persistent blocks (kBlocksPerSm per SM) walk tiles of the flattened
//    B*N*C index stream. One elected thread keeps a ring of kStages tiles in
//    flight with the TMA's 1-D bulk copy (cp.async.bulk ...
//    mbarrier::complete_tx), each stage guarded by an mbarrier, so the index
//    stream costs no registers or load instructions. Every thread takes
//    whole int4 vectors of indices from shared memory and issues all
//    4 * kVecs of its random t reads before it uses any of them.
// 2. Index math inside a tile is 32-bit. The batch row of a tile and the
//    element where it crosses into the next row are found once per tile; on
//    the main path (one t for the whole stream) there is no row math at all.
//    Rows shorter than a tile (small batched shapes only) take a 32-bit
//    division per element.
// 3. t is read with an evict-last L2 policy, the counterpart of pinning it
//    in VMEM; the index stream comes in, and the output goes out, as
//    evict-first streaming traffic (the bulk copy's L2::cache_hint,
//    st.global.cs), so 320 MB of stream per call does not push t out. No
//    stream access-policy window and no persisting-L2 limit is set: both
//    would change state that other kernels see.
// 4. Outputs leave as 16-byte streaming stores from registers; a TMA bulk
//    store from shared memory measured slower.
//
// A bulk copy needs 16-byte-aligned addresses and a multiple of 16 bytes.
// Tiles are whole multiples of 16 bytes from the start of the stream, which
// the wrapper requires to be 16-byte aligned; the last few elements of a
// stream whose length is not a multiple of 4 are read with plain loads.
// The clamp to [0, n_src - 1] keeps -1 pad slots (dead behind the caller's
// validity flags) and any stray index inside the table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // every thread is a consumer
constexpr int kTile = 2048;       // int32 indices per tile (8 KB)
constexpr int kStages = 3;        // ring of tiles in shared memory
constexpr int kBlocksPerSm = 2;   // persistent blocks per SM
constexpr int kVecs = kTile / 4 / kThreads;  // int4 vectors / thread / tile
static_assert(kTile % (4 * kThreads) == 0, "whole vectors per thread");
constexpr int kRingBytes = kStages * kTile * 4;
constexpr int kSmemBytes = kRingBytes + kStages * 8;  // ring + mbarriers
constexpr int kMaxDevices = 64;

// Where the t of element j of a tile starts. kShared: one t for the whole
// stream. kOneCross: rows at least a tile long, so the tile starts in row
// b0 and crosses into b0 + 1 at element `cross` at most once. kShortRows:
// rows shorter than a tile.
enum RowMode { kShared, kOneCross, kShortRows };

struct RowMap {
  const float* t0;   // t of the row the tile starts in
  int64_t stride;    // elements between the t of two rows
  uint32_t r0;       // kShortRows: offset of the tile's start in its row
  uint32_t per_row;  // kShortRows: elements per row
  int cross;         // kOneCross: first element in the next row

  template <int kMode>
  __device__ __forceinline__ const float* at(int j) const {
    if (kMode == kShared) return t0;
    if (kMode == kOneCross) return j < cross ? t0 : t0 + stride;
    return t0 + (int64_t)((r0 + (uint32_t)j) / per_row) * stride;
  }
};

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Elected thread only: bulk-copy `bytes` of indices from `src` into the ring
// stage at `dst`; the stage's mbarrier completes when they have landed (at
// once when there are none: the tail of a stream shorter than 4).
__device__ __forceinline__ void load_stage(uint32_t dst, const int32_t* src,
                                           uint32_t bytes, uint32_t bar,
                                           uint64_t pol) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  if (bytes != 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(pol)
        : "memory");
}

// A read of t through the read-only path, kept in L2 with `pol`.
__device__ __forceinline__ float ld_t(const float* p, uint64_t pol) {
  float v;
  asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ int clamp_idx(int s, int hi) {
  return min(max(s, 0), hi);
}

// The t reads of one tile of `len` elements: the full int4 vectors of
// indices (in `idx`) into `val`; the ragged end (len % 4 elements) is read
// and stored here.
template <int kMode>
__device__ __forceinline__ void gather_tile(const int4 (&idx)[kVecs],
                                            float4 (&val)[kVecs],
                                            const RowMap& rows,
                                            const int32_t* src_tile,
                                            float* out_tile, int len, int hi,
                                            uint64_t t_pol) {
  const int nvec = len >> 2;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v < nvec) {
      const int j = v * 4;
      val[i].x = ld_t(rows.at<kMode>(j) + clamp_idx(idx[i].x, hi), t_pol);
      val[i].y =
          ld_t(rows.at<kMode>(j + 1) + clamp_idx(idx[i].y, hi), t_pol);
      val[i].z =
          ld_t(rows.at<kMode>(j + 2) + clamp_idx(idx[i].z, hi), t_pol);
      val[i].w =
          ld_t(rows.at<kMode>(j + 3) + clamp_idx(idx[i].w, hi), t_pol);
    }
  }
  const int j = (nvec << 2) + threadIdx.x;
  if (j < len)
    __stcs(out_tile + j,
           ld_t(rows.at<kMode>(j) + clamp_idx(__ldcs(src_tile + j), hi),
                t_pol));
}

__global__ void __launch_bounds__(kThreads)
    vmem_gather_kernel(const float* __restrict__ t,
                       const int32_t* __restrict__ src,
                       float* __restrict__ out, int64_t total,
                       int64_t per_batch, int hi, int64_t t_stride,
                       int64_t n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int4* ring = reinterpret_cast<const int4*>(smem);
  const uint32_t ring_s = smem_addr(smem);
  const uint32_t bar_s = ring_s + kRingBytes;
  const uint64_t stream_pol = l2_evict_first();
  const uint64_t t_pol = l2_evict_last();
  const int64_t step = gridDim.x;

  // the bulk copy of tile `tile` (its whole int4 vectors) into `stage`
  auto load = [&](int64_t tile, int stage) {
    const int64_t start = tile * kTile;
    const int64_t n = min64(kTile, total - start) & ~int64_t(3);
    load_stage(ring_s + stage * (kTile * 4), src + start, (uint32_t)n * 4,
               bar_s + stage * 8, stream_pol);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(bar_s + s * 8) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages && blockIdx.x + s * step < n_tiles; ++s)
      load(blockIdx.x + s * step, s);

  int k = 0;  // tiles this block has consumed
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += step, ++k) {
    const int stage = k % kStages;
    const int64_t start = tile * kTile;
    const int len = (int)min64(kTile, total - start);
    const int nvec = len >> 2;

    mbar_wait(bar_s + stage * 8, (k / kStages) & 1);
    int4 idx[kVecs];
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) idx[i] = ring[stage * (kTile / 4) + v];
    }
    // the reads above are generic-proxy, the refill below async-proxy: the
    // proxy fence keeps the bulk copy from overwriting the stage under a
    // read still in flight
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // every warp holds its indices: refill the stage
    if (threadIdx.x == 0 && tile + kStages * step < n_tiles)
      load(tile + kStages * step, stage);

    float4 val[kVecs];
    RowMap rows{t, t_stride, 0, 0, 0};
    if (t_stride == 0) {
      gather_tile<kShared>(idx, val, rows, src + start, out + start, len, hi,
                           t_pol);
    } else {
      const int64_t b0 = start / per_batch;  // once per tile
      const int64_t r0 = start - b0 * per_batch;
      rows.t0 = t + b0 * t_stride;
      if (per_batch >= kTile) {
        rows.cross = (int)min64(per_batch - r0, kTile);
        gather_tile<kOneCross>(idx, val, rows, src + start, out + start, len,
                               hi, t_pol);
      } else {
        rows.r0 = (uint32_t)r0;
        rows.per_row = (uint32_t)per_batch;
        gather_tile<kShortRows>(idx, val, rows, src + start, out + start,
                                len, hi, t_pol);
      }
    }
    // outputs: 16-byte streaming stores from registers
    float4* out4 = reinterpret_cast<float4*>(out + start);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < nvec) __stcs(out4 + v, val[i]);
    }
  }
}

}  // namespace

// t (n_src floats, or batch rows of t_stride = n_src floats), src and out
// (batch * per_batch elements, src 16-byte aligned), on `stream`. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int vmem_gather_launch(const float* t, const int32_t* src,
                                  float* out, int64_t batch,
                                  int64_t per_batch, int64_t n_src,
                                  int64_t t_stride, void* stream) {
  const int64_t total = batch * per_batch;
  if (total == 0) return 0;
  if (reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || n_src <= 0)
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int sm_count[kMaxDevices];  // per device, queried once
  if (sm_count[dev] == 0) {
    int sms;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(vmem_gather_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sm_count[dev] = sms;
  }
  const int64_t n_tiles = (total + kTile - 1) / kTile;
  const int64_t grid = min64(n_tiles, (int64_t)kBlocksPerSm * sm_count[dev]);
  const int hi = (int)min64(n_src - 1, INT32_MAX);
  vmem_gather_kernel<<<(unsigned)grid, kThreads, kSmemBytes,
                       (cudaStream_t)stream>>>(t, src, out, total, per_batch,
                                               hi, t_stride, n_tiles);
  return (int)cudaGetLastError();
}

extern "C" const char* vmem_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
