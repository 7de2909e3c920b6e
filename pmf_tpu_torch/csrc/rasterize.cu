// K2: z-buffer rasterization of a batch of point clouds into dense canvases.
//
// Replaces the Pallas TPU kernel
// pmf_tpu/ops/pallas/tile_fill.py:rasterize_zbuffer_pallas (_make_kernel).
// The TPU version sorts the points twice in XLA (pixel, quantized depth),
// then DMAs each image row's winners into VMEM and places them with a
// one-hot matrix product per 128-column tile, because TPU scatters
// serialise. Hopper has native atomics, so the same function is two passes:
//
//   pass 1, one thread per point: atomicMin of the key (dq << b) | index into
//           its pixel, where dq = int(clip(depth / depth_quant, 0, 65535)).
//           The minimum is the nearest point, the lowest index on ties: the
//           stable sort's winner.
//   pass 2, one writer per pixel: decode the winner's index, copy its F
//           values, write the occupancy mask; zeros where the pixel is empty.
//           Every output element has exactly one writer, so the result is
//           deterministic and equal to the TPU kernel's bit for bit.
//
// Key width: dq takes 16 bits, so for n <= 65535 points a scan (every index
// <= 65534) the key is 32-bit, (dq << 16) | index, and all-ones, which no
// point can produce, marks an empty pixel. For n >= 65536 the same kernels
// run with 64-bit keys, (dq << 32) | index. The C entry chooses by n.
//
// Bound on an H100 (3.35 TB/s): bytes. At the eval batch (B = 8,
// N = 32768, 384x1232, F = 6) the canvas is 90.8 MB, the mask 3.8 MB and the
// point inputs 9.7 MB: about 31 us. What the design does about it:
//   - the 32-bit key image is 15.1 MB (64-bit: 30.3 MB), so its all-ones
//     init (a memset issued here), the atomics and pass 2's re-read mostly
//     stay in the 50 MB L2;
//   - pass 2 stages each block's run of 512 consecutive pixels of one scan
//     (two a thread) in shared memory and writes the canvas and mask with
//     16-byte streaming stores, so every DRAM sector it writes is whole and
//     the stream does not evict the keys; empty pixels read no values;
//   - pass 2 reads the keys with streaming loads and then discards their L2
//     lines, so the dirty key image is never written back to DRAM;
//   - index math is 32-bit within a scan, with blockIdx.y as the scan.
// In trials on an H100, 512 pixels a block (against 256 and 1024), the
// streaming stores and the discard each took time off pass 2.
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;            // threads a block, both passes
constexpr int kRun = 2 * kThreads;       // pixels a block in pass 2
constexpr int kMaxNarrowPoints = 65535;  // most points a scan for 32-bit keys
constexpr int kMaxSharedBytes = 48 * 1024;

// The point index takes the low half of a key, dq the high half.
template <typename Key>
constexpr int kIndexBits = 4 * sizeof(Key);

template <typename Key>
__global__ void winners_kernel(const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ cols,
                               const float* __restrict__ depth,
                               const bool* __restrict__ keep,
                               Key* __restrict__ keys, int n, int h, int w,
                               float depth_quant) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= (unsigned)n) return;
  const size_t i = (size_t)blockIdx.y * n + t;
  if (!keep[i]) return;
  const int r = min(max(rows[i], 0), h - 1);
  const int c = min(max(cols[i], 0), w - 1);
  // an IEEE division (no fast math), as the plain version's f32 division
  const float q = fminf(fmaxf(depth[i] / depth_quant, 0.0f), 65535.0f);
  const Key key = ((Key)(unsigned)q << kIndexBits<Key>) | t;
  atomicMin(keys + (size_t)blockIdx.y * h * w + (unsigned)(r * w + c), key);
}

// dst[0, len) = src[0, len) by the whole block, with 16-byte streaming stores
// between a scalar head and tail. src lies at the same offset from a 16-byte
// boundary as dst, so the vector part is aligned on both sides.
template <typename T>
__device__ void store_run(T* __restrict__ dst, const T* __restrict__ src,
                          unsigned len) {
  constexpr unsigned kPer = 16 / sizeof(T);
  const unsigned mis = (unsigned)((uintptr_t)dst & 15) / sizeof(T);
  const unsigned head = min(len, (kPer - mis) % kPer);
  const unsigned vecs = (len - head) / kPer;
  for (unsigned i = threadIdx.x; i < head; i += kThreads) dst[i] = src[i];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (unsigned i = threadIdx.x; i < vecs; i += kThreads) __stcs(d4 + i, s4[i]);
  for (unsigned i = head + vecs * kPer + threadIdx.x; i < len; i += kThreads)
    dst[i] = src[i];
}

// Block (x, y) owns pixels [512x, 512x + 512) of scan y.
template <typename Key>
__global__ void fill_kernel(const Key* __restrict__ keys,
                            const float* __restrict__ values,
                            float* __restrict__ canvas,
                            bool* __restrict__ mask, int n, int hw, int f) {
  extern __shared__ __align__(16) float stage[];  // [4 + kRun * f]
  __shared__ __align__(16) bool occupied[kRun + 16];
  const unsigned p0 = blockIdx.x * kRun;
  const unsigned count = min((unsigned)kRun, (unsigned)hw - p0);
  const size_t first = (size_t)blockIdx.y * hw + p0;
  float* out = canvas + first * f;
  bool* mout = mask + first;
  float* s = stage + (((uintptr_t)out >> 2) & 3);  // out's offset mod 16 B
  bool* m = occupied + ((uintptr_t)mout & 15);

  for (unsigned t = threadIdx.x; t < count; t += kThreads) {
    const Key k = __ldcs(keys + first + t);
    const bool hit = k != (Key)~(Key)0;
    float* row = s + t * f;
    if (hit) {
      constexpr Key kIndexMask = ((Key)1 << kIndexBits<Key>) - 1;
      const float* v = values + ((size_t)blockIdx.y * n + (unsigned)(k & kIndexMask)) * f;
      for (int j = 0; j < f; ++j) row[j] = v[j];
    } else {
      for (int j = 0; j < f; ++j) row[j] = 0.0f;
    }
    m[t] = hit;
  }
  __syncthreads();
  // the run's keys are dead: drop the whole 128-byte lines they fill from L2
  const uintptr_t lo = ((uintptr_t)(keys + first) + 127) & ~(uintptr_t)127;
  const uintptr_t hi = (uintptr_t)(keys + first + count) & ~(uintptr_t)127;
  for (uintptr_t a = lo + 128 * threadIdx.x; a < hi; a += 128 * kThreads)
    asm volatile("discard.global.L2 [%0], 128;" ::"l"(a) : "memory");
  store_run(out, s, count * f);
  store_run(mout, m, count);
}

template <typename Key>
int launch(const int32_t* rows, const int32_t* cols, const float* depth,
           const bool* keep, const float* values, Key* keys, float* canvas,
           bool* mask, int batch, int n, int h, int w, int f,
           float depth_quant, size_t smem, cudaStream_t s) {
  const int hw = h * w;
  int err = (int)cudaMemsetAsync(keys, 0xff, (size_t)batch * hw * sizeof(Key), s);
  if (err) return err;
  if (n > 0) {
    const dim3 grid((n + kThreads - 1) / kThreads, batch);
    winners_kernel<Key><<<grid, kThreads, 0, s>>>(rows, cols, depth, keep, keys,
                                                   n, h, w, depth_quant);
  }
  const dim3 grid((hw + kRun - 1) / kRun, batch);
  fill_kernel<Key><<<grid, kThreads, smem, s>>>(keys, values, canvas, mask, n, hw, f);
  return (int)cudaGetLastError();
}

}  // namespace

// rows, cols: [batch, n] int32; depth: [batch, n] f32; keep: [batch, n] bool;
// values: [batch, n, f] f32; keys: scratch of batch*h*w*8 bytes, 8-byte
// aligned (its contents are set here); canvas: [batch, h, w, f] f32 and
// mask: [batch, h, w] bool, every element written here; all on CUDA device
// `device`. Needs batch <= 65535, h*w*f and n*f < 2^31, and f <= 23 (the
// staged run fits in 48 KB of shared memory). Returns a cudaError_t:
// cudaErrorInvalidValue for what it does not take, else cudaGetLastError()
// after the launches.
extern "C" int pmf_rasterize_zbuffer(const int32_t* rows, const int32_t* cols,
                                     const float* depth, const bool* keep,
                                     const float* values, void* keys,
                                     float* canvas, bool* mask, int batch,
                                     int n, int h, int w, int f,
                                     float depth_quant, int device,
                                     void* stream) {
  const long long hw = (long long)h * w;
  const size_t smem = (4 + (size_t)kRun * f) * sizeof(float);
  if (batch < 0 || n < 0 || h < 0 || w < 0 || f < 0 || batch > 65535 ||
      hw * (f > 0 ? f : 1) >= (1ll << 31) || (long long)n * f >= (1ll << 31) ||
      smem > kMaxSharedBytes || ((uintptr_t)keys & 7))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || hw == 0) return 0;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= kMaxNarrowPoints)
    return launch(rows, cols, depth, keep, values, (uint32_t*)keys, canvas, mask,
                  batch, n, h, w, f, depth_quant, smem, s);
  return launch(rows, cols, depth, keep, values, (unsigned long long*)keys,
                canvas, mask, batch, n, h, w, f, depth_quant, smem, s);
}
