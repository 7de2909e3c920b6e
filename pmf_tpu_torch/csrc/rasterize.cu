// K2: z-buffer rasterization of a batch of point clouds into dense canvases.
//
// Replaces the Pallas TPU kernel
// pmf_tpu/ops/pallas/tile_fill.py:rasterize_zbuffer_pallas (_make_kernel).
// The TPU version sorts the points twice in XLA (pixel, quantized depth),
// then DMAs each image row's winners into VMEM and places them with a
// one-hot matrix product per 128-column tile, because TPU scatters
// serialise. Hopper has native 64-bit atomics, so the same function is two
// plain passes:
//
//   pass 1, one thread per point: atomicMin of the 64-bit key
//           (dq << 32) | point_index into its pixel, where
//           dq = int(clip(depth / depth_quant, 0, 65535)). The minimum is the
//           nearest point, the lowest index on ties: the stable sort's winner.
//   pass 2, one thread per pixel: decode the winner's index, copy its F
//           values, write the occupancy mask; zeros where the pixel is empty.
//           Every output element has exactly one writer, so the result is
//           deterministic and equal to the TPU kernel's bit for bit.
//
// Bound on an H100 (3.35 TB/s): bytes. At the eval batch (B = 8,
// N = 32768, 384x1232, F = 6) the canvas is 90.8 MB, the mask 3.8 MB and the
// point inputs 9.7 MB: about 31 us. The 64-bit key image (30 MB) is scratch
// on top of that; the caller fills it with all-ones bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;

__global__ void winners_kernel(const int32_t* __restrict__ rows,
                               const int32_t* __restrict__ cols,
                               const float* __restrict__ depth,
                               const bool* __restrict__ keep,
                               unsigned long long* __restrict__ keys,
                               long long total, int n, int h, int w,
                               float depth_quant) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total || !keep[t]) return;
  int r = min(max(rows[t], 0), h - 1);
  int c = min(max(cols[t], 0), w - 1);
  float q = fminf(fmaxf(depth[t] / depth_quant, 0.0f), 65535.0f);
  unsigned long long dq = (unsigned long long)(int)q;  // truncates, as astype
  long long b = t / n;
  unsigned long long idx = (unsigned long long)(t - b * n);
  atomicMin(keys + b * (long long)h * w + (long long)r * w + c,
            (dq << 32) | idx);
}

__global__ void fill_kernel(const unsigned long long* __restrict__ keys,
                            const float* __restrict__ values,
                            float* __restrict__ canvas,
                            bool* __restrict__ mask,
                            long long total, int n, int hw, int f) {
  long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= total) return;
  unsigned long long k = keys[t];
  float* out = canvas + t * f;
  if (k == kEmpty) {
    for (int i = 0; i < f; ++i) out[i] = 0.0f;
    mask[t] = false;
    return;
  }
  long long b = t / hw;
  const float* v = values + (b * n + (long long)(k & 0xffffffffull)) * f;
  for (int i = 0; i < f; ++i) out[i] = v[i];
  mask[t] = true;
}

}  // namespace

// rows, cols: [batch, n] int32; depth: [batch, n] f32; keep: [batch, n] bool;
// values: [batch, n, f] f32; keys: [batch, h*w] u64 scratch, all bits set;
// canvas: [batch, h, w, f] f32; mask: [batch, h, w] bool.
// Returns cudaGetLastError() after the launches.
extern "C" int pmf_rasterize_zbuffer(const int32_t* rows, const int32_t* cols,
                                     const float* depth, const bool* keep,
                                     const float* values,
                                     unsigned long long* keys, float* canvas,
                                     bool* mask, int batch, int n, int h,
                                     int w, int f, float depth_quant,
                                     void* stream) {
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  long long points = (long long)batch * n;
  if (points > 0) {
    unsigned int blocks = (unsigned int)((points + threads - 1) / threads);
    winners_kernel<<<blocks, threads, 0, s>>>(rows, cols, depth, keep, keys,
                                              points, n, h, w, depth_quant);
    int err = (int)cudaGetLastError();
    if (err) return err;
  }
  long long pixels = (long long)batch * h * w;
  if (pixels > 0) {
    unsigned int blocks = (unsigned int)((pixels + threads - 1) / threads);
    fill_kernel<<<blocks, threads, 0, s>>>(keys, values, canvas, mask, pixels,
                                           n, h * w, f);
  }
  return (int)cudaGetLastError();
}
