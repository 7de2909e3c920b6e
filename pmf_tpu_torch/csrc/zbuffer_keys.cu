// K1: scatter-min of packed int32 z-buffer keys into a per-scan key image.
//
// Replaces the Pallas TPU kernel pmf_tpu/ops/pallas/zbuffer.py:zbuffer_pallas
// (_kernel), which streams the points through scalar memory one at a time and
// read-modify-writes one 128-lane row of the key image per point.
//
// Here every point is one thread doing one int32 atomicMin into global
// memory. The key packs (quantized depth << nbits) | point index, so the
// minimum is the nearest point with the lowest index on ties, whatever order
// the atomics land in: the result is deterministic. The key width is the
// caller's (ops/scatter.py: packed_keys); this kernel only takes the minimum.
//
// Bound on an H100 (3.35 TB/s): bytes. Per scan of the eval path (N = 32768,
// 384x1232) it reads 8 B per point and writes the 1.9 MB key image, about
// 0.7 us. The device work (the INT32_MAX init and the atomics, both in L2)
// takes a few microseconds; a call is held by the host's work to issue it,
// and each launch costs the host about as much as the whole device work.
// So one C entry makes one launch on the caller's stream: a cooperative
// kernel of one block per SM writes INT32_MAX with 16-byte stores, waits at
// a grid-wide barrier, then does the atomics, scan after scan, with 32-bit
// index math. The wrapper allocates the image with torch.empty and launches
// nothing else.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kEmpty = 0x7fffffff;

// out[0, 4 * vecs + tail) = INT32_MAX, then, for each scan b, the min of
// key[b, i] at out[b, pix[b, i]] for every pix in [0, hw). out is 16-byte
// aligned; the launch is cooperative, so every block reaches the barrier.
__global__ void zbuffer_keys_kernel(const int32_t* __restrict__ pix,
                                    const int32_t* __restrict__ key,
                                    int32_t* __restrict__ out, int batch,
                                    int n, int hw, unsigned vecs,
                                    unsigned tail) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned t0 = blockIdx.x * kThreads + threadIdx.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (unsigned t = t0; t < vecs; t += stride)
    out4[t] = make_int4(kEmpty, kEmpty, kEmpty, kEmpty);
  if (t0 < tail) out[4 * vecs + t0] = kEmpty;
  cooperative_groups::this_grid().sync();
  for (int b = 0; b < batch; ++b) {
    const int32_t* pb = pix + (size_t)b * n;
    const int32_t* kb = key + (size_t)b * n;
    int32_t* ob = out + (size_t)b * hw;
    for (unsigned t = t0; t < (unsigned)n; t += stride) {
      const int p = pb[t];
      if ((unsigned)p < (unsigned)hw) atomicMin(ob + p, kb[t]);  // drops H*W
    }
  }
}

}  // namespace

// pix, key: [batch, n] int32; out: [batch, hw] int32, 16-byte aligned, every
// element written here, all on CUDA device `device`. Needs batch * hw < 2^31.
// Returns a cudaError_t: cudaErrorInvalidValue for what it does not take,
// else the launch's error.
extern "C" int pmf_zbuffer_keys(const int32_t* pix, const int32_t* key,
                                int32_t* out, int batch, int n, int hw,
                                int device, void* stream) {
  const long long total = (long long)batch * hw;
  if (batch < 0 || n < 0 || hw < 0 || total >= (1ll << 31) ||
      ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  int sms;
  int err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err) return err;
  unsigned vecs = (unsigned)(total / 4), tail = (unsigned)(total % 4);
  void* args[] = {&pix, &key, &out, &batch, &n, &hw, &vecs, &tail};
  return (int)cudaLaunchCooperativeKernel((const void*)zbuffer_keys_kernel, sms,
                                          kThreads, args, 0, (cudaStream_t)stream);
}
