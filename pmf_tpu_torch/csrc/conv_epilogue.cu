// The epilogue of an inference conv in one pass over its NHWC bf16 output y,
// in place: y = post(act(y + bias) * a + b [+ residual]), in float32 with one
// rounding to bf16.
//
// Replaces no TPU kernel: XLA fuses these elementwise ops into the conv on
// the TPU. Added because on the card PyTorch adds each cuDNN conv's bias in a
// pass of its own (a [C, 1, 1] broadcast over a channels-last map, which
// PyTorch runs on its unvectorized elementwise kernel), then runs the
// activation (LeakyReLU as two passes), the eval BN's x*a + b (two more) and
// a residual add each as further passes: 3-6 passes, 11-14 tensor-sized reads
// and writes after a conv that writes its output once. They were more than
// half of a PMF eval call's device time.
//
// Bound on an H100: bytes. One read and one write of y, and one read of the
// residual where there is one, at 3.35 TB/s; a handful of float operations an
// element.
//
// Where C is a multiple of 8 a thread keeps 8 channels of C for the whole
// launch and walks pixels, with a 16-byte load a pixel: a block of
// rows * (C / 8) threads covers `rows` whole pixels, neighbouring threads on
// neighbouring addresses, and the grid steps over the pixels. So each thread
// loads its channels' bias, a and b once, into registers. Each loop step
// issues the loads of two pixels before it computes either. Other C (the
// logits) take the tensor as a flat run of 16-byte vectors, the per-channel
// vectors in shared memory (epilogue_flat_kernel). That path takes any C, but
// on an H100 it reached 52 % of the bound at 256 channels and 71 % at 2048
// against the register path's 72 % and 78 % (a warp reads the shared vectors
// at channels 8 apart: bank conflicts), and 69 % against 80 % on the fusion
// block's sigmoid; on 32-128 channels the two are within 5 %. The variant
// (activation, BN, residual, closing ReLU) is a template argument; every
// float operation is an explicit _rn intrinsic, so no multiply-add is
// contracted and the result is that of the same ops in PyTorch in float32
// (ops/epilogue.py: conv_epilogue_plain), rounded once.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2, kSigmoid = 3 };

constexpr int kVec = 8;              // channels a thread: one 16-byte load of bf16
constexpr int kThreads = 256;        // a block's threads at most: rows * (C / kVec)
constexpr int kThreadsPerSm = 1024;  // an SM takes 1024 / blockDim blocks: 64 registers a thread

struct alignas(2 * kVec) Pack {  // kVec bf16 that load and store as one
  __nv_bfloat16 h[kVec];
};

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == kRelu) return fmaxf(x, 0.f);
  if constexpr (ACT == kLeakyRelu) return fmaxf(x, __fmul_rn(x, 0.01f));
  if constexpr (ACT == kSigmoid) return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
  return x;
}

// One element: y, its residual r, its channel's bias, a and b.
template <int ACT, bool BN, bool RES, bool POST>
__device__ __forceinline__ __nv_bfloat16 epilogue(__nv_bfloat16 y, __nv_bfloat16 r, float bias,
                                                  float a, float b) {
  float t = activate<ACT>(__fadd_rn(__bfloat162float(y), bias));
  if constexpr (BN) t = __fadd_rn(__fmul_rn(t, a), b);
  if constexpr (RES) t = __fadd_rn(t, __bfloat162float(r));
  if constexpr (POST) t = fmaxf(t, 0.f);
  return __float2bfloat16_rn(t);
}

template <int ACT, bool BN, bool RES, bool POST>
__device__ __forceinline__ void apply(Pack& v, const Pack& r, const float* bias,
                                      const float* a, const float* b) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) v.h[i] = epilogue<ACT, BN, RES, POST>(v.h[i], r.h[i], bias[i],
                                                                        a[i], b[i]);
}

template <int ACT, bool BN, bool RES, bool POST>
__global__ void __launch_bounds__(kThreads, kThreadsPerSm / kThreads) epilogue_kernel(
    __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ residual,
    const float* __restrict__ bias, const float* __restrict__ a, const float* __restrict__ b,
    long long m, int c, int rows) {
  const int groups = c / kVec;
  const int g = threadIdx.x % groups;
  const int c0 = g * kVec;
  float pb[kVec], pa[kVec], pc[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    pb[i] = bias[c0 + i];
    if constexpr (BN) {
      pa[i] = a[c0 + i];
      pc[i] = b[c0 + i];
    }
  }
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / groups; p < m; p += 2 * step) {
    const long long q = p + step;
    const bool two = q < m;
    auto* y0 = reinterpret_cast<Pack*>(y + p * c + c0);
    auto* y1 = reinterpret_cast<Pack*>(y + q * c + c0);
    Pack v0 = *y0, v1, r0, r1;
    if (two) v1 = *y1;
    if constexpr (RES) {
      r0 = *reinterpret_cast<const Pack*>(residual + p * c + c0);
      if (two) r1 = *reinterpret_cast<const Pack*>(residual + q * c + c0);
    }
    apply<ACT, BN, RES, POST>(v0, r0, pb, pa, pc);
    *y0 = v0;
    if (two) {
      apply<ACT, BN, RES, POST>(v1, r1, pb, pa, pc);
      *y1 = v1;
    }
  }
}

// C not a multiple of 8 (the logits of 17 or 20 classes): the tensor as a flat
// run of 16-byte vectors, each element's channel counted from the vector's
// first ((8j) mod C, then stepping), the per-channel vectors in shared memory.
// Threads past the last whole vector take the tail one element each.
template <int ACT, bool BN, bool RES, bool POST>
__global__ void __launch_bounds__(kThreads, kThreadsPerSm / kThreads) epilogue_flat_kernel(
    __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ residual,
    const float* __restrict__ bias, const float* __restrict__ a, const float* __restrict__ b,
    long long n, int c) {
  extern __shared__ float params[];  // bias, a, b: [3][c]
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    params[i] = bias[i];
    if constexpr (BN) {
      params[c + i] = a[i];
      params[2 * c + i] = b[i];
    }
  }
  __syncthreads();
  const long long vectors = n / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long j = first; j < vectors; j += stride) {
    auto* yj = reinterpret_cast<Pack*>(y + kVec * j);
    Pack v = *yj, r;
    if constexpr (RES) r = *reinterpret_cast<const Pack*>(residual + kVec * j);
    int ch = (int)((kVec * j) % c);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      v.h[i] = epilogue<ACT, BN, RES, POST>(v.h[i], r.h[i], params[ch], params[c + ch],
                                            params[2 * c + ch]);
      ch = ch + 1 == c ? 0 : ch + 1;
    }
    *yj = v;
  }
  const long long e = kVec * vectors + first;
  if (e < n) {
    const int ch = (int)(e % c);
    y[e] = epilogue<ACT, BN, RES, POST>(y[e], RES ? residual[e] : y[e], params[ch],
                                        params[c + ch], params[2 * c + ch]);
  }
}

struct Args {
  void* y;
  const void* residual;
  const void* bias;
  const void* a;
  const void* b;
  long long m;
  int c, sms;
  cudaStream_t stream;
};

template <int ACT, bool BN, bool RES, bool POST>
int launch(const Args& s) {
  const int groups = s.c / kVec;
  const int rows = groups >= kThreads ? 1 : kThreads / groups;
  const int threads = rows * groups;
  const long long tiles = (s.m + rows - 1) / rows;
  const long long most = (long long)s.sms * (kThreadsPerSm / threads);
  const int blocks = (int)(tiles < most ? tiles : most);
  epilogue_kernel<ACT, BN, RES, POST><<<blocks, threads, 0, s.stream>>>(
      (__nv_bfloat16*)s.y, (const __nv_bfloat16*)s.residual, (const float*)s.bias,
      (const float*)s.a, (const float*)s.b, s.m, s.c, rows);
  return (int)cudaGetLastError();
}

template <int ACT, bool BN, bool RES, bool POST>
int launch_flat(const Args& s) {
  const long long n = s.m * s.c;
  const long long tiles = (n / kVec + kThreads - 1) / kThreads;
  const long long most = (long long)s.sms * (kThreadsPerSm / kThreads);
  const int blocks = (int)(tiles < 1 ? 1 : tiles < most ? tiles : most);
  epilogue_flat_kernel<ACT, BN, RES, POST><<<blocks, kThreads, 3 * s.c * sizeof(float),
                                             s.stream>>>(
      (__nv_bfloat16*)s.y, (const __nv_bfloat16*)s.residual, (const float*)s.bias,
      (const float*)s.a, (const float*)s.b, n, s.c);
  return (int)cudaGetLastError();
}

template <int ACT, bool BN, bool RES, bool POST>
int by_width(const Args& s) {
  return s.c % kVec == 0 ? launch<ACT, BN, RES, POST>(s) : launch_flat<ACT, BN, RES, POST>(s);
}

// The variants the nets call (ops/epilogue.py: VARIANTS), each instantiated
// for both widths; any other returns cudaErrorInvalidValue.
int variant(const Args& s, int act, bool post) {
  const bool bn = s.a, res = s.residual;
  if (!bn && !res && !post) {
    switch (act) {
      case kNone: return by_width<kNone, false, false, false>(s);  // the bias alone
      case kRelu: return by_width<kRelu, false, false, false>(s);  // conv_bn's relu
      case kLeakyRelu: return by_width<kLeakyRelu, false, false, false>(s);  // shortcuts
      default: return by_width<kSigmoid, false, false, false>(s);  // the attention
    }
  }
  if (act == kLeakyRelu && bn && !post)  // SalsaNext's blocks, fusion, the decoders' stages
    return res ? by_width<kLeakyRelu, true, true, false>(s)
               : by_width<kLeakyRelu, true, false, false>(s);
  if (act == kNone && !bn && res && post)  // relu(out + x) of BasicBlock, Bottleneck
    return by_width<kNone, false, true, true>(s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [m][c] bf16 (NHWC, in place), residual [m][c] bf16 or null, bias [c] f32,
// a and b [c] f32 (the eval BN after the activation) or both null; act 0 none,
// 1 relu, 2 LeakyReLU(0.01), 3 sigmoid; post 1 for a closing relu (one of the
// seven variants `variant` takes); sms the card's multiprocessors. Launches on
// `stream`; returns a cudaError_t (0: launched).
extern "C" int pmf_conv_epilogue(void* y, const void* residual, const void* bias, const void* a,
                                 const void* b, long long m, int c, int act, int post, int sms,
                                 int device, void* stream) {
  if (m <= 0 || c <= 0 || (c % kVec == 0 ? c / kVec : c) > kThreads || sms <= 0 || act < kNone ||
      act > kSigmoid || !bias || !a != !b || ((uintptr_t)y & 15) || ((uintptr_t)residual & 15) ||
      ((uintptr_t)bias & 3) || ((uintptr_t)a & 3) || ((uintptr_t)b & 3))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  return variant({y, residual, bias, a, b, m, c, sms, (cudaStream_t)stream}, act, post);
}
