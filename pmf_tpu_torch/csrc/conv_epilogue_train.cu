// The epilogue of a train-mode conv: batch-statistics BN, its activation and
// a residual, forward and backward, over the conv's NHWC bf16 output y, in
// two passes over the map each way.
//
// Two families, as the nets call them:
//   act_bn (SalsaNext's blocks, the fusion blocks' fuse_conv, the RGB decoder):
//     t = act(y + bias), out = BN(t) [+ residual]
//   bn_act (ResNet's conv_bn, the fusion attention):
//     t = y + bias,      out = post(act(BN(t)) [+ residual])
// BN(t) = t * a + b with the batch's statistics of t: mean = E[t], the biased
// var = E[t^2] - E[t]^2, a = gamma / sqrt(var + eps), b = beta - mean * a, all
// in float32; the running statistics move by the momentum towards (mean, var)
// where pointers to them are given (not while a stage is recomputed).
//
// Forward: (1) one read of y gives per-block partial sums of t and t^2, and a
// small kernel sums the partials in a fixed order (no float atomics: a run
// repeats bit for bit) into [mean, rstd, a, b] and the running statistics;
// (2) one read of y (and the residual) writes out, rounded once to bf16.
// Backward, with g the gradient of out and xh = (t - mean) * rstd:
// (1) one read of g and y (and out, for a closing relu's mask) gives the
// per-channel sums of gz (the gradient of BN's output) and gz * xh, and for
// the bias gradient those of s (act's derivative at y + bias in act_bn, 1 in
// bn_act), gz * s and xh * s; a small kernel turns them into d gamma, d beta,
// d bias and the two coefficients of
//     dt = a * gz - a * sum(gz) / n - a * xh * sum(gz * xh) / n;
// (2) one read of g and y writes dy = s * dt, rounded once. The bias gradient
// is sum(s * dt), from the sums of pass (1). A closing relu's masked gradient
// (the residual's gradient) is written in pass (1) and read by (2) as g.
//
// Replaces no TPU kernel: XLA fuses BN and its neighbours into the convs. On
// the card PyTorch ran train-mode BN as a chain of about 25 elementwise and
// reduction passes, forward and backward, with a float32 copy of every BN's
// input kept for the backward: half of a PMF train step's device time.
// Bound on an H100: bytes, about 16 of them an element (20 with a residual).
//
// Layout as ops/epilogue.py's inference kernel (conv_epilogue.cu): a thread
// keeps 8 channels of C (C a multiple of 8) for the whole launch, with a
// 16-byte load a pixel, rows * (C / 8) threads a block. g may have a pixel
// stride larger than C (the gradient of a slice of a channel concatenation).
// Every float operation is an explicit _rn intrinsic, so none is contracted;
// ops/epilogue_train.py holds the same computation in plain PyTorch.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

enum Family { kActBn = 0, kBnAct = 1 };
enum Act { kNone = 0, kRelu = 1, kLeakyRelu = 2, kSigmoid = 3 };

constexpr int kVec = 8;         // channels a thread: one 16-byte load of bf16
constexpr int kThreads = 256;   // a block's threads at most: rows * (C / kVec)
constexpr int kMinPixels = 16;  // pixels a thread at least in a pass that sums
constexpr int kFinishCh = 32;      // the finishing kernels: channels a block
constexpr int kFinishSlices = 32;  // and slices of the partials' rows

struct alignas(2 * kVec) Pack {  // kVec bf16 that load and store as one
  __nv_bfloat16 h[kVec];
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

template <int ACT>
__device__ __forceinline__ float activate(float x) {
  if constexpr (ACT == kRelu) return fmaxf(x, 0.f);
  if constexpr (ACT == kLeakyRelu) return fmaxf(x, __fmul_rn(x, 0.01f));
  if constexpr (ACT == kSigmoid) return sigmoid(x);
  return x;
}

// LeakyReLU's derivative as torch.maximum(x, 0.01x) gives it: a tie at 0
// splits the gradient in halves.
__device__ __forceinline__ float leaky_slope(float x) {
  return x > 0.f ? 1.f : x < 0.f ? 0.01f : 0.505f;
}

// BN's input t of one element, and in act_bn the slope of act there.
template <int FAM, int ACT>
__device__ __forceinline__ float bn_input(float y, float bias, float& s) {
  const float t0 = __fadd_rn(y, bias);
  if constexpr (FAM == kActBn) {
    s = leaky_slope(t0);
    return activate<ACT>(t0);
  }
  s = 1.f;
  return t0;
}

// gz: the gradient of BN's output from that of act's output (bn_act).
template <int FAM, int ACT>
__device__ __forceinline__ float bn_output_grad(float gv, float t, float a, float b) {
  if constexpr (FAM == kBnAct && ACT == kRelu)
    return __fadd_rn(__fmul_rn(t, a), b) > 0.f ? gv : 0.f;
  if constexpr (FAM == kBnAct && ACT == kSigmoid) {
    const float u = sigmoid(__fadd_rn(__fmul_rn(t, a), b));
    return __fmul_rn(gv, __fmul_rn(u, __fsub_rn(1.f, u)));
  }
  return gv;
}

// Per-thread channel constants: kVec of a [c] vector at c0 (0 where v is null).
__device__ __forceinline__ void load_vec(float* dst, const float* v, int c0) {
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = v ? v[c0 + i] : 0.f;
}

// The block's per-thread sums [K][kVec] to one row of partials [K][c]: through
// shared memory as [rows][K][c], each column summed over the rows in order.
template <int K>
__device__ __forceinline__ void block_partials(const float (&acc)[K][kVec], float* sh,
                                               float* partials, int c, int rows) {
  const int groups = c / kVec;
  const int r = threadIdx.x / groups, c0 = (threadIdx.x % groups) * kVec;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) sh[(r * K + k) * c + c0 + i] = acc[k][i];
  __syncthreads();
  for (int j = threadIdx.x; j < K * c; j += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < rows; ++q) s = __fadd_rn(s, sh[q * K * c + j]);
    partials[(long long)blockIdx.x * K * c + j] = s;
  }
}

// ---- forward ---------------------------------------------------------------

template <int FAM, int ACT>
__global__ void __launch_bounds__(kThreads, 4) stats_kernel(
    const __nv_bfloat16* __restrict__ y, const float* __restrict__ bias, long long m, int c,
    int rows, float* __restrict__ partials) {
  __shared__ float sh[kThreads * 2 * kVec];
  const int groups = c / kVec;
  const int c0 = (threadIdx.x % groups) * kVec;
  float pb[kVec], acc[2][kVec];
  load_vec(pb, bias, c0);
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[0][i] = acc[1][i] = 0.f;
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / groups; p < m; p += 2 * step) {
    const long long q = p + step;
    const bool two = q < m;
    Pack v[2];
    v[0] = *reinterpret_cast<const Pack*>(y + p * c + c0);
    if (two) v[1] = *reinterpret_cast<const Pack*>(y + q * c + c0);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float s;
        const float t = bn_input<FAM, ACT>(bf(v[u].h[i]), pb[i], s);
        acc[0][i] = __fadd_rn(acc[0][i], t);
        acc[1][i] = __fmaf_rn(t, t, acc[1][i]);
      }
    }
  }
  block_partials<2>(acc, sh, partials, c, rows);
}

// [mean, rstd, a, b] of each channel from the partials [parts][2][c]; the
// running statistics where given.
__global__ void finish_stats_kernel(const float* __restrict__ partials, int parts, int c, float n,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, float eps, float keep,
                                    float momentum, float* running_mean, float* running_var,
                                    float* __restrict__ stats) {
  __shared__ float sh[2][kFinishSlices][kFinishCh];
  const int tx = threadIdx.x, ty = threadIdx.y, ch = blockIdx.x * kFinishCh + tx;
  float s1 = 0.f, s2 = 0.f;
  if (ch < c)
    for (int p = ty; p < parts; p += kFinishSlices) {
      s1 = __fadd_rn(s1, partials[(long long)p * 2 * c + ch]);
      s2 = __fadd_rn(s2, partials[(long long)p * 2 * c + c + ch]);
    }
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty || ch >= c) return;
  s1 = s2 = 0.f;
  for (int k = 0; k < kFinishSlices; ++k) {
    s1 = __fadd_rn(s1, sh[0][k][tx]);
    s2 = __fadd_rn(s2, sh[1][k][tx]);
  }
  const float mean = __fdiv_rn(s1, n);
  const float var = __fsub_rn(__fdiv_rn(s2, n), __fmul_rn(mean, mean));
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  const float a = __fmul_rn(gamma[ch], rstd);
  stats[ch] = mean;
  stats[c + ch] = rstd;
  stats[2 * c + ch] = a;
  stats[3 * c + ch] = __fsub_rn(beta[ch], __fmul_rn(mean, a));
  if (running_mean) {
    running_mean[ch] = __fadd_rn(__fmul_rn(keep, running_mean[ch]), __fmul_rn(momentum, mean));
    running_var[ch] = __fadd_rn(__fmul_rn(keep, running_var[ch]), __fmul_rn(momentum, var));
  }
}

template <int FAM, int ACT, bool RES, bool POST>
__device__ __forceinline__ __nv_bfloat16 forward_element(float y, float r, float bias, float a,
                                                         float b) {
  float s;
  float z = __fadd_rn(__fmul_rn(bn_input<FAM, ACT>(y, bias, s), a), b);
  if constexpr (FAM == kBnAct) z = activate<ACT>(z);
  if constexpr (RES) z = __fadd_rn(z, r);
  if constexpr (POST) z = fmaxf(z, 0.f);
  return __float2bfloat16_rn(z);
}

template <int FAM, int ACT, bool RES, bool POST>
__global__ void __launch_bounds__(kThreads, 4) apply_kernel(
    const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ residual,
    const float* __restrict__ bias, const float* __restrict__ stats,
    __nv_bfloat16* __restrict__ out, long long m, int c, int rows) {
  const int groups = c / kVec;
  const int c0 = (threadIdx.x % groups) * kVec;
  float pb[kVec], pa[kVec], pc[kVec];
  load_vec(pb, bias, c0);
  load_vec(pa, stats + 2 * c, c0);
  load_vec(pc, stats + 3 * c, c0);
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / groups; p < m; p += 2 * step) {
    const long long q = p + step;
    const bool two = q < m;
    Pack v[2], r[2];
    v[0] = *reinterpret_cast<const Pack*>(y + p * c + c0);
    if (two) v[1] = *reinterpret_cast<const Pack*>(y + q * c + c0);
    if constexpr (RES) {
      r[0] = *reinterpret_cast<const Pack*>(residual + p * c + c0);
      if (two) r[1] = *reinterpret_cast<const Pack*>(residual + q * c + c0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      Pack o;
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        o.h[i] = forward_element<FAM, ACT, RES, POST>(bf(v[u].h[i]), RES ? bf(r[u].h[i]) : 0.f,
                                                      pb[i], pa[i], pc[i]);
      *reinterpret_cast<Pack*>(out + (u ? q : p) * c + c0) = o;
    }
  }
}

// ---- backward --------------------------------------------------------------

// Pass (1): the sums [K][c] a block, K = 5 in act_bn (gz, gz*xh, s, gz*s,
// xh*s), 3 in bn_act (gz, gz*xh, xh); with POST the masked gradient to gres.
template <int FAM, int ACT, bool POST>
__global__ void __launch_bounds__(kThreads, 2) grad_sums_kernel(
    const __nv_bfloat16* __restrict__ g, long long ldg, const __nv_bfloat16* __restrict__ y,
    const __nv_bfloat16* __restrict__ out, const float* __restrict__ bias,
    const float* __restrict__ stats, __nv_bfloat16* __restrict__ gres, long long m, int c,
    int rows, float* __restrict__ partials) {
  constexpr int K = FAM == kActBn ? 5 : 3;
  __shared__ float sh[kThreads * K * kVec];
  const int groups = c / kVec;
  const int c0 = (threadIdx.x % groups) * kVec;
  float pb[kVec], pm[kVec], pr[kVec], pa[kVec], pc[kVec], acc[K][kVec];
  load_vec(pb, bias, c0);
  load_vec(pm, stats, c0);
  load_vec(pr, stats + c, c0);
  load_vec(pa, stats + 2 * c, c0);
  load_vec(pc, stats + 3 * c, c0);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[k][i] = 0.f;
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / groups; p < m; p += 2 * step) {
    const long long q = p + step;
    const bool two = q < m;
    Pack gv[2], v[2], o[2];
    gv[0] = *reinterpret_cast<const Pack*>(g + p * ldg + c0);
    v[0] = *reinterpret_cast<const Pack*>(y + p * c + c0);
    if (two) {
      gv[1] = *reinterpret_cast<const Pack*>(g + q * ldg + c0);
      v[1] = *reinterpret_cast<const Pack*>(y + q * c + c0);
    }
    if constexpr (POST) {
      o[0] = *reinterpret_cast<const Pack*>(out + p * c + c0);
      if (two) o[1] = *reinterpret_cast<const Pack*>(out + q * c + c0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      if constexpr (POST) {
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          if (!(bf(o[u].h[i]) > 0.f)) gv[u].h[i] = __float2bfloat16_rn(0.f);
        *reinterpret_cast<Pack*>(gres + (u ? q : p) * c + c0) = gv[u];
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float s;
        const float t = bn_input<FAM, ACT>(bf(v[u].h[i]), pb[i], s);
        const float gz = bn_output_grad<FAM, ACT>(bf(gv[u].h[i]), t, pa[i], pc[i]);
        const float xh = __fmul_rn(__fsub_rn(t, pm[i]), pr[i]);
        acc[0][i] = __fadd_rn(acc[0][i], gz);
        acc[1][i] = __fmaf_rn(gz, xh, acc[1][i]);
        if constexpr (FAM == kActBn) {
          acc[2][i] = __fadd_rn(acc[2][i], s);
          acc[3][i] = __fmaf_rn(gz, s, acc[3][i]);
          acc[K - 1][i] = __fmaf_rn(xh, s, acc[K - 1][i]);
        } else {
          acc[2][i] = __fadd_rn(acc[2][i], xh);
        }
      }
    }
  }
  block_partials<K>(acc, sh, partials, c, rows);
}

// From the partials [parts][K][c]: grads [5][c] = d gamma, d beta, d bias (unused
// without a bias), and the coefficients k2 = -a sum(gz) / n, k3 = -a
// sum(gz xh) / n of pass (2).
template <int K>
__global__ void finish_grad_kernel(const float* __restrict__ partials, int parts, int c,
                                   float n, const float* __restrict__ stats,
                                   float* __restrict__ grads) {
  __shared__ float sh[K][kFinishSlices][kFinishCh];
  const int tx = threadIdx.x, ty = threadIdx.y, ch = blockIdx.x * kFinishCh + tx;
  float s[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s[k] = 0.f;
  if (ch < c)
    for (int p = ty; p < parts; p += kFinishSlices)
#pragma unroll
      for (int k = 0; k < K; ++k)
        s[k] = __fadd_rn(s[k], partials[((long long)p * K + k) * c + ch]);
#pragma unroll
  for (int k = 0; k < K; ++k) sh[k][ty][tx] = s[k];
  __syncthreads();
  if (ty || ch >= c) return;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s[k] = 0.f;
    for (int j = 0; j < kFinishSlices; ++j) s[k] = __fadd_rn(s[k], sh[k][j][tx]);
  }
  // bn_act: s = 1, so sum(s) = n, sum(gz s) = sum(gz), sum(xh s) = sum(xh)
  const float sum_s = K == 5 ? s[2] : n, sum_gs = s[K == 5 ? 3 : 0], sum_xs = s[K - 1];
  const float a = stats[2 * c + ch];
  const float k2 = -__fdiv_rn(__fmul_rn(a, s[0]), n);
  const float k3 = -__fdiv_rn(__fmul_rn(a, s[1]), n);
  grads[ch] = s[1];
  grads[c + ch] = s[0];
  grads[2 * c + ch] =
      __fadd_rn(__fadd_rn(__fmul_rn(a, sum_gs), __fmul_rn(k2, sum_s)), __fmul_rn(k3, sum_xs));
  grads[3 * c + ch] = k2;
  grads[4 * c + ch] = k3;
}

// Pass (2): dy = s * (a gz + k2 + k3 xh), rounded once.
template <int FAM, int ACT>
__global__ void __launch_bounds__(kThreads, 2) grad_apply_kernel(
    const __nv_bfloat16* __restrict__ g, long long ldg, const __nv_bfloat16* __restrict__ y,
    const float* __restrict__ bias, const float* __restrict__ stats,
    const float* __restrict__ grads, __nv_bfloat16* __restrict__ dy, long long m, int c,
    int rows) {
  const int groups = c / kVec;
  const int c0 = (threadIdx.x % groups) * kVec;
  float pb[kVec], pm[kVec], pr[kVec], pa[kVec], pc[kVec], k2[kVec], k3[kVec];
  load_vec(pb, bias, c0);
  load_vec(pm, stats, c0);
  load_vec(pr, stats + c, c0);
  load_vec(pa, stats + 2 * c, c0);
  load_vec(pc, stats + 3 * c, c0);
  load_vec(k2, grads + 3 * c, c0);
  load_vec(k3, grads + 4 * c, c0);
  const long long step = (long long)gridDim.x * rows;
  for (long long p = (long long)blockIdx.x * rows + threadIdx.x / groups; p < m; p += 2 * step) {
    const long long q = p + step;
    const bool two = q < m;
    Pack gv[2], v[2];
    gv[0] = *reinterpret_cast<const Pack*>(g + p * ldg + c0);
    v[0] = *reinterpret_cast<const Pack*>(y + p * c + c0);
    if (two) {
      gv[1] = *reinterpret_cast<const Pack*>(g + q * ldg + c0);
      v[1] = *reinterpret_cast<const Pack*>(y + q * c + c0);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (u == 1 && !two) break;
      Pack d;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        float s;
        const float t = bn_input<FAM, ACT>(bf(v[u].h[i]), pb[i], s);
        const float gz = bn_output_grad<FAM, ACT>(bf(gv[u].h[i]), t, pa[i], pc[i]);
        const float xh = __fmul_rn(__fsub_rn(t, pm[i]), pr[i]);
        const float dt = __fadd_rn(__fadd_rn(__fmul_rn(pa[i], gz), k2[i]), __fmul_rn(k3[i], xh));
        d.h[i] = __float2bfloat16_rn(FAM == kActBn ? __fmul_rn(dt, s) : dt);
      }
      *reinterpret_cast<Pack*>(dy + (u ? q : p) * c + c0) = d;
    }
  }
}

// ---- launch ----------------------------------------------------------------

struct Shape {
  long long m;
  int c, sms;
  cudaStream_t stream;
  int groups() const { return c / kVec; }
  int rows() const { return kThreads / groups(); }
  int threads() const { return rows() * groups(); }
  // a streaming pass: whole pixels a block, at most `per_sm` blocks an SM
  int blocks(int per_sm) const {
    const long long tiles = (m + rows() - 1) / rows();
    const long long most = (long long)sms * per_sm;
    return (int)(tiles < most ? tiles : most);
  }
  // a pass that sums: each thread kMinPixels or more
  int sum_blocks(int per_sm) const {
    const long long tiles = (m + (long long)rows() * kMinPixels - 1) / (rows() * kMinPixels);
    const long long most = (long long)sms * per_sm;
    return (int)(tiles < 1 ? 1 : tiles < most ? tiles : most);
  }
  dim3 finish_grid() const { return dim3((c + kFinishCh - 1) / kFinishCh); }
};

const dim3 kFinishBlock(kFinishCh, kFinishSlices);

template <int FAM, int ACT>
void launch_stats(const Shape& s, const void* y, const void* bias, float* ws, const float* gamma,
                  const float* beta, float eps, float keep, float momentum, float* rm, float* rv,
                  float* stats) {
  const int parts = s.sum_blocks(4);
  stats_kernel<FAM, ACT><<<parts, s.threads(), 0, s.stream>>>(
      (const __nv_bfloat16*)y, (const float*)bias, s.m, s.c, s.rows(), ws);
  finish_stats_kernel<<<s.finish_grid(), kFinishBlock, 0, s.stream>>>(
      ws, parts, s.c, (float)s.m, gamma, beta, eps, keep, momentum, rm, rv, stats);
}

template <int FAM, int ACT, bool RES, bool POST>
void launch_apply(const Shape& s, const void* y, const void* res, const void* bias,
                  const float* stats, void* out) {
  apply_kernel<FAM, ACT, RES, POST><<<s.blocks(4), s.threads(), 0, s.stream>>>(
      (const __nv_bfloat16*)y, (const __nv_bfloat16*)res, (const float*)bias, stats,
      (__nv_bfloat16*)out, s.m, s.c, s.rows());
}

template <int FAM, int ACT, bool POST>
void launch_grad_sums(const Shape& s, const void* g, long long ldg, const void* y,
                      const void* out, const void* bias, const float* stats, void* gres,
                      float* ws, float* grads) {
  constexpr int K = FAM == kActBn ? 5 : 3;
  const int parts = s.sum_blocks(2);
  grad_sums_kernel<FAM, ACT, POST><<<parts, s.threads(), 0, s.stream>>>(
      (const __nv_bfloat16*)g, ldg, (const __nv_bfloat16*)y, (const __nv_bfloat16*)out,
      (const float*)bias, stats, (__nv_bfloat16*)gres, s.m, s.c, s.rows(), ws);
  finish_grad_kernel<K><<<s.finish_grid(), kFinishBlock, 0, s.stream>>>(ws, parts, s.c,
                                                                         (float)s.m, stats, grads);
}

template <int FAM, int ACT>
void launch_grad_apply(const Shape& s, const void* g, long long ldg, const void* y,
                       const void* bias, const float* stats, const float* grads, void* dy) {
  grad_apply_kernel<FAM, ACT><<<s.blocks(2), s.threads(), 0, s.stream>>>(
      (const __nv_bfloat16*)g, ldg, (const __nv_bfloat16*)y, (const float*)bias, stats, grads,
      (__nv_bfloat16*)dy, s.m, s.c, s.rows());
}

// The variants the nets call (ops/epilogue_train.py: VARIANTS): act_bn with
// LeakyReLU, with or without a residual; bn_act with relu, sigmoid or none,
// and none with a residual and a closing relu.
bool known(int family, int act, bool res, bool post) {
  if (family == kActBn) return act == kLeakyRelu && !post;
  if (family != kBnAct) return false;
  if (res || post) return act == kNone && res && post;
  return act == kNone || act == kRelu || act == kSigmoid;
}

bool aligned(const void* p, int bytes) { return ((uintptr_t)p & (bytes - 1)) == 0; }

bool bad_shape(long long m, int c, int sms) {
  return m <= 0 || c <= 0 || c % kVec || c / kVec > kThreads || sms <= 0;
}

}  // namespace

// Forward pass (1): stats [4][c] f32 (mean, rstd, a, b) of t over y [m][c]
// bf16 (NHWC), bias [c] f32 or null, gamma and beta [c] f32; the running
// statistics [c] f32 move where both are given. ws: at least
// 10 * sms * c floats. Returns a cudaError_t (0: launched).
extern "C" int pmf_bn_train_stats(const void* y, const void* bias, const void* gamma,
                                  const void* beta, void* running_mean, void* running_var,
                                  void* ws, void* stats, long long m, int c, int family,
                                  float eps, float momentum, int sms, int device, void* stream) {
  if (bad_shape(m, c, sms) || !gamma || !beta || !ws || !stats || !running_mean != !running_var ||
      (family != kActBn && family != kBnAct) || !aligned(y, 16))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  const Shape s{m, c, sms, (cudaStream_t)stream};
  const float keep = (float)(1.0 - (double)momentum);
  auto run = family == kActBn ? launch_stats<kActBn, kLeakyRelu> : launch_stats<kBnAct, kNone>;
  run(s, y, bias, (float*)ws, (const float*)gamma, (const float*)beta, eps, keep, momentum,
      (float*)running_mean, (float*)running_var, (float*)stats);
  return (int)cudaGetLastError();
}

// Forward pass (2): out [m][c] bf16 from y, the residual [m][c] bf16 or null,
// bias and stats (of pmf_bn_train_stats); act 0 none, 1 relu, 2 LeakyReLU,
// 3 sigmoid; post 1 for a closing relu.
extern "C" int pmf_bn_train_apply(const void* y, const void* residual, const void* bias,
                                  const void* stats, void* out, long long m, int c, int family,
                                  int act, int post, int sms, int device, void* stream) {
  const bool res = residual;
  if (bad_shape(m, c, sms) || !stats || !out || !known(family, act, res, post) ||
      !aligned(y, 16) || !aligned(residual, 16) || !aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  const Shape s{m, c, sms, (cudaStream_t)stream};
  const float* st = (const float*)stats;
  if (family == kActBn)
    res ? launch_apply<kActBn, kLeakyRelu, true, false>(s, y, residual, bias, st, out)
        : launch_apply<kActBn, kLeakyRelu, false, false>(s, y, residual, bias, st, out);
  else if (post)
    launch_apply<kBnAct, kNone, true, true>(s, y, residual, bias, st, out);
  else if (act == kRelu)
    launch_apply<kBnAct, kRelu, false, false>(s, y, residual, bias, st, out);
  else if (act == kSigmoid)
    launch_apply<kBnAct, kSigmoid, false, false>(s, y, residual, bias, st, out);
  else
    launch_apply<kBnAct, kNone, false, false>(s, y, residual, bias, st, out);
  return (int)cudaGetLastError();
}

// Backward pass (1): from g [m] rows of c bf16 at a pixel stride ldg (>= c, a
// multiple of 8), y, out (with post) and stats: grads [5][c] f32 (d gamma,
// d beta, d bias, k2, k3); with post, gres [m][c] bf16 = g where out > 0,
// else 0 (the residual's gradient). ws: at least 10 * sms * c floats.
extern "C" int pmf_bn_train_grad_sums(const void* g, long long ldg, const void* y,
                                      const void* out, const void* bias, const void* stats,
                                      void* gres, void* ws, void* grads, long long m, int c,
                                      int family, int act, int post, int sms, int device,
                                      void* stream) {
  if (bad_shape(m, c, sms) || !stats || !ws || !grads || ldg < c || ldg % kVec ||
      !known(family, act, post, post) ||
      (post && (!out || !gres)) || !aligned(g, 16) || !aligned(y, 16) || !aligned(out, 16) ||
      !aligned(gres, 16))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  const Shape s{m, c, sms, (cudaStream_t)stream};
  const float* st = (const float*)stats;
  float *w = (float*)ws, *gr = (float*)grads;
  if (family == kActBn)
    launch_grad_sums<kActBn, kLeakyRelu, false>(s, g, ldg, y, out, bias, st, gres, w, gr);
  else if (post)
    launch_grad_sums<kBnAct, kNone, true>(s, g, ldg, y, out, bias, st, gres, w, gr);
  else if (act == kRelu)
    launch_grad_sums<kBnAct, kRelu, false>(s, g, ldg, y, out, bias, st, gres, w, gr);
  else if (act == kSigmoid)
    launch_grad_sums<kBnAct, kSigmoid, false>(s, g, ldg, y, out, bias, st, gres, w, gr);
  else
    launch_grad_sums<kBnAct, kNone, false>(s, g, ldg, y, out, bias, st, gres, w, gr);
  return (int)cudaGetLastError();
}

// Backward pass (2): dy [m][c] bf16 from g (at pixel stride ldg; with a
// closing relu, the gres of pass (1)), y, stats and grads (of pass (1)).
extern "C" int pmf_bn_train_grad_apply(const void* g, long long ldg, const void* y,
                                       const void* bias, const void* stats, const void* grads,
                                       void* dy, long long m, int c, int family, int act,
                                       int sms, int device, void* stream) {
  if (bad_shape(m, c, sms) || !stats || !grads || !dy || ldg < c || ldg % kVec ||
      !known(family, act, false, false) ||
      !aligned(g, 16) || !aligned(y, 16) || !aligned(dy, 16))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  const Shape s{m, c, sms, (cudaStream_t)stream};
  const float *st = (const float*)stats, *gr = (const float*)grads;
  if (family == kActBn)
    launch_grad_apply<kActBn, kLeakyRelu>(s, g, ldg, y, bias, st, gr, dy);
  else if (act == kRelu)
    launch_grad_apply<kBnAct, kRelu>(s, g, ldg, y, bias, st, gr, dy);
  else if (act == kSigmoid)
    launch_grad_apply<kBnAct, kSigmoid>(s, g, ldg, y, bias, st, gr, dy);
  else
    launch_grad_apply<kBnAct, kNone>(s, g, ldg, y, bias, st, gr, dy);
  return (int)cudaGetLastError();
}
