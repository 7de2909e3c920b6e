// ASPP's four conv branches (1x1, and 3x3 dilated d1, d2, d3) in one launch,
// for inference, written into the slices of the caller's NHWC concat buffer.
//
// Replaces no TPU kernel: the JAX package leaves these convs to XLA. Added
// because cuDNN runs the dilated 3x3 convs of EPMF's camera-decoder ASPP
// (512 channels on a 20x80 map, batch 8) on its direct kernel, 112 of the
// 174 ms of an EPMF eval call on an H100.
//
// Bound on an H100: operations. At EPMF's camera shape the taps that reach
// the map do about 106 GFLOP (0.11 ms at 989 TFLOP/s in bf16); the bytes
// (input, weights, outputs: about 80 MB) take 24 us at 3.35 TB/s.
//
// An implicit GEMM over NHWC bf16: M = output pixels (N*H*W), N = the four
// branches x C output channels, K = live taps x C input channels. A block
// takes one row of the plan (ops/aspp.py: aspp_plan): a tile of BM = 128
// flat output pixels, one branch, BN (128 or 256) output channels, and the
// mask of the branch's taps that read an in-map pixel for some pixel of the
// tile. It walks only those taps; a live tap's out-of-map reads are zero-
// filled by cp.async (src-size 0), exactly as zero padding, so a skipped tap
// would only have added products with zero. The plan lists the tiles with
// the most live taps first, so the last wave is not the 9-tap tiles alone.
//
// Per k-step (one tap, 64 input channels) all 256 threads cp.async the
// activation tile [128 px][64 ch] (the tap shift makes its rows
// non-contiguous) and the weight tile [BN][64] into one stage of a ring, in
// the 128-byte swizzle that wgmma reads; the ring runs STAGES - 2 k-steps
// ahead while one k-step's wgmma is in flight. Two warpgroups each run
// m64nBNk16 wgmma on their 64 pixel rows (bf16 in, fp32 accumulators). The
// epilogue adds the fp32 bias, rounds once to bf16 and stores the tile into
// out[..., C*(1+branch) + n0 ...] (out has 5C channels; [0, C) is the
// caller's pooled branch).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int BM = 128;       // output pixels a tile: two warpgroups of 64 rows
constexpr int BK = 64;        // input channels a k-step: one 128-byte swizzle row
constexpr int kThreads = 256;
constexpr int kRowBytes = BK * 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where !valid (src-size 0 reads nothing)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The byte offset of 16-byte chunk `chunk` of row `row` of a [rows][64] bf16
// tile in the 128-byte swizzle: chunk index XOR (row mod 8), as wgmma (and
// TMA's SWIZZLE_128B) lay it out. The tile starts 1024-byte aligned.
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  return row * kRowBytes + ((chunk ^ (row & 7)) << 4);
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// start address >> 4, leading offset 1 (unused for this swizzle), stride
// between 8-row groups 1024 bytes, layout 1 (SWIZZLE_128B).
__device__ __forceinline__ uint64_t descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the
// wgmma fences and waits.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Makes this thread's cp.async writes to shared memory visible to wgmma,
// which reads them through the async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[0..BN/2) += A (64 x 16, K-major at a) * B (BN x 16, K-major at b)^T
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128) wgmma_n128(d, a, b);
  else wgmma_n256(d, a, b);
}

// One block a plan row (tile, branch, channel tile, live-tap mask).
// x [M = N*H*W][C] bf16, w [1 + 27][C][C] bf16 (the 1x1 branch's kernel,
// then each dilated branch's 9 taps in row-major order, each [Cout][Cin]),
// bias [4][C] f32, out [M][5C] bf16.
template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
aspp_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
            const int4* __restrict__ plan, int M, int H, int W, int C, int d1, int d2,
            int d3) {
  constexpr int kABytes = BM * kRowBytes;
  constexpr int kStage = kABytes + BN * kRowBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int taps[9];
  // the swizzle's pattern repeats every 1024 bytes: align the ring to that
  uint8_t* ring = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);

  const int4 item = plan[blockIdx.x];
  const int m0 = item.x * BM, branch = item.y, n0 = item.z * BN;
  const unsigned mask = (unsigned)item.w;
  const int dil = branch == 1 ? d1 : branch == 2 ? d2 : branch == 3 ? d3 : 0;
  const int kb_per_tap = C / BK;
  const int nk = __popc(mask) * kb_per_tap;
  const int tid = threadIdx.x;
  if (tid == 0) {
    int s = 0;
    for (int t = 0; t < 9; ++t)
      if (mask >> t & 1) taps[s++] = t;
  }

  // this thread copies 16-byte chunk `chunk` of tile rows r0 + 32 j
  const int chunk = tid & 7, r0 = tid >> 3;
  const int hw = H * W;
  int py[4], px[4], pbase[4];  // the output pixel of each A row; pbase -1 past M
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + r0 + 32 * j;
    const int n = m / hw, rem = m - n * hw;
    py[j] = rem / W;
    px[j] = rem - py[j] * W;
    pbase[j] = m < M ? n * hw : -1;
  }
  __syncthreads();

  auto load = [&](int i, int slot) {
    const int s = i / kb_per_tap, kb = i - s * kb_per_tap;
    const int t = taps[s];
    const int dy = (t / 3 - 1) * dil, dx = (t % 3 - 1) * dil;
    const int widx = branch == 0 ? 0 : 1 + 9 * (branch - 1) + t;
    uint8_t* a = ring + slot * kStage;
    const uint32_t sa = smem_u32(a), sb = smem_u32(a + kABytes);
    const int c0 = kb * BK + chunk * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = py[j] + dy, xx = px[j] + dx;
      const bool ok = pbase[j] >= 0 && yy >= 0 && yy < H && xx >= 0 && xx < W;
      const __nv_bfloat16* src = ok ? x + ((size_t)(pbase[j] + yy * W + xx) * C + c0) : x;
      cp_async16(sa + swizzled(r0 + 32 * j, chunk), src, ok);
    }
    const __nv_bfloat16* wt = w + ((size_t)widx * C + n0) * C + c0;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j)
      cp_async16(sb + swizzled(r0 + 32 * j, chunk), wt + (size_t)(r0 + 32 * j) * C, true);
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int i = 0; i < STAGES - 2; ++i) {
    if (i < nk) load(i, i);
    cp_async_commit();
  }
  const int wg = tid >> 7;
  for (int i = 0; i < nk; ++i) {
    // k-step i has landed (this thread's copies, then everyone's); every
    // warpgroup's wgmma of k-step i - 2 is done (waited last iteration),
    // so its stage takes the copies of k-step i + STAGES - 2
    cp_async_wait<STAGES - 3>();
    fence_async_shared();
    __syncthreads();
    const int next = i + STAGES - 2;
    if (next < nk) load(next, next % STAGES);
    cp_async_commit();

    const uint32_t a = smem_u32(ring + (i % STAGES) * kStage) + wg * 64 * kRowBytes;
    const uint32_t b = smem_u32(ring + (i % STAGES) * kStage + kABytes);
    wgmma_fence();
    fence_operands(acc);
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)  // 16 channels = 32 bytes along the swizzled row
      wgmma_tile<BN>(acc, descriptor(a + 32 * k), descriptor(b + 32 * k));
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator i of thread (warp, lane): row warp*16 + lane/4 + 8*(i/2 % 2),
  // column 8*(i/4) + 2*(lane % 4) + i % 2
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const int row = m0 + wg * 64 + warp * 16 + (lane >> 2);
  const int stride = 5 * C;
  const float* bb = bias + branch * C + n0;
  __nv_bfloat16* o = out + C * (1 + branch) + n0;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (lane & 3) * 2;
    const float b0 = bb[col], b1 = bb[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < M)
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)r * stride + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
}

template <int BN, int STAGES>
int launch(const void* x, const void* w, const void* bias, void* out, const void* plan,
           int items, int m, int h, int wd, int c, int d1, int d2, int d3,
           cudaStream_t stream) {
  constexpr int smem = STAGES * (BM + BN) * kRowBytes + 1024;  // + the ring's alignment
  auto kernel = aspp_kernel<BN, STAGES>;
  int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      smem);
  if (err) return err;
  kernel<<<items, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)bias,
      (__nv_bfloat16*)out, (const int4*)plan, m, h, wd, c, d1, d2, d3);
  return (int)cudaGetLastError();
}

}  // namespace

// x [m = N*H*W][c] bf16 (NHWC), w [28][c][c] bf16, bias [4][c] f32, out
// [m][5c] bf16, plan [items][4] int32; bn (128 or 256) the plan's channel
// tile. Launches on `stream`; returns a cudaError_t (0: launched).
extern "C" int pmf_aspp_branches(const void* x, const void* w, const void* bias, void* out,
                                 const void* plan, int items, int m, int h, int wd, int c,
                                 int d1, int d2, int d3, int bn, int device, void* stream) {
  if (items <= 0 || m <= 0 || c <= 0 || c % bn || (bn != 128 && bn != 256) ||
      (long long)m * 5 * c >= (1ll << 31) || ((uintptr_t)x & 15) || ((uintptr_t)w & 15) ||
      ((uintptr_t)out & 3) || ((uintptr_t)plan & 15))
    return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.error) return guard.error;
  auto s = (cudaStream_t)stream;
  if (bn == 256) return launch<256, 4>(x, w, bias, out, plan, items, m, h, wd, c, d1, d2, d3, s);
  return launch<128, 5>(x, w, bias, out, plan, items, m, h, wd, c, d1, d2, d3, s);
}
