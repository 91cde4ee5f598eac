// Multilevel RoIAlign for the Faster R-CNN head: torchvision roi_align with
// sampling_ratio = 0 and aligned = True, 7 x 7 bins, every roi pooled from
// its own FPN level (P2..P5), float32 sums.
//
// Replaces the Pallas TPU kernel videotofaces_tpu/ops/pallas_roialign.py::
// roi_align_patches (driven by ops/roi_align.py::roi_align_multilevel_pallas):
// there, all levels are row-stacked into one buffer, each roi's patch is
// DMA'd into VMEM at an 8-column aligned origin, the roi scalars travel as
// 16.16 fixed point, and the pooled 7x7xC falls out of one [56, py*px] x
// [py*px, C] MXU product after two {0,1} spread products; rois are size-
// bucketed and a big bucket is capped. All of that serves the MXU and VMEM.
// This kernel computes the function of the dense method
// (ops/roi_align.py::_roi_align_dense) directly: no window, no bucket, no
// fixed point, so no roi is dropped or truncated.
//
// What it computes, for roi n = (image b, slot r) on level l (given, computed
// on the host side by assign_fpn_levels), per axis with c1 = x1 / stride -
// 0.5, c2 = x2 / stride - 0.5 on a level of extent S:
//   span = c2 - c1, bin = span * f32(1/7), k = ceil(max(span, 0) * f32(1/7)),
//   step = bin / max(k, 1) (an IEEE division), and for bin i, sample j < min(k, 8):
//   y = fma(i, bin, c1) + (j + 0.5) * step (rounded so; XLA compiles the JAX
//   package's expression into that form, and with it the sample taps equal
//   the jitted JAX weights). A sample outside [-1, S] contributes zero; one
//   in the last row (or beyond) clamps to it with weight 1. Then
//   out[n][i][j][c] = sum over the bin's samples (y, x) of the bilinear value
//   of the level at (y, x), channel c, divided by min(k_y, 8) * min(k_x, 8).
//   Rois with k > 8 use their first 8 samples, as the JAX package does.
//   Slots that are not valid are written as zeros.
//
// Layout: each level is [B, H_l, W_l, C] (channels last), float32 or
// bfloat16; output [B * R, 7, 7, C] float32, the order the RoI head's fc0
// flattens.
//
// Design. One block per roi slot; threads over channels, so each bilinear
// tap is a coalesced read of 32 consecutive channels per warp. The block
// first tabulates its roi's sample taps per axis in shared memory (7 bins x
// 8 samples: two rows, a fraction, or "outside"), then each thread sums its
// channel over the 49 bins x samples x 4 taps in float32 registers. Build
// without fast math: the tap coordinates use __fmul_rn / __fadd_rn / fmaf so
// that nothing is contracted differently from the form above.
//
// Bound on the H100: at batch 2 and 1,000 rois per image on a 1080p frame
// (P2 192 x 336 ... P5 24 x 42, C = 256) the output alone is 100 MB of
// float32 and the levels 88 MB of bfloat16, so bytes bound it (~0.06 ms at
// 3.35 TB/s when every level is read once). This kernel re-reads taps
// through L1/L2 (4 taps per sample, up to 64 samples per bin) and keeps no
// separable weights: a later redesign can pool each roi's rows once in
// shared memory, or run the 7 x k by k x C products on the tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT = 7;
constexpr int K_MAX = 8;
constexpr int MAX_THREADS = 256;
constexpr int NLEVELS = 4;

struct Levels {
  const void* f[NLEVELS];
  int h[NLEVELS];
  int w[NLEVELS];
  float scale[NLEVELS];
};

// sample taps of one axis, for bin i (0..6) and sample j (0..7): rows lo and
// hi and the weight frac of hi; lo < 0 marks a sample outside the level or
// past min(k, 8)
struct Taps {
  int lo[OUT][K_MAX];
  int hi[OUT][K_MAX];
  float frac[OUT][K_MAX];
};

struct Axis {
  float c1, bin, step;
  int n;  // samples used per bin: min(k, 8)
};

__device__ __forceinline__ Axis make_axis(float lo, float hi, float scale, float inv_out,
                                          float& denom) {
  Axis a;
  a.c1 = __fsub_rn(__fmul_rn(lo, scale), 0.5f);
  const float c2 = __fsub_rn(__fmul_rn(hi, scale), 0.5f);
  const float span = __fsub_rn(c2, a.c1);
  a.bin = __fmul_rn(span, inv_out);
  const int k = (int)ceilf(__fmul_rn(fmaxf(span, 0.0f), inv_out));
  const float kf = fmaxf((float)k, 1.0f);
  a.step = __fdiv_rn(a.bin, kf);
  a.n = min(k, K_MAX);
  denom = fminf(kf, (float)K_MAX);
  return a;
}

__device__ __forceinline__ void make_tap(const Axis& a, int size, int i, int j,
                                         int& lo, int& hi, float& frac) {
  float y = __fadd_rn(fmaf((float)i, a.bin, a.c1), __fmul_rn((float)j + 0.5f, a.step));
  if (j >= a.n || !(y >= -1.0f && y <= (float)size)) {
    lo = -1;
    hi = -1;
    frac = 0.0f;
    return;
  }
  y = fmaxf(y, 0.0f);
  const float yl = floorf(y);
  if (yl >= (float)(size - 1)) {  // the last row: weight 1, no second tap
    lo = hi = size - 1;
    frac = 0.0f;
  } else {
    lo = (int)yl;
    hi = lo + 1;
    frac = __fsub_rn(y, yl);
  }
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load(const uint16_t* p) {  // bfloat16 bits
  return __uint_as_float((uint32_t)__ldg((const unsigned short*)p) << 16);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
roi_align_kernel(Levels lv, int R, int C, const float* __restrict__ boxes,
                 const int* __restrict__ levels, const uint8_t* __restrict__ valid,
                 float inv_out, float* __restrict__ dst) {
  __shared__ Taps ty, tx;
  __shared__ float inv_denom;
  const int n = blockIdx.x;
  float* o = dst + (size_t)n * OUT * OUT * C;
  if (!valid[n]) {
    for (int t = threadIdx.x; t < OUT * OUT * C; t += blockDim.x) o[t] = 0.0f;
    return;
  }
  const int l = min(max(levels[n], 0), NLEVELS - 1);
  const int H = lv.h[l], W = lv.w[l];
  const float* bx = boxes + 4 * (size_t)n;
  float dy, dx;
  const Axis ay = make_axis(bx[1], bx[3], lv.scale[l], inv_out, dy);
  const Axis ax = make_axis(bx[0], bx[2], lv.scale[l], inv_out, dx);
  for (int t = threadIdx.x; t < 2 * OUT * K_MAX; t += blockDim.x) {
    const int axis = t / (OUT * K_MAX), i = (t / K_MAX) % OUT, j = t % K_MAX;
    Taps& tp = axis ? tx : ty;
    make_tap(axis ? ax : ay, axis ? W : H, i, j, tp.lo[i][j], tp.hi[i][j], tp.frac[i][j]);
  }
  if (threadIdx.x == 0) inv_denom = 1.0f / (dy * dx);
  __syncthreads();

  const T* f = (const T*)lv.f[l] + (size_t)(n / R) * H * W * C;
  const size_t row = (size_t)W * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const T* fc = f + c;
    for (int i = 0; i < OUT; ++i) {
      for (int jx = 0; jx < OUT; ++jx) {
        float acc = 0.0f;
        for (int sy = 0; sy < ay.n; ++sy) {
          const int y0 = ty.lo[i][sy];
          if (y0 < 0) continue;
          const float fy = ty.frac[i][sy];
          const T* r0 = fc + y0 * row;
          const T* r1 = fc + ty.hi[i][sy] * row;
          for (int sx = 0; sx < ax.n; ++sx) {
            const int x0 = tx.lo[jx][sx];
            if (x0 < 0) continue;
            const int x1 = tx.hi[jx][sx];
            const float fx = tx.frac[jx][sx];
            const float top = (1.0f - fx) * load(r0 + (size_t)x0 * C) + fx * load(r0 + (size_t)x1 * C);
            const float bot = (1.0f - fx) * load(r1 + (size_t)x0 * C) + fx * load(r1 + (size_t)x1 * C);
            acc += (1.0f - fy) * top + fy * bot;
          }
        }
        o[(i * OUT + jx) * C + c] = acc * inv_denom;
      }
    }
  }
}

}  // namespace

// f0..f3: level maps [B, H_l, W_l, C] (hw: H_0, W_0, ..., H_3, W_3; scales:
// 1 / stride per level); dtype 0 = float32, 1 = bfloat16; boxes float32
// [B * R, 4] in input pixels; levels int32 [B * R] in 0..3; valid uint8
// [B * R]; dst float32 [B * R, 7, 7, C]. Returns the launch's
// cudaGetLastError().
extern "C" int roi_align_launch(const void* f0, const void* f1, const void* f2,
                                const void* f3, const int* hw, const float* scales,
                                int dtype, int B, int R, int C, const void* boxes,
                                const void* levels, const void* valid, float inv_out,
                                void* dst, void* stream) {
  if (B <= 0 || R <= 0 || C <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* fs[NLEVELS] = {f0, f1, f2, f3};
  for (int l = 0; l < NLEVELS; ++l) {
    lv.f[l] = fs[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.scale[l] = scales[l];
    if (lv.h[l] <= 0 || lv.w[l] <= 0) return (int)cudaErrorInvalidValue;
  }
  const int threads = min(MAX_THREADS, (C + 31) / 32 * 32);
  const long long blocks = (long long)B * R;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    roi_align_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        lv, R, C, (const float*)boxes, (const int*)levels, (const uint8_t*)valid, inv_out,
        (float*)dst);
  } else {
    roi_align_kernel<uint16_t><<<(unsigned)blocks, threads, 0, s>>>(
        lv, R, C, (const float*)boxes, (const int*)levels, (const uint8_t*)valid, inv_out,
        (float*)dst);
  }
  return (int)cudaGetLastError();
}
