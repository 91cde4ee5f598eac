// Encoder input prep: half-pixel bilinear resize of packed uint8 crops to
// out x out, BGR -> RGB, and (x - mean) * scale, in one pass.
//
// Replaces the Pallas TPU kernel videotofaces_tpu/ops/pallas_resize.py::
// resize_normalize_chw_u8 (one program per image; dense [out, Smax] hat
// matrices built in VMEM, then two MXU matmuls per channel).
//
// What it computes, for image n of true size (h, w) inside the packed
// [N, S, S, 3] uint8 buffer (top-left anchored), output row oy, column ox:
//   sy = clip((oy + 0.5) * h / out - 0.5, 0, h - 1), y0 = floor(sy), y1 = y0 + 1
//   wy(i) = max(0, 1 - |sy - i|) for i in {y0, y1}, and 0 where i >= h
//   (the same for x), then
//   t(x) = wy(y0) * img[y0][x] + wy(y1) * img[y1][x]      rows first,
//   r    = t(x0) * wx(x0) + t(x1) * wx(x1)                 then columns,
//   out[n][c][oy][ox] = (r - mean) * scale, channel c read from 2 - c when
//   swap_rb. The coordinate is computed as XLA compiles the JAX kernel's
//   (pallas_resize.py:29-37): the division by the constant out becomes a
//   product with its float32 reciprocal, fused with the "- 0.5",
//   fma((o + 0.5) * h, inv_out, -0.5). With the JAX weight formula after
//   it, the weights equal the jitted JAX matrix entries bit for bit (an
//   exact division differs by an ulp of the coordinate at some outputs,
//   up to 5e-5 after normalization). Every other matrix entry is zero, so
//   the sums differ from its matmuls only by FMA contraction. Output is
//   NCHW, the layout the port's FaceNet consumes.
//
// Design. One thread per output pixel of one image, all three channels;
// blocks of 256 threads over the out*out pixels (row-major, so a warp's
// writes of one channel are contiguous), blockIdx.y = image. Each thread
// reads its four 3-byte taps. Build without fast math; the coordinate's
// product is __fmul_rn so that it is never contracted into the fma.
//
// Bound on the H100: bytes. Per image the output is 3*out*out float32
// (307 KB at out 160) and the input touched is at most the h x w x 3 crop;
// a handful of flops per output. At N = 128, out 160 that is ~39 MB written
// and <= 25 MB read: ~0.01-0.02 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

struct Taps {
  int i0, i1;
  float w0, w1;
};

// Two-tap bilinear weights along one axis: the nonzero entries of the
// jitted JAX kernel's [out, max] _weights matrix.
__device__ __forceinline__ Taps taps(int o, int size, float inv_out) {
  const float sf = (float)size;
  float src = fmaf(__fmul_rn((float)o + 0.5f, sf), inv_out, -0.5f);
  src = fminf(fmaxf(src, 0.0f), sf - 1.0f);
  Taps t;
  t.i0 = (int)floorf(src);
  t.w0 = fmaxf(0.0f, 1.0f - fabsf(src - (float)t.i0));
  t.i1 = t.i0 + 1;
  if (t.i1 < size) {
    t.w1 = fmaxf(0.0f, 1.0f - fabsf(src - (float)t.i1));
  } else {
    t.i1 = t.i0;  // weight 0: stay inside the crop
    t.w1 = 0.0f;
  }
  return t;
}

__global__ void __launch_bounds__(NTHREADS)
resize_normalize_kernel(const uint8_t* __restrict__ packed, int S,
                        const int* __restrict__ sizes, int out, float inv_out,
                        float scale, float mean, int swap_rb,
                        float* __restrict__ dst) {
  const int n = blockIdx.y;
  const int p = blockIdx.x * NTHREADS + threadIdx.x;
  const int plane = out * out;
  if (p >= plane) return;
  const int oy = p / out, ox = p % out;
  // sizes outside [1, S] are clamped, so no tap leaves the image's slot
  const int h = min(max(sizes[2 * n], 1), S), w = min(max(sizes[2 * n + 1], 1), S);
  const Taps ty = taps(oy, h, inv_out);
  const Taps tx = taps(ox, w, inv_out);
  const uint8_t* img = packed + (size_t)n * S * S * 3;
  const uint8_t* r0 = img + (size_t)ty.i0 * S * 3;
  const uint8_t* r1 = img + (size_t)ty.i1 * S * 3;
  float* o = dst + (size_t)n * 3 * plane + p;
  for (int c = 0; c < 3; ++c) {
    const int ci = swap_rb ? 2 - c : c;
    const float t0 = ty.w0 * (float)r0[3 * tx.i0 + ci] + ty.w1 * (float)r1[3 * tx.i0 + ci];
    const float t1 = ty.w0 * (float)r0[3 * tx.i1 + ci] + ty.w1 * (float)r1[3 * tx.i1 + ci];
    const float r = t0 * tx.w0 + t1 * tx.w1;
    o[(size_t)c * plane] = (r - mean) * scale;
  }
}

}  // namespace

// packed: uint8 [N, S, S, 3]; sizes: int32 [N, 2] (h, w), clamped to [1, S];
// inv_out: float32 1 / out; dst: float32 [N, 3, out, out], N >= 1. Returns
// the launch's cudaGetLastError().
extern "C" int resize_normalize_launch(const void* packed, int N, int S,
                                       const void* sizes, int out, float inv_out,
                                       float scale, float mean, int swap_rb,
                                       void* dst, void* stream) {
  if (N <= 0 || S <= 0 || out <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((out * out + NTHREADS - 1) / NTHREADS, N);
  resize_normalize_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, S, (const int*)sizes, out, inv_out, scale, mean,
      swap_rb, (float*)dst);
  return (int)cudaGetLastError();
}
