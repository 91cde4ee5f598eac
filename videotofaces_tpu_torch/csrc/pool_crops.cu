// MTCNN stage-2/3 crop resample: exact adaptive-average pooling of integer
// windows of the uint8 frames to out x out, normalized.
//
// Replaces the Pallas TPU kernel videotofaces_tpu/ops/pallas_crops.py::
// adaptive_pool_crops (per-crop DMA of a pre-normalized float patch, pooled
// by two f32 matmuls, in 128 px / 512 px size buckets with a capped gather
// fallback that can drop candidates).
//
// What it computes, per slot n with row (img, y0, x0, wh, ww, ok) of the
// int32 slot table:
//   out[n][oy][ox][c] = ((sum over rows [y0 + floor(oy*wh/S),
//                         y0 + ceil((oy+1)*wh/S)) and the same for columns of
//                         frame RGB channel c) / area - 127.5) / 128
// with the sum in int32 and one float32 division: bit for bit the JAX
// package's gather engine, _normalize(adaptive_pool_boxes_batched(...))
// (models/mtcnn.py:1072), which is F.adaptive_avg_pool2d of the crop.
// Slots with ok == 0, or whose window is not inside the frame, are zero and
// cost no frame reads. There is no window-size limit, so nothing is dropped.
//
// Design. One block per slot, threads over its out*out*3 outputs; each
// output sums its own window. Build without fast math, so that "/" stays
// IEEE-exact.
//
// Bound on the H100: the work is the bytes of the live windows (each frame
// byte of a window read once per channel it holds) plus the outputs, and a
// handful of integer adds per byte: bound by memory traffic. At stage 2 the
// slot table has B*1024 rows and at stage 3 B*256, most of them dead in
// ordinary frames, so the real work depends on the data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
pool_crops_kernel(const uint8_t* __restrict__ frames, int B, int H, int W,
                  const int* __restrict__ slots, int S,
                  float* __restrict__ out) {
  const int n = blockIdx.x;
  const int* s = slots + 6 * n;
  const int img = s[0], y0 = s[1], x0 = s[2], wh = s[3], ww = s[4], ok = s[5];
  float* o = out + (size_t)n * S * S * 3;
  const int total = S * S * 3;
  const bool live = ok != 0 && img >= 0 && img < B && y0 >= 0 && x0 >= 0 &&
                    wh > 0 && ww > 0 && y0 <= H - wh && x0 <= W - ww;
  if (!live) {
    for (int i = threadIdx.x; i < total; i += NTHREADS) o[i] = 0.0f;
    return;
  }
  const uint8_t* frame = frames + (size_t)img * H * W * 3;
  for (int i = threadIdx.x; i < total; i += NTHREADS) {
    const int c = i % 3, j = i / 3;
    const int ox = j % S, oy = j / S;
    const int ys = y0 + (oy * wh) / S, ye = y0 + ((oy + 1) * wh + S - 1) / S;
    const int xs = x0 + (ox * ww) / S, xe = x0 + ((ox + 1) * ww + S - 1) / S;
    const uint8_t* base = frame + (2 - c);  // BGR frame -> RGB channel c
    int sum = 0;
    for (int y = ys; y < ye; ++y) {
      const uint8_t* row = base + (size_t)y * W * 3;
      for (int x = xs; x < xe; ++x) sum += row[3 * x];
    }
    const float area = (float)((ye - ys) * (xe - xs));
    o[i] = ((float)sum / area - 127.5f) / 128.0f;
  }
}

}  // namespace

// frames: uint8 [B, H, W, 3] BGR; slots: int32 [N, 6]; out: float32
// [N, S, S, 3], N >= 1. Returns the launch's cudaGetLastError().
extern "C" int pool_crops_launch(const void* frames, int B, int H, int W,
                                 const void* slots, int N, int S, void* out,
                                 void* stream) {
  if (N <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  pool_crops_kernel<<<N, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, B, H, W, (const int*)slots, S, (float*)out);
  return (int)cudaGetLastError();
}
