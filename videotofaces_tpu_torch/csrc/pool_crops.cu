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
// Bound on the H100: the work is the bytes of the live windows plus the
// outputs, and a handful of integer adds per byte: bound by memory traffic.
// At stage 2 the slot table has B*1024 rows and at stage 3 B*256, most of
// them dead in ordinary frames, and the live windows run from 8 px to the
// frame's height, so the real work depends on the data.
//
// Design. The sums are separable: a block owns one slot and a band of RB
// output rows. For each output row it (1) sums the window's frame rows
// [ys, ye) column by column — the threads sweep each row segment of 3*ww
// contiguous bytes together, 16 bytes a thread (uint4, where the frame's rows
// are 16-byte aligned; else byte by byte), coalesced, two bytes per 32-bit
// add (16-bit lanes, folded into int32 every 256 rows) — into int32 column
// sums in shared memory, then (2) one thread per (ox, channel) adds its
// column bin. Adaptive bins overlap, so a pixel on a bin boundary counts in
// both, as it must. Each frame byte of a window is read once per output row
// it belongs to (once or twice), instead of once per output channel and bin
// it belongs to with 3-byte strides, as one thread per output did. Bands
// spread a large slot over several blocks; small slots (windows narrower
// than out, bins of 1-2 px) go through the same path and stay exact. Build
// without fast math, so that "/" stays IEEE-exact.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_sums.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int RB = 2;          // output rows per block

__global__ void __launch_bounds__(NTHREADS)
pool_crops_kernel(const uint8_t* __restrict__ frames, int B, int H, int W,
                  const int* __restrict__ slots, int S, int vec16,
                  float* __restrict__ out) {
  extern __shared__ int colsum[];   // per byte of the row segment (+ alignment)
  const int n = blockIdx.x;
  const int oy_lo = blockIdx.y * RB, oy_hi = min(S, oy_lo + RB);
  const int* s = slots + 6 * n;
  const int img = s[0], y0 = s[1], x0 = s[2], wh = s[3], ww = s[4], ok = s[5];
  const int row_elems = S * 3;
  float* o = out + (size_t)n * S * row_elems;
  const bool live = ok != 0 && img >= 0 && img < B && y0 >= 0 && x0 >= 0 &&
                    wh > 0 && ww > 0 && y0 <= H - wh && x0 <= W - ww;
  if (!live) {
    for (int i = threadIdx.x; i < (oy_hi - oy_lo) * row_elems; i += NTHREADS)
      o[oy_lo * row_elems + i] = 0.0f;
    return;
  }
  const uint8_t* frame = frames + (size_t)img * H * W * 3;

  for (int oy = oy_lo; oy < oy_hi; ++oy) {
    const int ys = y0 + (oy * wh) / S, ye = y0 + ((oy + 1) * wh + S - 1) / S;
    // (1) column sums over the rows [ys, ye)
    const int off = window_sums::column_sums(frame, (size_t)W * 3, x0 * 3, (x0 + ww) * 3,
                                             ys, ye, vec16 != 0, colsum);
    __syncthreads();
    // (2) column bins: one thread per (ox, channel)
    for (int i = threadIdx.x; i < row_elems; i += NTHREADS) {
      const int ox = i / 3, c = i % 3;
      const int xs = (ox * ww) / S, xe = ((ox + 1) * ww + S - 1) / S;
      const int* v = colsum + off + (2 - c);   // BGR frame -> RGB channel c
      int sum = 0;
      for (int x = xs; x < xe; ++x) sum += v[3 * x];
      const float area = (float)((ye - ys) * (xe - xs));
      o[oy * row_elems + i] = ((float)sum / area - 127.5f) / 128.0f;
    }
    __syncthreads();
  }
}

}  // namespace

// frames: uint8 [B, H, W, 3] BGR; slots: int32 [N, 6]; out: float32
// [N, S, S, 3], N >= 1. Returns the launch's cudaGetLastError().
extern "C" int pool_crops_launch(const void* frames, int B, int H, int W,
                                 const void* slots, int N, int S, void* out,
                                 void* stream) {
  if (N <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int vec16 = window_sums::rows_vec16(frames, W);
  const size_t smem = ((size_t)W * 3 + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_crops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)N, (unsigned)((S + RB - 1) / RB));
  pool_crops_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, B, H, W, (const int*)slots, S, vec16, (float*)out);
  return (int)cudaGetLastError();
}
