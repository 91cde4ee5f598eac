// Column sums of uint8 frame rows, for exact window averages: the threads of
// a block sweep a byte segment of a run of frame rows together (coalesced,
// 16 bytes a thread where the rows are 16-byte aligned) and leave, per byte
// of the segment, the int32 sum over the rows in shared memory. Used by
// pool_crops.cu (the crop windows) and pnet_level.cu (the pre-pool of the
// downscaled pyramid levels).

#pragma once

#include <stdint.h>

namespace window_sums {

__device__ __forceinline__ void add_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  lo += w & 0x00ff00ffu;          // bytes 0 and 2
  hi += (w >> 8) & 0x00ff00ffu;   // bytes 1 and 3
}

__device__ __forceinline__ void fold(uint32_t lo, uint32_t hi, int* tot) {
  tot[0] += (int)(lo & 0xffffu);
  tot[1] += (int)(hi & 0xffffu);
  tot[2] += (int)(lo >> 16);
  tot[3] += (int)(hi >> 16);
}

// Sums the bytes [b0, b1) of rows [ys, ye) (rows row_bytes apart from
// `rows`) over the rows into colsum, and returns off: colsum[off + k] holds
// byte b0 + k. vec16: `rows` and row_bytes are multiples of 16, so the sweep
// reads uint4 and adds two bytes per 32-bit add (16-bit lanes, folded into
// int32 every 256 rows); else it reads bytes. colsum holds b1 - b0 + 32
// ints. No barrier: the caller synchronizes before reading colsum.
__device__ __forceinline__ int column_sums(const uint8_t* __restrict__ rows,
                                           size_t row_bytes, int b0, int b1,
                                           int ys, int ye, bool vec16,
                                           int* colsum) {
  if (!vec16) {
    for (int j = threadIdx.x; j < b1 - b0; j += blockDim.x) {
      int sum = 0;
      for (int y = ys; y < ye; ++y) sum += rows[(size_t)y * row_bytes + b0 + j];
      colsum[j] = sum;
    }
    return 0;
  }
  const int v0 = b0 >> 4, nvec = ((b1 + 15) >> 4) - v0;
  const uint4* col = reinterpret_cast<const uint4*>(rows) + v0;
  const size_t stride = row_bytes / 16;
  for (int j = threadIdx.x; j < nvec; j += blockDim.x) {
    int tot[16] = {};
    for (int y = ys; y < ye;) {
      const int yend = min(ye, y + 256);   // a 16-bit lane holds 256 bytes
      uint32_t lo[4] = {}, hi[4] = {};
#pragma unroll 4
      for (; y < yend; ++y) {
        const uint4 q = __ldg(col + (size_t)y * stride + j);
        add_pairs(q.x, lo[0], hi[0]);
        add_pairs(q.y, lo[1], hi[1]);
        add_pairs(q.z, lo[2], hi[2]);
        add_pairs(q.w, lo[3], hi[3]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) fold(lo[k], hi[k], tot + 4 * k);
    }
    int4* dst = reinterpret_cast<int4*>(colsum + 16 * j);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_int4(tot[4 * k], tot[4 * k + 1], tot[4 * k + 2], tot[4 * k + 3]);
  }
  return b0 & 15;
}

// whether a frame's rows can be swept 16 bytes at a time
inline bool rows_vec16(const void* frames, int W) {
  return (uintptr_t)frames % 16 == 0 && (size_t)W * 3 % 16 == 0;
}

}  // namespace window_sums
