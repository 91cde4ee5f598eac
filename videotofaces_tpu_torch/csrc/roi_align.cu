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
// This kernel computes the function of the dense separable method
// (ops/roi_align.py::_roi_align_dense, the port's roi_align_fpn_plain)
// directly: no window, no bucket, no fixed point, so no roi is dropped or
// truncated.
//
// What it computes, for roi n = (image b, slot r) on level l (given, computed
// on the host side by assign_fpn_levels), per axis with c1 = x1 / stride -
// 0.5, c2 = x2 / stride - 0.5 on a level of extent S:
//   span = c2 - c1, bin = span * f32(1/7), k = ceil(max(span, 0) * f32(1/7)),
//   step = bin / max(k, 1) (an IEEE division), and for bin i, sample j < min(k, 8):
//   y = fma(i, bin, c1) + (j + 0.5) * step (rounded so; XLA compiles the JAX
//   package's expression into that form). A sample outside [-1, S]
//   contributes zero; one in the last row (or beyond) clamps to it with
//   weight 1. The weight of row r in bin i is the sum, in sample order, of
//   the bilinear hat weights the bin's samples put on r, divided once by
//   min(max(k, 1), 8): exactly _axis_weights' rounding, so the weights equal
//   the plain version's (and jitted JAX's) bit for bit. Then
//   out[n][i][j][c] = sum_x wx[j][x] * (sum_y wy[i][y] * F[y][x][c]),
//   rows first, in float32. Slots that are not valid are written as zeros.
//
// Layout: each level is [B, H_l, W_l, C] (channels last), float32 or
// bfloat16; output [B * R, 7, 7, C] float32, the order the RoI head's fc0
// flattens.
//
// Bound on the H100: at batch 2 and 1,000 rois per image on a 1080p frame
// (P2 192 x 336 ... P5 24 x 42, C = 256) the output alone is 100 MB of
// float32 and the level pixels the rois touch (each read once) tens of MB,
// so bytes bound it (~0.05 ms at 3.35 TB/s in bf16); the arithmetic is a
// few GFLOP. A design that pools each roi on its own reads each roi's patch
// once, so the rois' overlap is read again (from L2 where it hits).
//
// What held the first design (one block per roi, threads over channels)
// back: every bilinear tap of every sample was its own 2-byte load, and
// neighbouring samples share taps, so a 30 x 30 px patch cost 49 bins x 16
// samples x 4 taps = 3,136 dependent loads per channel: load instructions,
// not bytes, set its time (13.5x the bound).
//
// Design. Along one axis a bin's samples are at most 1 px apart (step = bin
// / ceil(bin) <= 1) and monotone, so the rows (columns) a bin touches are
// one contiguous range of at most 10, and two neighbouring bins share at
// most two of them (the earlier bin's last sample lies before the later
// bin's first). The tables are per roi and axis, per bin: the range's
// start, its length and its weights (16 slots), exact. Every slot is one
// thread, which walks the bin's samples in registers (7 x bins and the
// block's y bin: 8 x 16 threads, one barrier).
// One block per (roi, bin row i), 14,000 blocks per batch; threads over
// channel vectors (float4, or four bfloat16 in 8 bytes, converted to
// float32 on load; one channel a thread where C is no multiple of 4). For
// each x bin j in turn, a thread sums, per column x of the bin, T = sum_y
// wy[i][y] * F[y][x][c..c+3] over the bin row's rows, and out[i][j] = sum_x
// wx[j][x] * T. A thread consumes only the channels it loaded, so T is
// its own: each column's T is also written to one of two shared-memory
// slots of the thread, the slot of the column's parity, and the next bin
// reads the columns it shares from there, so each touched feature value is
// loaded once per bin row. New columns are summed in increasing order and
// a bin shares at most the earlier bins' last two, so a shared column is
// the last one summed (end) or the one before it (end - 1): two parities,
// both still in their slots. The bin's new columns go NC at a time with
// RC rows of each in flight (addresses past the bin or the rows are
// clamped, so that the loads issue together), and a register cap keeps
// 12-16 blocks on an SM: the loads are latency bound, and resident blocks
// hide that best (see Tune). There is no window and no second path: a
// 1333 x 5 px box on P2 (k = 48 along x) runs the same loop. The earlier
// per-tap loads are gone, and the bytes a bin row loads are its patch,
// once.
// Tensor cores are not used: the work is a few multiply-adds per loaded
// value (0-16 taps a row and column), far below the ~300 operations per
// byte at which a product becomes operation bound on this card, and the
// output stays float32 sums of float32 products (no TF32). Build without
// fast math: the tap coordinates use __fmul_rn / __fadd_rn / fmaf so that
// nothing is contracted differently from the form above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OUT = 7;
constexpr int K_MAX = 8;
constexpr int SPAN = 16;              // weight slots of one bin's range (<= 10 used)
constexpr int RC_MAX = 4;             // the most rows of a column loaded at once
constexpr int MAX_THREADS = 256;
constexpr int NLEVELS = 4;

struct Levels {
  const void* f[NLEVELS];
  int h[NLEVELS];
  int w[NLEVELS];
  float scale[NLEVELS];
};

// Per element type: NC new columns x RC rows of vector loads in flight per
// thread, and the blocks of MAX_THREADS that must fit an SM (a register
// cap: 64 registers for bfloat16, 80 for float32). Measured on the H100 at
// the R-CNN's shapes: resident blocks hide the per-block latency chains
// better than more loads per thread (chip_smoke.py 3d times the result).
template <typename T>
struct Tune;
template <>
struct Tune<uint16_t> {
  static constexpr int NC = 2, RC = 2, MIN_BLOCKS = 4;
};
template <>
struct Tune<float> {
  static constexpr int NC = 2, RC = 4, MIN_BLOCKS = 3;
};

struct Axis {
  float c1, bin, step, denom;
  int n;  // samples used per bin: min(k, 8)
};

__device__ __forceinline__ Axis make_axis(float lo, float hi, float scale, float inv_out) {
  Axis a;
  a.c1 = __fsub_rn(__fmul_rn(lo, scale), 0.5f);
  const float c2 = __fsub_rn(__fmul_rn(hi, scale), 0.5f);
  const float span = __fsub_rn(c2, a.c1);
  a.bin = __fmul_rn(span, inv_out);
  const int k = (int)ceilf(__fmul_rn(fmaxf(span, 0.0f), inv_out));
  const float kf = fmaxf((float)k, 1.0f);
  a.step = __fdiv_rn(a.bin, kf);
  a.n = min(k, K_MAX);
  a.denom = fminf(kf, (float)K_MAX);
  return a;
}

// Slot o of bin i's weights along an axis of extent `size`: the weight of
// row start + o, where start is the row of the bin's first sample inside the
// axis. Each sample adds its hat weights in sample order, then the sum is
// divided once, as _axis_weights rounds; len is the number of rows the bin
// touches (one contiguous range, at most 10: samples are monotone and at
// most 1 px apart). Every thread of the bin walks all its samples, so the
// table is built in registers, in parallel.
__device__ __forceinline__ float bin_slot(const Axis& a, int size, int i, int o, int& start,
                                          int& len) {
  const float row = fmaf((float)i, a.bin, a.c1);
  int s = 0, n = 0;
  float w = 0.0f;
  for (int j = 0; j < a.n; ++j) {
    float y = __fadd_rn(row, __fmul_rn((float)j + 0.5f, a.step));
    if (!(y >= -1.0f && y <= (float)size)) continue;
    y = fmaxf(y, 0.0f);
    const float yl = floorf(y);
    int lo;
    float wlo, whi = 0.0f;
    if (yl >= (float)(size - 1)) {  // the last row: weight 1, no second tap
      lo = size - 1;
      wlo = 1.0f;
    } else {
      lo = (int)yl;
      whi = __fsub_rn(y, yl);
      wlo = __fsub_rn(1.0f, whi);
    }
    if (n == 0) s = lo;
    const int d = lo - s;
    if (d == o) w = __fadd_rn(w, wlo);
    if (d + 1 == o && whi != 0.0f) w = __fadd_rn(w, whi);
    n = max(n, d + (whi != 0.0f ? 2 : 1));
  }
  start = s;
  len = min(n, SPAN);  // <= 10, see above
  return o < len ? __fdiv_rn(w, a.denom) : 0.0f;
}

// V consecutive channels as float32
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load(const uint16_t* p, float (&v)[V]) {  // bfloat16 bits
  if constexpr (V == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  } else {
    v[0] = __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS, Tune<T>::MIN_BLOCKS)
roi_align_kernel(Levels lv, int R, int C, const float* __restrict__ boxes,
                 const int* __restrict__ levels, const uint8_t* __restrict__ valid,
                 float inv_out, float* __restrict__ dst) {
  constexpr int NC = Tune<T>::NC, RC = Tune<T>::RC;
  static_assert(RC <= RC_MAX, "row batch past the tables' zero padding");
  // weights of x bins 0..6, then of y bin i; zero past each bin's length
  __shared__ float wb[OUT + 1][SPAN + RC_MAX];
  __shared__ int bstart[OUT + 1], blen[OUT + 1];
  // [2][blockDim.x][V]: each thread's T of the last even and odd column
  extern __shared__ float carry[];

  const int n = blockIdx.x / OUT, i = blockIdx.x % OUT;
  const int groups = C / V;
  float* o = dst + ((size_t)n * OUT + i) * OUT * C;
  const bool live = valid[n];
  const int l = min(max(levels[n], 0), NLEVELS - 1);
  const float* bx = boxes + 4 * (size_t)n;
  const float x1 = bx[0], y1 = bx[1], x2 = bx[2], y2 = bx[3];
  if (!live) {
    float z[V] = {};
    for (int g = threadIdx.x; g < groups; g += blockDim.x)
      for (int j = 0; j < OUT; ++j) store<V>(o + j * C + g * V, z);
    return;
  }
  const int H = lv.h[l], W = lv.w[l];
  const Axis ax = make_axis(x1, x2, lv.scale[l], inv_out);
  const Axis ay = make_axis(y1, y2, lv.scale[l], inv_out);

  // the tables: thread (bin b, slot e) for the 7 x bins and the y bin i
  for (int t = threadIdx.x; t < (OUT + 1) * (SPAN + RC_MAX); t += blockDim.x) {
    const int b = t / (SPAN + RC_MAX), e = t % (SPAN + RC_MAX);
    float w = 0.0f;
    if (e < SPAN) {
      int start, len;
      w = b < OUT ? bin_slot(ax, W, b, e, start, len) : bin_slot(ay, H, i, e, start, len);
      if (e == 0) {
        bstart[b] = start;
        blen[b] = len;
      }
    }
    wb[b][e] = w;
  }
  __syncthreads();

  const int na = blen[OUT];
  const T* f = (const T*)lv.f[l] + ((size_t)(n / R) * H + bstart[OUT]) * W * C;
  const size_t rs = (size_t)W * C;
  const float* wy = wb[OUT];
  // T of column x lies in slot x & 1, so end - 1 and end have slots of
  // their own
  float* tc = carry + threadIdx.x * V;
  const int ts = V * blockDim.x;  // slot stride
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const T* fc = f + g * V;
    int end = -1;  // the last column of the bins so far
    for (int j = 0; j < OUT; ++j) {
      const int s = bstart[j], len = blen[j];
      const float* wx = wb[j];
      float acc[V] = {};
      // columns an earlier bin summed: at most end - 1 and end (see the header)
      const int shared = min(len, max(0, end + 1 - s));
      for (int e = 0; e < shared; ++e) {
        const float* t = tc + ((s + e) & 1) * ts;
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = fmaf(wx[e], t[q], acc[q]);
      }
      // the bin's new columns, NC at a time, RC rows of each in flight
      for (int e0 = shared; e0 < len; e0 += NC) {
        float t[NC][V] = {};
        for (int a0 = 0; a0 < na; a0 += RC) {
          float v[NC][RC][V];
#pragma unroll
          for (int u = 0; u < NC; ++u)
#pragma unroll
            for (int r = 0; r < RC; ++r) {
              // past the bin's end or the row count: a clamped address, so
              // that all NC x RC loads issue together; such a row has
              // weight 0, such a column is dropped
              const int row = min(a0 + r, na - 1), col = s + min(e0 + u, len - 1);
              load<V>(fc + (size_t)row * rs + (size_t)col * C, v[u][r]);
            }
#pragma unroll
          for (int u = 0; u < NC; ++u)
#pragma unroll
            for (int r = 0; r < RC; ++r)
#pragma unroll
              for (int q = 0; q < V; ++q) t[u][q] = fmaf(wy[a0 + r], v[u][r][q], t[u][q]);
        }
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          if (e0 + u >= len) break;
#pragma unroll
          for (int q = 0; q < V; ++q) {
            acc[q] = fmaf(wx[e0 + u], t[u][q], acc[q]);
            tc[((s + e0 + u) & 1) * ts + q] = t[u][q];
          }
        }
      }
      if (len > 0) end = max(end, s + len - 1);
      store<V>(o + j * C + g * V, acc);
    }
  }
}

template <typename T, int V>
void launch(const Levels& lv, int B, int R, int C, const void* boxes, const void* levels,
            const void* valid, float inv_out, void* dst, cudaStream_t s) {
  const int threads = min(MAX_THREADS, (C / V + 31) / 32 * 32);
  roi_align_kernel<T, V><<<(unsigned)((long long)B * R * OUT), threads,
                           2 * V * threads * sizeof(float), s>>>(
      lv, R, C, (const float*)boxes, (const int*)levels, (const uint8_t*)valid, inv_out,
      (float*)dst);
}

bool aligned(const void* p, size_t bytes) { return (uintptr_t)p % bytes == 0; }

}  // namespace

// f0..f3: level maps [B, H_l, W_l, C] (hw: H_0, W_0, ..., H_3, W_3; scales:
// 1 / stride per level); dtype 0 = float32, 1 = bfloat16; boxes float32
// [B * R, 4] in input pixels; levels int32 [B * R] in 0..3; valid uint8
// [B * R]; dst float32 [B * R, 7, 7, C]. Loads four channels at a time when
// C is a multiple of 4 and every map and dst are aligned for it, else one.
// Returns the launch's cudaGetLastError().
extern "C" int roi_align_launch(const void* f0, const void* f1, const void* f2,
                                const void* f3, const int* hw, const float* scales,
                                int dtype, int B, int R, int C, const void* boxes,
                                const void* levels, const void* valid, float inv_out,
                                void* dst, void* stream) {
  if (B <= 0 || R <= 0 || C <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  const void* fs[NLEVELS] = {f0, f1, f2, f3};
  const size_t esize = dtype == 0 ? 4 : 2;
  bool vec = C % 4 == 0 && aligned(dst, 16);
  for (int l = 0; l < NLEVELS; ++l) {
    lv.f[l] = fs[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    lv.scale[l] = scales[l];
    if (lv.h[l] <= 0 || lv.w[l] <= 0) return (int)cudaErrorInvalidValue;
    vec = vec && aligned(fs[l], 4 * esize);
  }
  if ((long long)B * R * OUT > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    if (vec)
      launch<float, 4>(lv, B, R, C, boxes, levels, valid, inv_out, dst, s);
    else
      launch<float, 1>(lv, B, R, C, boxes, levels, valid, inv_out, dst, s);
  } else {
    if (vec)
      launch<uint16_t, 4>(lv, B, R, C, boxes, levels, valid, inv_out, dst, s);
    else
      launch<uint16_t, 1>(lv, B, R, C, boxes, levels, valid, inv_out, dst, s);
  }
  return (int)cudaGetLastError();
}
