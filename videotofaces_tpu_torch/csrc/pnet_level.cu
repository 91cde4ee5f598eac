// PNet over one MTCNN pyramid level, pool included.
//
// Replaces the two Pallas TPU kernels of the JAX package's stage 1:
//   videotofaces_tpu/ops/pallas_pnet.py::pnet_level_fused (levels whose pool
//   windows are <= 2 wide) and ::pnet_level (the downscaled levels, pooled
//   beforehand by ops/resize.py::adaptive_pool_full_phase_mm01).
// One entry point covers every level, pooling straight from the uint8 BGR
// frame by exact int32 window sums: levels whose windows are at most 2 wide
// are pooled inside the PNet kernel (as pnet_level_fused does), the others
// first by pool_level_kernel into a small channels-last scratch level (as the
// JAX package pre-pools them for pnet_level).
//
// What it computes, per image b and level (SH, SW) of an H x W frame:
//   level[y][x][c] = round_T(((sum of frame RGB channel c over the adaptive
//                    window [ys, ye) x [xs, xe)) / area - 127.5) / 128)
//   pool1 = round_T(ceil-mode 2x2/2 max-pool of PReLU(conv3x3 3->10 + b1))
//   c2    = round_T(PReLU(conv3x3 10->16 + b2))
//   c3    = round_T(PReLU(conv3x3 16->32 + b3))
//   heads = 1x1 conv 32->6 + bh;  reg = round_T(heads[0:4]),
//   prob  = sigmoid(heads[5] - heads[4])  (== softmax(cls)[1]), float32.
// T is the compute type (float or bf16). Conv operands are T-valued, every
// product and sum is float32, and the maps are rounded to T exactly where the
// JAX kernel body rounds them (pallas_pnet.py::_make_body_r4): the pooled
// level, pool1, c2, c3 and reg. Outputs are unpadded:
//   reg [B, 4, PH, PW] (T), prob [B, PH, PW] (float32),
//   PH = ceil((SH-2)/2) - 4, PW = ceil((SW-2)/2) - 4.
//
// What bounds it. At batch 2, 1080p, min face 5 the pyramid is ~175 GFLOP
// per batch and moves ~0.15 GB (frames in, reg/prob out): bound by
// operations, 0.18 ms at the bf16 tensor-core rate, 2.6 ms at the float32
// CUDA-core rate. Every layer is a GEMM in implicit form: M is the output
// positions (millions per level), N the output channels (16 or 32, padded
// from 10 and 6), K the taps times input channels (27, 90, 144). Thin
// channels make N and K small, not M, so they fit mma.sync's m16n8k16 tiles.
//
// Design, bf16 (pnet_tc_kernel): one block of 8 warps per (image, 32x32
// tile of output positions). The tile's level pixels (74x74 plus halo, 4
// channels of which the 4th is 0), pool1 (36x36x16) and c2 (34x34x16,
// over the level's space once pool1 exists) live in 86 KB of shared memory,
// channels-last, so a tap is a shifted view of the map read with ldmatrix:
// conv2 and conv3 per tap (16-channel pixels, halves XOR-swizzled by pixel
// bit 2 so that 8 consecutive pixels hit 8 distinct bank groups), conv1 per
// kernel row (K = ky x (4 columns x 4 channels), 3 k16 steps; the odd column
// phase reads the even phase's aligned 4-column view with weights shifted a
// column, so four ldmatrix serve all 24 products of 16 pool1 positions).
// Windows of at most 2x2 frame pixels are pooled from a frame patch staged
// in shared memory, as a quarter of their four corners' sum (exact). Each
// warp takes 16 flattened positions at a time (M), all N tiles, and runs
// mma.sync.m16n8k16 bf16 -> f32. The bias, PReLU, the ceil-mode 2x2 max
// (over the four conv1 phases, held in registers), the validity mask and the
// bf16 rounding are its epilogue; the conv3 accumulators become the A
// fragments of the heads' product directly. Weights arrive as B fragments
// packed by the wrapper (ops/pnet_kernel.py::tc_fragments), one 16-byte load
// per fragment and thread. A 32x32 tile recomputes 1.27x (pool1) and 1.13x
// (c2) of its halo, against 1.56x and 1.27x at 16x16. Two blocks fit an SM
// (128 registers a thread). Padding (K 27 -> 48 for conv1, N 10 -> 16) and
// the halo make ~2x the MMAs of the useful products; staging the level tile
// and the epilogues, not the MMAs, take most of the kernel's time.
//
// Design, float32 (pnet_level_kernel): the parity path, float32 FFMA on the
// CUDA cores only (no TF32, no tensor cores). Its bound: a batch of 4 1080p
// frames at min face 5 is ~350 GFLOP over 16 levels, 5.3 ms at 67 TFLOP/s
// (the three upscaled levels 87 % of it); its bytes take ~0.26 ms. A first
// design (one block per 16x16 tile, one conv3 position per thread) reached
// ~15 % of that: each multiply-add loaded its weight from device memory
// (an SM runs loads at a quarter of the FFMA rate), no input or weight was reused
// from a register across positions, and the tiles recomputed 1.14x the work
// in their halos. This design:
//  - copies the 6,632 plain weights into shared memory once per block; the
//    blocks are persistent (as many as fit the device, two per SM, each
//    looping over tiles), and every weight is read as a 16-byte broadcast
//    load that feeds 4 output channels at several positions;
//  - blocks outputs in registers: conv1 takes two pool positions x four
//    phases x 10 channels a thread, the position's 4x4 level patch of one
//    kernel row in registers (720 FFMA a row for 69 loads); conv2 five
//    positions x 16 channels (80 FFMA for 9 loads); conv3 eight positions x
//    16 channels, two lanes sharing each position's 32 channels, over c2
//    kept channels-last so that one 16-byte load brings 4 input channels
//    (128 FFMA for 6 loads). The two lanes then trade halves, so that each
//    runs the heads of 4 positions over all 32 channels;
//  - tiles 16x32 outputs: pool1 20x36 and c2 18x34, 1.10x the work, in
//    105 KB of shared memory (pool1 holds the tile's frame patch before it
//    holds pool1; c2 lies over the level tile); ptxas: 255 registers, no
//    spill, so two blocks of 128 threads fill an SM. A 1080p batch of 4 has
//    23,328 tiles at its largest level and 3,016 at its largest pre-pooled
//    one, enough for the 264 resident blocks; the smallest levels are one
//    tile per image and cost a tile's latency.
// Each output's sums keep their order (fmaf over ky, kx, ci from 0, then
// bias, PReLU, the 2x2 max over the phases; the heads over ci), so reg and
// prob equal the first design's bit for bit. On an H100 SXM at 700 W the
// pyramid of a batch of 4 takes ~11.8 ms, ~45 % of the bound (the first
// design ~34 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

#include "window_sums.cuh"

namespace {

// packed weight offsets (floats); conv kernels HWIO, heads [32][6]
constexpr int OW1 = 0, OB1 = OW1 + 3 * 3 * 3 * 10, OA1 = OB1 + 10;
constexpr int OW2 = OA1 + 10, OB2 = OW2 + 3 * 3 * 10 * 16, OA2 = OB2 + 16;
constexpr int OW3 = OA2 + 16, OB3 = OW3 + 3 * 3 * 16 * 32, OA3 = OB3 + 32;
constexpr int OWH = OA3 + 32, OBH = OWH + 32 * 6, NPLAIN = OBH + 6;
// B fragments of the tensor-core path, after the plain weights (bf16 only): per
// (k16 step, n8 tile) 32 lanes x 4 values (rows 2t, 2t+1, 2t+8, 2t+9 of the
// step, column g of the tile); conv1 6x2 tiles (two column phases), conv2
// 9x2, conv3 9x4, heads 2x1
constexpr int FT1 = 0, FT2 = FT1 + 6 * 2, FT3 = FT2 + 9 * 2, FTH = FT3 + 9 * 4,
              NFTILES = FTH + 2;
constexpr int OFRAG = NPLAIN, NWEIGHTS = OFRAG + NFTILES * 32 * 4;

template <typename T> struct Conv;
template <> struct Conv<float> {
  __device__ static float to(float v) { return v; }
};
template <> struct Conv<__nv_bfloat16> {
  __device__ static __nv_bfloat16 to(float v) { return __float2bfloat16_rn(v); }
};

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

// adaptive-average-pool window bounds of level index l on an axis of n_in
// frame pixels pooled to n_out (F.adaptive_avg_pool2d bounds)
__device__ __forceinline__ int win_start(int l, int n_in, int n_out) {
  return (int)(((long long)l * n_in) / n_out);
}
__device__ __forceinline__ int win_end(int l, int n_in, int n_out) {
  return (int)(((long long)(l + 1) * n_in + n_out - 1) / n_out);
}

__device__ __forceinline__ void add_rgb(const uint8_t* bgr, int s[3]) {
  s[0] += bgr[2];  // BGR frame -> RGB channels
  s[1] += bgr[1];
  s[2] += bgr[0];
}

// exact window average (int32 sum, one IEEE division), then MTCNN's
// (x - 127.5) / 128
__device__ __forceinline__ float normalized(int sum, int area) {
  return ((float)sum / (float)area - 127.5f) / 128.0f;
}

// Pre-pool of a level whose windows are wider than 2 frame pixels (the
// downscaled levels, which the JAX package pooled outside its kernel too):
// out [B, SH, SW, 4] in T, channel 3 zero. One block per (level row, image):
// its threads sum the row's window of frame rows [ys, ye) column by column,
// sweeping whole frame rows together (window_sums.cuh), then each thread
// adds the column window of one level pixel — the smallest levels pool
// ~70x70 frame pixels per level pixel, and each frame byte is read once per
// level row it belongs to (once or twice), in coalesced 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(256)
pool_level_kernel(const uint8_t* __restrict__ frames, int H, int W, int SH,
                  int SW, int vec16, T* __restrict__ out) {
  extern __shared__ int colsum[];   // [W * 3 + 32]
  const int ly = blockIdx.x, b = blockIdx.y;
  const int ys = win_start(ly, H, SH), ye = win_end(ly, H, SH);
  window_sums::column_sums(frames + (size_t)b * H * W * 3, (size_t)W * 3, 0, W * 3,
                           ys, ye, vec16 != 0, colsum);
  __syncthreads();
  for (int lx = threadIdx.x; lx < SW; lx += blockDim.x) {
    const int xs = win_start(lx, W, SW), xe = win_end(lx, W, SW);
    int s[3] = {0, 0, 0};
    for (int x = xs; x < xe; ++x) {
      s[0] += colsum[3 * x + 2];   // BGR frame -> RGB channels
      s[1] += colsum[3 * x + 1];
      s[2] += colsum[3 * x];
    }
    const int area = (ye - ys) * (xe - xs);
    T* o = out + (((size_t)b * SH + ly) * SW + lx) * 4;
    for (int k = 0; k < 3; ++k) o[k] = Conv<T>::to(normalized(s[k], area));
    o[3] = Conv<T>::to(0.0f);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, 16x32 output tiles, two persistent blocks per SM

constexpr int TH = 16, TW = 32;                    // output tile (conv3 positions)
constexpr int C2H = TH + 2, C2W = TW + 2;          // conv2 tile, 18x34
constexpr int P1H = TH + 4, P1W = TW + 4;          // pool1 tile, 20x36
constexpr int LH = 2 * P1H + 2, LW = 2 * P1W + 2;  // level tile, 42x74
constexpr int NTHREADS = 128;
constexpr int C2_PER = (C2H * C2W + NTHREADS - 1) / NTHREADS;   // 5
constexpr int P1_PAIRS = P1H * P1W / 2;   // conv1 work items of two pool positions
// shared memory, in floats: the plain weights at W_OFF (so that the rows of
// w2 and w3 are 16-byte aligned, those of w1 and the heads 8-byte), the
// level tile (c2 over it once pool1 exists), pool1 (the frame patch before
// the level tile exists), and the level's window bounds (ints)
constexpr int W_OFF = 2;
constexpr int MAP_OFF = (W_OFF + NPLAIN + 3) / 4 * 4;
constexpr int C2PX = 20;   // c2 pixel stride (floats): 8 pixels' 16-byte words on 32 banks
constexpr int LVL_ELEMS = 3 * LH * LW, C2_ELEMS = C2PX * C2H * C2W;
constexpr int P1_OFF = MAP_OFF + (LVL_ELEMS > C2_ELEMS ? LVL_ELEMS : C2_ELEMS);
constexpr int P1_ELEMS = 10 * P1H * P1W;
constexpr int BND_OFF = P1_OFF + P1_ELEMS;   // ys[LH], ye[LH], xs[LW], xe[LW]
constexpr int SMEM_BYTES = (BND_OFF + 2 * LH + 2 * LW) * 4;
static_assert((W_OFF + OW2) % 4 == 0 && (W_OFF + OW3) % 4 == 0, "w2, w3 rows 16-byte aligned");
static_assert((W_OFF + OW1) % 2 == 0 && (W_OFF + OWH) % 2 == 0 && NPLAIN % 2 == 0,
              "w1, head rows 8-byte aligned");
static_assert(LW % 2 == 0 && (LH * LW) % 2 == 0 && MAP_OFF % 4 == 0, "level pairs 8-byte aligned");
static_assert(TH == 4 * (NTHREADS / 32) && TW == 32, "stage 4: a warp takes 4 rows of 32");
static_assert((P1H * P1W) % 2 == 0, "conv1 items are pairs");

// acc[p][o] = sum over (ky, kx, ci), in that order from 0, of fmaf(w, x):
// a 3x3 conv at NPOS positions (src[p]: the position's top-left tap in
// plane 0 of a map with row stride SRC_W and plane stride PLANE) for NOUT
// output channels, weights HWIO in shared memory. Each input value feeds
// NOUT products, each 16-byte weight load 4 x NPOS.
template <int NPOS, int NOUT, int CIN, int SRC_W, int PLANE>
__device__ __forceinline__ void conv3x3(const float* (&src)[NPOS], const float* w,
                                        float (&acc)[NPOS][NOUT]) {
#pragma unroll
  for (int p = 0; p < NPOS; ++p)
#pragma unroll
    for (int o = 0; o < NOUT; ++o) acc[p][o] = 0.0f;
#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const int toff = ky * SRC_W + kx;
      const float4* wt = reinterpret_cast<const float4*>(w + (ky * 3 + kx) * CIN * NOUT);
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) {
        float x[NPOS];
#pragma unroll
        for (int p = 0; p < NPOS; ++p) x[p] = src[p][ci * PLANE + toff];
#pragma unroll
        for (int g = 0; g < NOUT / 4; ++g) {
          const float4 v = wt[ci * (NOUT / 4) + g];
#pragma unroll
          for (int p = 0; p < NPOS; ++p) {
            acc[p][4 * g] = fmaf(v.x, x[p], acc[p][4 * g]);
            acc[p][4 * g + 1] = fmaf(v.y, x[p], acc[p][4 * g + 1]);
            acc[p][4 * g + 2] = fmaf(v.z, x[p], acc[p][4 * g + 2]);
            acc[p][4 * g + 3] = fmaf(v.w, x[p], acc[p][4 * g + 3]);
          }
        }
      }
    }
}

__global__ void __launch_bounds__(NTHREADS, 2)
pnet_level_kernel(const uint8_t* __restrict__ frames, int B, int H, int W, int SH,
                  int SW, const float* __restrict__ pooled,
                  const float* __restrict__ wts, float* __restrict__ reg,
                  float* __restrict__ prob) {
  extern __shared__ __align__(16) float shm[];
  float* ws = shm + W_OFF;      // the plain weights, packed order
  float* lvl = shm + MAP_OFF;   // [3][LH][LW]
  float* c2 = lvl;              // [C2H][C2W][C2PX], over the level after stage 2
  float* p1 = shm + P1_OFF;     // [10][P1H][P1W]
  int* bnd = reinterpret_cast<int*>(shm + BND_OFF);

  const int tid = threadIdx.x;
  const int ch = SH - 2, cw = SW - 2;               // conv1 output size
  const int PH = (ch + 1) / 2 - 4, PW = (cw + 1) / 2 - 4;
  const int ntx = (PW + TW - 1) / TW, nty = (PH + TH - 1) / TH, ntiles = ntx * nty * B;

  // the weights, once per block (visible after stage 1's barrier)
#pragma unroll 4
  for (int i = tid; i < NPLAIN / 2; i += NTHREADS)
    reinterpret_cast<float2*>(ws)[i] = __ldg(reinterpret_cast<const float2*>(wts) + i);

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (ntx * nty), t = tile % (ntx * nty);
    const int oy0 = (t / ntx) * TH, ox0 = (t % ntx) * TW;
    const uint8_t* img = frames + (size_t)b * H * W * 3;

    // stage 1: pooled, normalized level tile (rows 2*oy0.., cols 2*ox0..),
    // zero outside the level; read from the pre-pooled level where there is
    // one, else pooled here (windows of at most 2x2 frame pixels) from the
    // tile's frame patch, staged in pool1's space when it fits
    if (pooled != nullptr) {
      const float4* src = reinterpret_cast<const float4*>(pooled) + (size_t)b * SH * SW;
#pragma unroll 4
      for (int i = tid; i < LH * LW; i += NTHREADS) {
        const int r = i / LW, c = i % LW;
        const int ly = 2 * oy0 + r, lx = 2 * ox0 + c;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ly < SH && lx < SW) v = __ldg(src + (size_t)ly * SW + lx);
        lvl[r * LW + c] = v.x;
        lvl[(LH + r) * LW + c] = v.y;
        lvl[(2 * LH + r) * LW + c] = v.z;
      }
    } else {
      for (int i = tid; i < LH + LW; i += NTHREADS) {
        const bool col = i >= LH;
        const int k = col ? i - LH : i, n = col ? LW : LH;
        const int l = (col ? 2 * ox0 : 2 * oy0) + k, n_in = col ? W : H, n_out = col ? SW : SH;
        int* bk = bnd + (col ? 2 * LH : 0);
        bk[k] = win_start(l, n_in, n_out);
        bk[n + k] = win_end(l, n_in, n_out);
      }
      __syncthreads();
      const int* ys = bnd;
      const int* ye = bnd + LH;
      const int* xs = bnd + 2 * LH;
      const int* xe = bnd + 2 * LH + LW;
      const uint8_t* src = img;
      int pitch = W * 3, fy0 = 0, fx0 = 0;
      const int r_last = min(LH, SH - 2 * oy0) - 1, c_last = min(LW, SW - 2 * ox0) - 1;
      const int rows = ye[r_last] - ys[0], bytes = (xe[c_last] - xs[0]) * 3;
      if (rows * bytes <= P1_ELEMS * 4) {
        fy0 = ys[0];
        fx0 = xs[0];
        uint8_t* patch = reinterpret_cast<uint8_t*>(p1);
        const uint8_t* g = img + (size_t)fy0 * pitch + 3 * fx0;
        for (int y = tid / 32; y < rows; y += NTHREADS / 32)
          for (int x = tid % 32; x < bytes; x += 32)
            patch[y * bytes + x] = __ldg(g + (size_t)y * pitch + x);
        __syncthreads();
        src = patch;
        pitch = bytes;
      }
      for (int i = tid; i < LH * LW; i += NTHREADS) {
        const int r = i / LW, c = i % LW;
        float v[3] = {0.0f, 0.0f, 0.0f};
        if (2 * oy0 + r < SH && 2 * ox0 + c < SW) {
          // a window of at most 2x2 pixels: its four corners count each of
          // its pixels 4 / area times, so a quarter of their sum is the
          // exact mean, as normalized() divides it
          const uint8_t* q = src + (size_t)(ys[r] - fy0) * pitch + 3 * (xs[c] - fx0);
          const size_t dyb = (size_t)(ye[r] - 1 - ys[r]) * pitch;
          const int dxb = 3 * (xe[c] - 1 - xs[c]);
          int s[3] = {0, 0, 0};
          add_rgb(q, s);
          add_rgb(q + dxb, s);
          add_rgb(q + dyb, s);
          add_rgb(q + dyb + dxb, s);
          for (int k = 0; k < 3; ++k) v[k] = ((float)s[k] * 0.25f - 127.5f) / 128.0f;
        }
        for (int k = 0; k < 3; ++k) lvl[(k * LH + r) * LW + c] = v[k];
      }
    }
    __syncthreads();

    // stage 2: conv1 + PReLU + ceil-mode 2x2 max-pool (valid conv1 rows and
    // columns only) -> pool1 tile. A work item is two pool positions, each
    // with its four conv1 phases (dy, dx) in registers; per kernel row ky a
    // position's level rows 2py+ky, 2py+ky+1, columns 2px..2px+3, feed all
    // four phases for every (kx, ci).
    for (int it = tid; it < P1_PAIRS; it += NTHREADS) {
      const float* base[2];
      int gy[2], gx[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = it + j * P1_PAIRS, pr = q / P1W, pc = q % P1W;
        base[j] = lvl + 2 * pr * LW + 2 * pc;
        gy[j] = oy0 + pr;
        gx[j] = ox0 + pc;
      }
      float acc[2][4][10];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int f = 0; f < 4; ++f)
#pragma unroll
          for (int o = 0; o < 10; ++o) acc[j][f][o] = 0.0f;
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky) {
        float x[2][3][2][4];   // [position][ci][row dy][column 0..3]
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci)
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
              const float* row = base[j] + (ci * LH + ky + dy) * LW;
              const float2 u = *reinterpret_cast<const float2*>(row);
              const float2 v = *reinterpret_cast<const float2*>(row + 2);
              x[j][ci][dy][0] = u.x;
              x[j][ci][dy][1] = u.y;
              x[j][ci][dy][2] = v.x;
              x[j][ci][dy][3] = v.y;
            }
        const float* wk = ws + OW1 + ky * 3 * 3 * 10;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) {
            float w[10];
#pragma unroll
            for (int o = 0; o < 10; o += 2) {
              const float2 u = *reinterpret_cast<const float2*>(wk + (kx * 3 + ci) * 10 + o);
              w[o] = u.x;
              w[o + 1] = u.y;
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int dy = 0; dy < 2; ++dy)
#pragma unroll
                for (int dx = 0; dx < 2; ++dx)
#pragma unroll
                  for (int o = 0; o < 10; ++o)
                    acc[j][2 * dy + dx][o] =
                        fmaf(w[o], x[j][ci][dy][dx + kx], acc[j][2 * dy + dx][o]);
          }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float m[10];
#pragma unroll
        for (int o = 0; o < 10; ++o) m[o] = -CUDART_INF_F;
        bool any = false;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            if (2 * gy[j] + dy >= ch || 2 * gx[j] + dx >= cw) continue;
            any = true;
#pragma unroll
            for (int o = 0; o < 10; ++o)
              m[o] = fmaxf(m[o], prelu(acc[j][2 * dy + dx][o] + ws[OB1 + o], ws[OA1 + o]));
          }
        // a pool position with no valid conv1 input lies outside the level's
        // pool1 map and feeds only outputs that are never written
        const int q = it + j * P1_PAIRS;
#pragma unroll
        for (int o = 0; o < 10; ++o) p1[o * P1H * P1W + q] = any ? m[o] : 0.0f;
      }
    }
    __syncthreads();

    // stage 3: conv2 + PReLU -> c2 tile, C2_PER positions x 16 channels a
    // thread
    {
      const float* src[C2_PER];
      int q[C2_PER];
#pragma unroll
      for (int k = 0; k < C2_PER; ++k) {
        q[k] = tid + k * NTHREADS;
        const int qq = min(q[k], C2H * C2W - 1);
        src[k] = p1 + (qq / C2W) * P1W + qq % C2W;
      }
      float acc[C2_PER][16];
      conv3x3<C2_PER, 16, 10, P1W, P1H * P1W>(src, ws + OW2, acc);
#pragma unroll
      for (int k = 0; k < C2_PER; ++k) {
        if (q[k] >= C2H * C2W) continue;
#pragma unroll
        for (int o = 0; o < 16; o += 4)
          *reinterpret_cast<float4*>(c2 + q[k] * C2PX + o) = make_float4(
              prelu(acc[k][o] + ws[OB2 + o], ws[OA2 + o]),
              prelu(acc[k][o + 1] + ws[OB2 + o + 1], ws[OA2 + o + 1]),
              prelu(acc[k][o + 2] + ws[OB2 + o + 2], ws[OA2 + o + 2]),
              prelu(acc[k][o + 3] + ws[OB2 + o + 3], ws[OA2 + o + 3]));
      }
    }
    __syncthreads();

    // stage 4: conv3 + PReLU + heads. Lanes 2j and 2j + 1 of warp w share
    // 8 positions (rows 4w .. 4w + 3, columns j and j + 16), the even lane
    // computing channels 0..15, the odd lane 16..31; each 16-byte load of c2
    // brings 4 input channels of one position. Then the lanes trade halves:
    // lane h keeps column j + 16h, all 32 channels, for the heads.
    {
      const int lane = tid & 31, h = lane & 1, j = lane >> 1, r0 = (tid >> 5) * 4;
      float acc[8][16];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int o = 0; o < 16; ++o) acc[k][o] = 0.0f;
      const float* xb = c2 + (r0 * C2W + j) * C2PX;
#pragma unroll 1
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll 1
        for (int kx = 0; kx < 3; ++kx) {
          const float* xt = xb + (ky * C2W + kx) * C2PX;
          const float4* wt =
              reinterpret_cast<const float4*>(ws + OW3 + (ky * 3 + kx) * 16 * 32 + 16 * h);
#pragma unroll 2
          for (int cq = 0; cq < 4; ++cq) {
            float4 x[8];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              x[k] = *reinterpret_cast<const float4*>(
                  xt + ((k & 3) * C2W + 16 * (k >> 2)) * C2PX + 4 * cq);
#pragma unroll
            for (int cj = 0; cj < 4; ++cj)
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                const float4 v = wt[(4 * cq + cj) * 8 + g];
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                  const float xv = cj == 0 ? x[k].x : cj == 1 ? x[k].y : cj == 2 ? x[k].z : x[k].w;
                  acc[k][4 * g] = fmaf(v.x, xv, acc[k][4 * g]);
                  acc[k][4 * g + 1] = fmaf(v.y, xv, acc[k][4 * g + 1]);
                  acc[k][4 * g + 2] = fmaf(v.z, xv, acc[k][4 * g + 2]);
                  acc[k][4 * g + 3] = fmaf(v.w, xv, acc[k][4 * g + 3]);
                }
              }
          }
        }
      // after the trade, lane h holds position (r0 + k, j + 16h): channel c in
      // acc[k][c], channel 16 + c in acc[4 + k][c]
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const float got = __shfl_xor_sync(0xffffffffu, h ? acc[k][c] : acc[4 + k][c], 1);
          if (h) acc[k][c] = got;
          else acc[4 + k][c] = got;
        }
      float hv[4][6];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int o = 0; o < 6; ++o) hv[k][o] = 0.0f;
#pragma unroll
      for (int ci = 0; ci < 32; ++ci) {
        const float bs = ws[OB3 + ci], sl = ws[OA3 + ci];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float v = prelu((ci < 16 ? acc[k][ci] : acc[4 + k][ci - 16]) + bs, sl);
#pragma unroll
          for (int o = 0; o < 6; ++o) hv[k][o] = fmaf(ws[OWH + ci * 6 + o], v, hv[k][o]);
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int oy = oy0 + r0 + k, ox = ox0 + j + 16 * h;
        if (oy >= PH || ox >= PW) continue;
#pragma unroll
        for (int o = 0; o < 4; ++o)
          reg[(((size_t)b * 4 + o) * PH + oy) * PW + ox] = hv[k][o] + ws[OBH + o];
        const float d = (hv[k][5] + ws[OBH + 5]) - (hv[k][4] + ws[OBH + 4]);
        prob[((size_t)b * PH + oy) * PW + ox] = 1.0f / (1.0f + expf(-d));
      }
    }
    __syncthreads();   // the next tile overwrites the maps
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, f32 accumulators), 32x32 tiles

namespace tc {

constexpr int TH = 32, TW = 32;                   // output tile (conv3 positions)
constexpr int C2H = TH + 2, C2W = TW + 2;         // conv2 tile, 34x34
constexpr int P1H = TH + 4, P1W = TW + 4;         // pool1 tile, 36x36
constexpr int LH = 2 * P1H + 2, LW = 2 * P1W + 2;  // level tile, 74x74
constexpr int LWS = LW + 2;   // row stride: conv1's 4th tap column stays in the row
constexpr int NWARPS = 8, NTHREADS = 32 * NWARPS;
constexpr int LVL_BYTES = LH * LWS * 8;           // 4 bf16 channels per pixel
constexpr int P1_BYTES = P1H * P1W * 32;          // 16 bf16 channels per pixel
constexpr int C2_BYTES = C2H * C2W * 32;
constexpr int P1_OFF = LVL_BYTES;                 // c2 reuses [0, C2_BYTES)
constexpr int BND_OFF = P1_OFF + P1_BYTES;        // level window bounds
constexpr int SMEM_BYTES = BND_OFF + 4 * LH * 4;
static_assert(C2_BYTES <= LVL_BYTES, "c2 must fit the level tile");
static_assert(LH == LW, "bounds table holds LH rows and LW columns");
static_assert(P1_OFF % 16 == 0 && BND_OFF % 16 == 0, "16-byte aligned maps");
constexpr int P1_TILES = (P1H * P1W + 15) / 16;   // 81
constexpr int C2_TILES = (C2H * C2W + 15) / 16;   // 73
constexpr int C3_TILES = TH * TW / 16;            // 64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte offset of 8-channel half h of pixel q in a 16-channel map; the halves
// of pixels 4..7 (mod 8) are swapped so that ldmatrix's 8 rows of one
// matrix, 8 consecutive pixels, fall on 8 distinct 16-byte bank groups
__device__ __forceinline__ uint32_t px16(int q, int h) {
  return (uint32_t)(q * 32 + ((h ^ ((q >> 2) & 1)) << 4));
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                      uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

// this lane's B fragment of packed tile ft: {rows 2t,2t+1}, {2t+8,2t+9}
__device__ __forceinline__ void bfrag(const float* __restrict__ wts, int ft,
                                      int lane, uint32_t& b0, uint32_t& b1) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(wts + OFRAG) + ft * 32 + lane);
  b0 = pack_bf16(v.x, v.y);
  b1 = pack_bf16(v.z, v.w);
}

// one 16-position m-tile of a 16-channel-input 3x3 conv with NT n8 tiles:
// ldmatrix A from the source map (width src_w pixels) at flattened
// destination positions (width dst_w), 9 taps = 9 k16 steps
template <int NT>
__device__ __forceinline__ void conv16(uint32_t src, int src_w, int dst_w,
                                       int r_max, int mt, int lane,
                                       const uint32_t (&bw)[9][NT][2],
                                       float (&acc)[NT][4]) {
  const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, h = lane >> 4;
  const int r = min(mt * 16 + mrow, r_max);
  const int q0 = (r / dst_w) * src_w + r % dst_w;
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      uint32_t a0, a1, a2, a3;
      ldsm4(src + px16(q0 + ky * src_w + kx, h), a0, a1, a2, a3);
#pragma unroll
      for (int n = 0; n < NT; ++n)
        mma(acc[n], a0, a1, a2, a3, bw[ky * 3 + kx][n][0], bw[ky * 3 + kx][n][1]);
    }
}

__global__ void __launch_bounds__(NTHREADS, 2)
pnet_tc_kernel(const uint8_t* __restrict__ frames, int H, int W, int SH, int SW,
               const __nv_bfloat16* __restrict__ pooled,
               const float* __restrict__ wts, __nv_bfloat16* __restrict__ reg,
               float* __restrict__ prob) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lvl = reinterpret_cast<uint32_t*>(smem);   // [LH][LWS] x 2 words
  int* bnd = reinterpret_cast<int*>(smem + BND_OFF);   // ys, ye, xs, xe
  const uint32_t s_lvl = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t s_p1 = s_lvl + P1_OFF, s_c2 = s_lvl;

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int ch = SH - 2, cw = SW - 2;                 // conv1 output size
  const int PH = (ch + 1) / 2 - 4, PW = (cw + 1) / 2 - 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // stage 1: the level tile (rows 2*oy0.., cols 2*ox0..) as bf16 RGB0 pixels,
  // zero outside the level and in the stride padding. Pooled here, the
  // tile's windows cover a small frame patch (~31x31 px at the largest
  // level), staged first in pool1's space with coalesced loads: frame pixel
  // (y, x) is then at src + (y - fy0) * pitch + 3 * (x - fx0).
  const uint8_t* src = frames + (size_t)b * H * W * 3;
  size_t pitch = (size_t)W * 3;
  int fy0 = 0, fx0 = 0;
  if (pooled == nullptr) {
    for (int i = tid; i < 2 * LH; i += NTHREADS) {
      const int r = i % LH;
      const bool col = i >= LH;
      const int l = (col ? 2 * ox0 : 2 * oy0) + r, n_in = col ? W : H, n_out = col ? SW : SH;
      bnd[(col ? 2 : 0) * LH + r] = win_start(l, n_in, n_out);
      bnd[(col ? 3 : 1) * LH + r] = win_end(l, n_in, n_out);
    }
    __syncthreads();
    const int r_last = min(LH, SH - 2 * oy0) - 1, c_last = min(LW, SW - 2 * ox0) - 1;
    const int rows = bnd[LH + r_last] - bnd[0];
    const int bytes = (bnd[3 * LH + c_last] - bnd[2 * LH]) * 3;
    if (rows * bytes <= P1_BYTES) {
      fy0 = bnd[0];
      fx0 = bnd[2 * LH];
      uint8_t* patch = smem + P1_OFF;
      const uint8_t* g = src + (size_t)fy0 * pitch + 3 * fx0;
      for (int y = warp; y < rows; y += NWARPS)
        for (int x = lane; x < bytes; x += 32) patch[y * bytes + x] = __ldg(g + y * pitch + x);
      __syncthreads();
      src = patch;
      pitch = bytes;
    }
  }
  for (int i = tid; i < LH * LWS; i += NTHREADS) {
    const int r = i / LWS, c = i % LWS;
    const int ly = 2 * oy0 + r, lx = 2 * ox0 + c;
    uint2 v = make_uint2(0u, 0u);
    if (c < LW && ly < SH && lx < SW) {
      if (pooled != nullptr) {
        v = __ldg(reinterpret_cast<const uint2*>(pooled) + ((size_t)b * SH + ly) * SW + lx);
      } else {
        // a window of at most 2x2 pixels: its four corners count each of its
        // pixels 4 / area times, so a quarter of their sum is the exact mean
        const int ys = bnd[r], ye = bnd[LH + r], xs = bnd[2 * LH + c], xe = bnd[3 * LH + c];
        const uint8_t* p = src + (ys - fy0) * pitch + 3 * (xs - fx0);
        const size_t dyb = (ye - 1 - ys) * pitch;
        const int dxb = 3 * (xe - 1 - xs);
        int s[3] = {0, 0, 0};
        add_rgb(p, s);
        add_rgb(p + dxb, s);
        add_rgb(p + dyb, s);
        add_rgb(p + dyb + dxb, s);
        float f[3];
        for (int k = 0; k < 3; ++k) f[k] = ((float)s[k] * 0.25f - 127.5f) / 128.0f;
        v = make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], 0.0f));
      }
    }
    reinterpret_cast<uint2*>(lvl)[i] = v;
  }
  __syncthreads();

  // stage 2: conv1 for the four 2x2 pool phases (dy, dx), PReLU, max over
  // the valid phases -> pool1 (16 channels, 10..15 zero). K = ky x (4
  // columns x 4 channels): both column phases read level columns 2px..2px+3
  // of row 2py + dy + ky, a 16-byte-aligned view that ldmatrix loads once for
  // the four row offsets dy + ky; phase dx = 0 weights the first three
  // columns, phase dx = 1 (its own B fragments, shifted a column) the last
  // three.
  {
    uint32_t bw[2][3][2][2];   // [dx][ky][n tile][reg]
    float bias[2][2], slope[2][2];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          bfrag(wts, FT1 + (dx * 3 + k) * 2 + n, lane, bw[dx][k][n][0], bw[dx][k][n][1]);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int o = n * 8 + 2 * t + j;
        bias[n][j] = o < 10 ? wts[OB1 + o] : 0.0f;
        slope[n][j] = o < 10 ? wts[OA1 + o] : 0.0f;
      }
    const int mrow = (lane & 7) + ((lane >> 3) & 1) * 8, h = lane >> 4;
    for (int mt = warp; mt < P1_TILES; mt += NWARPS) {
      const int rl = mt * 16 + mrow;               // this lane's ldmatrix row
      const uint32_t arow =
          s_lvl + (uint32_t)((2 * (rl / P1W) * LWS + 2 * (rl % P1W)) * 8 + h * 16);
      uint32_t a[4][4];                            // level rows 2py + 0..3
#pragma unroll
      for (int d = 0; d < 4; ++d)
        ldsm4(arow + d * LWS * 8, a[d][0], a[d][1], a[d][2], a[d][3]);
      int gy[2], gx[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = mt * 16 + g + 8 * j;
        gy[j] = oy0 + r / P1W;
        gx[j] = ox0 + r % P1W;
      }
      float m[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n) m[n][0] = m[n][1] = m[n][2] = m[n][3] = -CUDART_INF_F;
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          float acc[2][4] = {};
#pragma unroll
          for (int ky = 0; ky < 3; ++ky)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma(acc[n], a[dy + ky][0], a[dy + ky][1], a[dy + ky][2], a[dy + ky][3],
                  bw[dx][ky][n][0], bw[dx][ky][n][1]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {       // row g (j = 0), row g + 8 (j = 1)
            if (2 * gy[j] + dy >= ch || 2 * gx[j] + dx >= cw) continue;
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                m[n][2 * j + e] = fmaxf(m[n][2 * j + e],
                                        prelu(acc[n][2 * j + e] + bias[n][e], slope[n][e]));
          }
        }
      // a pool position with no valid conv1 input lies outside the level's
      // pool1 map and feeds only outputs that are never written
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = mt * 16 + g + 8 * j;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float v0 = m[n][2 * j], v1 = m[n][2 * j + 1];
          const bool any = v0 != -CUDART_INF_F;
          *reinterpret_cast<uint32_t*>(smem + P1_OFF + px16(q, n) + 4 * t) =
              pack_bf16(any ? v0 : 0.0f, any ? v1 : 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // stage 3: conv2 + PReLU -> c2 (over the level tile)
  {
    uint32_t bw[9][2][2];
    float bias[2][2], slope[2][2];
#pragma unroll
    for (int k = 0; k < 9; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) bfrag(wts, FT2 + k * 2 + n, lane, bw[k][n][0], bw[k][n][1]);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        bias[n][j] = wts[OB2 + n * 8 + 2 * t + j];
        slope[n][j] = wts[OA2 + n * 8 + 2 * t + j];
      }
    for (int mt = warp; mt < C2_TILES; mt += NWARPS) {
      float acc[2][4];
      conv16<2>(s_p1, P1W, C2W, C2H * C2W - 1, mt, lane, bw, acc);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int q = mt * 16 + g + 8 * j;
        if (q >= C2H * C2W) continue;
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<uint32_t*>(smem + px16(q, n) + 4 * t) =
              pack_bf16(prelu(acc[n][2 * j] + bias[n][0], slope[n][0]),
                        prelu(acc[n][2 * j + 1] + bias[n][1], slope[n][1]));
      }
    }
  }
  __syncthreads();

  // stage 4: conv3 + PReLU, rounded to bf16 in registers, which are the A
  // fragments of the heads' product (K = the 32 channels, N = 6 of 8)
  uint32_t bw[9][4][2], bh[2][2];
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int n = 0; n < 4; ++n) bfrag(wts, FT3 + k * 4 + n, lane, bw[k][n][0], bw[k][n][1]);
#pragma unroll
  for (int k = 0; k < 2; ++k) bfrag(wts, FTH + k, lane, bh[k][0], bh[k][1]);
  const float hb0 = t < 3 ? wts[OBH + 2 * t] : 0.0f, hb1 = t < 3 ? wts[OBH + 2 * t + 1] : 0.0f;
  for (int mt = warp; mt < C3_TILES; mt += NWARPS) {
    float acc[4][4];
    conv16<4>(s_c2, C2W, TW, TH * TW - 1, mt, lane, bw, acc);
    uint32_t a[4][2];   // [n tile][row g, row g + 8]
#pragma unroll
    for (int n = 0; n < 4; ++n) {   // bias and slopes re-read through L1
      const float2 bs = __ldg(reinterpret_cast<const float2*>(wts + OB3 + n * 8) + t);
      const float2 sl = __ldg(reinterpret_cast<const float2*>(wts + OA3 + n * 8) + t);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        a[n][j] = pack_bf16(prelu(acc[n][2 * j] + bs.x, sl.x),
                            prelu(acc[n][2 * j + 1] + bs.y, sl.y));
    }
    float hv[4] = {};
#pragma unroll
    for (int k = 0; k < 2; ++k)
      mma(hv, a[2 * k][0], a[2 * k][1], a[2 * k + 1][0], a[2 * k + 1][1], bh[k][0], bh[k][1]);
    // columns 2t, 2t+1: t = 0, 1 -> reg channels; t = 2 -> cls0, cls1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = mt * 16 + g + 8 * j;
      const int oy = oy0 + r / TW, ox = ox0 + r % TW;
      if (oy >= PH || ox >= PW || t == 3) continue;
      const float v0 = hv[2 * j] + hb0, v1 = hv[2 * j + 1] + hb1;
      if (t < 2) {
        reg[(((size_t)b * 4 + 2 * t) * PH + oy) * PW + ox] = __float2bfloat16_rn(v0);
        reg[(((size_t)b * 4 + 2 * t + 1) * PH + oy) * PW + ox] = __float2bfloat16_rn(v1);
      } else {
        prob[((size_t)b * PH + oy) * PW + ox] = 1.0f / (1.0f + expf(-(v1 - v0)));
      }
    }
  }
}

}  // namespace tc

template <typename T>
int prepool(const void* frames, int B, int H, int W, int SH, int SW, void* pooled,
            cudaStream_t s) {
  const size_t smem = ((size_t)W * 3 + 32) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pool_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pool_level_kernel<T><<<dim3((unsigned)SH, (unsigned)B), 256, smem, s>>>(
      (const uint8_t*)frames, H, W, SH, SW, (int)window_sums::rows_vec16(frames, W),
      (T*)pooled);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pnet_weight_count() { return NWEIGHTS; }
extern "C" int pnet_plain_weight_count() { return NPLAIN; }

// frames: uint8 [B, H, W, 3] BGR; pooled: NULL for a level whose pool
// windows are at most 2 wide (pooled inside the kernel), else scratch T
// [B, SH, SW, 4] for the pre-pool; weights: float32 [NWEIGHTS] for bf16,
// [NPLAIN] for float32; reg: T
// [B, 4, PH, PW]; prob: float32 [B, PH, PW]; bf16 != 0 selects T = bf16 and
// the tensor-core kernel. Returns the first failing launch's
// cudaGetLastError(), else 0.
extern "C" int pnet_level_launch(const void* frames, int B, int H, int W,
                                 int SH, int SW, void* pooled,
                                 const void* weights, void* reg, void* prob,
                                 int bf16, void* stream) {
  const int PH = (SH - 1) / 2 - 4, PW = (SW - 1) / 2 - 4;
  if (B <= 0 || PH <= 0 || PW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (pooled != nullptr) {
      const int e = prepool<__nv_bfloat16>(frames, B, H, W, SH, SW, pooled, s);
      if (e != 0) return e;
    }
    // the dynamic shared-memory limit is raised once per device
    static std::atomic<bool> smem_set[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!smem_set[dev].load()) {
      e = cudaFuncSetAttribute(tc::pnet_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tc::SMEM_BYTES);
      if (e != cudaSuccess) return (int)e;
      smem_set[dev].store(true);
    }
    const dim3 grid((PW + tc::TW - 1) / tc::TW, (PH + tc::TH - 1) / tc::TH, B);
    tc::pnet_tc_kernel<<<grid, tc::NTHREADS, tc::SMEM_BYTES, s>>>(
        (const uint8_t*)frames, H, W, SH, SW, (const __nv_bfloat16*)pooled,
        (const float*)weights, (__nv_bfloat16*)reg, (float*)prob);
    return (int)cudaGetLastError();
  }
  if (pooled != nullptr) {
    const int e = prepool<float>(frames, B, H, W, SH, SW, pooled, s);
    if (e != 0) return e;
  }
  // persistent blocks, as many as the device holds at once: its shared-memory
  // limit is raised and its occupancy read once per device
  static std::atomic<int> resident[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  int blocks = resident[dev].load();
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    e = cudaFuncSetAttribute(pnet_level_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pnet_level_kernel, NTHREADS,
                                                        SMEM_BYTES);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    blocks = (per_sm > 0 ? per_sm : 1) * sms;
    resident[dev].store(blocks);
  }
  const long long tiles = (long long)((PW + TW - 1) / TW) * ((PH + TH - 1) / TH) * B;
  pnet_level_kernel<<<(unsigned)(tiles < blocks ? tiles : blocks), NTHREADS, SMEM_BYTES, s>>>(
      (const uint8_t*)frames, B, H, W, SH, SW, (const float*)pooled, (const float*)weights,
      (float*)reg, (float*)prob);
  return (int)cudaGetLastError();
}
