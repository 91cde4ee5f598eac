// PNet over one MTCNN pyramid level, pool included, in one kernel.
//
// Replaces the two Pallas TPU kernels of the JAX package's stage 1:
//   videotofaces_tpu/ops/pallas_pnet.py::pnet_level_fused (levels whose pool
//   windows are <= 2 wide) and ::pnet_level (the downscaled levels, pooled
//   beforehand by ops/resize.py::adaptive_pool_full_phase_mm01).
// One entry point covers every level, pooling straight from the uint8 BGR
// frame by exact int32 window sums: levels whose windows are at most 2 wide
// are pooled inside the PNet kernel (as pnet_level_fused does), the others
// first by pool_level_kernel into a small scratch level (as the JAX package
// pre-pools them for pnet_level).
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
// Design. One block per (image, 16x16 tile of output positions); the tile's
// level pixels (plus halo), its pool1 map and its c2 map live in shared
// memory, so no intermediate reaches device memory. The level is up to
// 4609 wide at 1080p / min face 5, so tiles split rows AND columns. The c2
// map reuses the level tile's shared memory (dead once pool1 exists), which
// keeps the block at 37 KB (float) / 18.5 KB (bf16). Weights (6632 floats)
// are read through L1: every thread of a warp reads the same weight, so each
// load is one broadcast. The pre-pool gives each level pixel a group of up
// to 32 lanes: the smallest levels pool ~70x70 frame pixels per level pixel
// and have only a couple of PNet blocks. The upscaled levels (windows of 1-2
// frame pixels) skip it: pooling them inside the PNet kernel, halo included,
// is about 10 % faster on an H100 than writing and reading a scratch level
// (PERF.md, "One pooling path").
//
// Bound on the H100: at batch 2, 1080p, min face 5 the pyramid is about
// 175 GFLOP per batch; the bytes are small (frames in, reg/prob out, ~0.15
// GB), so the work is bound by operations. Channels of 3/10/16/32 are too
// thin for wgmma tiles, so this first kernel runs float32 FMAs on the CUDA
// cores (67 TFLOP/s peak: ~2.6 ms per batch at best); the halo costs 1.27x
// (c2) to 1.56x (pool1) recomputation per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TH = 16, TW = 16;                  // output tile (conv3 positions)
constexpr int C2H = TH + 2, C2W = TW + 2;        // conv2 tile
constexpr int P1H = TH + 4, P1W = TW + 4;        // pool1 tile
constexpr int LH = 2 * P1H + 2, LW = 2 * P1W + 2;  // level tile
constexpr int NTHREADS = TH * TW;
constexpr int LEVEL_ELEMS = 3 * LH * LW;
constexpr int P1_ELEMS = 10 * P1H * P1W;
static_assert(16 * C2H * C2W <= LEVEL_ELEMS, "c2 must fit the level tile");

// packed weight offsets (floats); conv kernels HWIO, heads [32][6]
constexpr int OW1 = 0, OB1 = OW1 + 3 * 3 * 3 * 10, OA1 = OB1 + 10;
constexpr int OW2 = OA1 + 10, OB2 = OW2 + 3 * 3 * 10 * 16, OA2 = OB2 + 16;
constexpr int OW3 = OA2 + 16, OB3 = OW3 + 3 * 3 * 16 * 32, OA3 = OB3 + 32;
constexpr int OWH = OA3 + 32, OBH = OWH + 32 * 6, NWEIGHTS = OBH + 6;

template <typename T> struct Conv;
template <> struct Conv<float> {
  __device__ static float to(float v) { return v; }
  __device__ static float from(float v) { return v; }
};
template <> struct Conv<__nv_bfloat16> {
  __device__ static __nv_bfloat16 to(float v) { return __float2bfloat16_rn(v); }
  __device__ static float from(__nv_bfloat16 v) { return __bfloat162float(v); }
};

__device__ __forceinline__ float prelu(float v, float a) {
  return fmaxf(v, 0.0f) + a * fminf(v, 0.0f);
}

// adaptive-average-pool window of level pixel (ly, lx): frame rows [ys, ye),
// columns [xs, xe) (F.adaptive_avg_pool2d bounds)
struct Window {
  int ys, ye, xs, xe;
};
__device__ __forceinline__ Window level_window(int ly, int lx, int H, int W,
                                               int SH, int SW) {
  return {(int)(((long long)ly * H) / SH),
          (int)(((long long)(ly + 1) * H + SH - 1) / SH),
          (int)(((long long)lx * W) / SW),
          (int)(((long long)(lx + 1) * W + SW - 1) / SW)};
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
// out [B, 3, SH, SW] in T. A group of G lanes (a power of two <= 32, about
// the window width) sums each level pixel's window, striding over its
// columns row by row, and reduces with shuffles — the smallest levels pool
// ~70x70 frame pixels each, too many for one thread, and spread over
// thousands of warps this way instead of over the pnet kernel's few blocks.
template <typename T>
__global__ void __launch_bounds__(256)
pool_level_kernel(const uint8_t* __restrict__ frames, int B, int H, int W,
                  int SH, int SW, int G, T* __restrict__ out) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long p = gid / G;
  const int lane = (int)(gid % G);
  const bool live = p < (long long)B * SH * SW;
  int s[3] = {0, 0, 0}, area = 1;
  int b = 0, ly = 0, lx = 0;
  if (live) {
    b = (int)(p / ((long long)SH * SW));
    ly = (int)((p / SW) % SH);
    lx = (int)(p % SW);
    const Window win = level_window(ly, lx, H, W, SH, SW);
    area = (win.ye - win.ys) * (win.xe - win.xs);
    const uint8_t* img = frames + (size_t)b * H * W * 3;
    for (int y = win.ys; y < win.ye; ++y)
      for (int x = win.xs + lane; x < win.xe; x += G)
        add_rgb(img + ((size_t)y * W + x) * 3, s);
  }
  for (int o = G / 2; o > 0; o >>= 1)
    for (int k = 0; k < 3; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  if (live && lane == 0)
    for (int k = 0; k < 3; ++k)
      out[(((size_t)b * 3 + k) * SH + ly) * SW + lx] = Conv<T>::to(normalized(s[k], area));
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
pnet_level_kernel(const uint8_t* __restrict__ frames, int H, int W, int SH,
                  int SW, const T* __restrict__ pooled,
                  const float* __restrict__ wts, T* __restrict__ reg,
                  float* __restrict__ prob) {
  __shared__ T smem[LEVEL_ELEMS + P1_ELEMS];
  T* lvl = smem;                 // [3][LH][LW]
  T* p1 = smem + LEVEL_ELEMS;    // [10][P1H][P1W]
  T* c2 = smem;                  // [16][C2H][C2W], aliases lvl after stage 2

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int ch = SH - 2, cw = SW - 2;               // conv1 output size
  const int PH = (ch + 1) / 2 - 4, PW = (cw + 1) / 2 - 4;
  const uint8_t* img = frames + (size_t)b * H * W * 3;

  // stage 1: pooled, normalized level tile (rows 2*oy0.., cols 2*ox0..),
  // read from the pre-pooled level where there is one, else pooled here
  // (windows of at most 2x2 frame pixels)
  for (int i = threadIdx.x; i < LH * LW; i += NTHREADS) {
    const int r = i / LW, c = i % LW;
    const int ly = 2 * oy0 + r, lx = 2 * ox0 + c;
    const bool inside = ly < SH && lx < SW;
    if (pooled != nullptr) {
      for (int k = 0; k < 3; ++k)
        lvl[(k * LH + r) * LW + c] =
            inside ? pooled[(((size_t)b * 3 + k) * SH + ly) * SW + lx] : Conv<T>::to(0.0f);
      continue;
    }
    int s[3] = {0, 0, 0}, area = 1;
    if (inside) {
      const Window win = level_window(ly, lx, H, W, SH, SW);
      area = (win.ye - win.ys) * (win.xe - win.xs);
      for (int y = win.ys; y < win.ye; ++y)
        for (int x = win.xs; x < win.xe; ++x) add_rgb(img + ((size_t)y * W + x) * 3, s);
    }
    for (int k = 0; k < 3; ++k)
      lvl[(k * LH + r) * LW + c] = Conv<T>::to(inside ? normalized(s[k], area) : 0.0f);
  }
  __syncthreads();

  // stage 2: conv1 + PReLU + ceil-mode 2x2 max-pool (valid conv1 rows and
  // columns only) -> pool1 tile
  for (int i = threadIdx.x; i < P1H * P1W; i += NTHREADS) {
    const int pr = i / P1W, pc = i % P1W;
    const int gy = oy0 + pr, gx = ox0 + pc;
    float m[10];
    for (int o = 0; o < 10; ++o) m[o] = -CUDART_INF_F;
    bool any = false;
    for (int dy = 0; dy < 2; ++dy) {
      for (int dx = 0; dx < 2; ++dx) {
        if (2 * gy + dy >= ch || 2 * gx + dx >= cw) continue;
        any = true;
        float acc[10];
        for (int o = 0; o < 10; ++o) acc[o] = 0.0f;
        for (int ky = 0; ky < 3; ++ky)
          for (int kx = 0; kx < 3; ++kx)
            for (int ci = 0; ci < 3; ++ci) {
              const float x = Conv<T>::from(
                  lvl[(ci * LH + 2 * pr + dy + ky) * LW + 2 * pc + dx + kx]);
              const float* w = wts + OW1 + ((ky * 3 + kx) * 3 + ci) * 10;
              for (int o = 0; o < 10; ++o) acc[o] = fmaf(w[o], x, acc[o]);
            }
        for (int o = 0; o < 10; ++o)
          m[o] = fmaxf(m[o], prelu(acc[o] + wts[OB1 + o], wts[OA1 + o]));
      }
    }
    // a pool position with no valid conv1 input lies outside the level's
    // pool1 map and feeds only outputs that are never written
    for (int o = 0; o < 10; ++o)
      p1[(o * P1H + pr) * P1W + pc] = Conv<T>::to(any ? m[o] : 0.0f);
  }
  __syncthreads();

  // stage 3: conv2 + PReLU -> c2 tile; each work item is one position and
  // one half (8) of the 16 output channels
  for (int i = threadIdx.x; i < 2 * C2H * C2W; i += NTHREADS) {
    const int half = i / (C2H * C2W), j = i % (C2H * C2W);
    const int r = j / C2W, c = j % C2W;
    float acc[8];
    for (int o = 0; o < 8; ++o) acc[o] = 0.0f;
    for (int ky = 0; ky < 3; ++ky)
      for (int kx = 0; kx < 3; ++kx)
        for (int ci = 0; ci < 10; ++ci) {
          const float x = Conv<T>::from(p1[(ci * P1H + r + ky) * P1W + c + kx]);
          const float* w = wts + OW2 + ((ky * 3 + kx) * 10 + ci) * 16 + half * 8;
          for (int o = 0; o < 8; ++o) acc[o] = fmaf(w[o], x, acc[o]);
        }
    for (int o = 0; o < 8; ++o) {
      const int oc = half * 8 + o;
      c2[(oc * C2H + r) * C2W + c] =
          Conv<T>::to(prelu(acc[o] + wts[OB2 + oc], wts[OA2 + oc]));
    }
  }
  __syncthreads();

  // stage 4: conv3 + PReLU + heads, one output position per thread
  const int r = threadIdx.x / TW, c = threadIdx.x % TW;
  float acc[32];
  for (int o = 0; o < 32; ++o) acc[o] = 0.0f;
  for (int ky = 0; ky < 3; ++ky)
    for (int kx = 0; kx < 3; ++kx)
      for (int ci = 0; ci < 16; ++ci) {
        const float x = Conv<T>::from(c2[(ci * C2H + r + ky) * C2W + c + kx]);
        const float* w = wts + OW3 + ((ky * 3 + kx) * 16 + ci) * 32;
        for (int o = 0; o < 32; ++o) acc[o] = fmaf(w[o], x, acc[o]);
      }
  float hv[6];
  for (int o = 0; o < 6; ++o) hv[o] = 0.0f;
  for (int ci = 0; ci < 32; ++ci) {
    const float v = Conv<T>::from(
        Conv<T>::to(prelu(acc[ci] + wts[OB3 + ci], wts[OA3 + ci])));
    for (int o = 0; o < 6; ++o) hv[o] = fmaf(wts[OWH + ci * 6 + o], v, hv[o]);
  }
  const int oy = oy0 + r, ox = ox0 + c;
  if (oy < PH && ox < PW) {
    for (int o = 0; o < 4; ++o)
      reg[(((size_t)b * 4 + o) * PH + oy) * PW + ox] =
          Conv<T>::to(hv[o] + wts[OBH + o]);
    const float d = (hv[5] + wts[OBH + 5]) - (hv[4] + wts[OBH + 4]);
    prob[((size_t)b * PH + oy) * PW + ox] = 1.0f / (1.0f + expf(-d));
  }
}

template <typename T>
int launch(const void* frames, int B, int H, int W, int SH, int SW,
                  void* pooled, const void* weights, void* reg, void* prob,
                  cudaStream_t s) {
  const int PH = (SH - 1) / 2 - 4, PW = (SW - 1) / 2 - 4;
  if (pooled != nullptr) {
    int G = 1;
    while (G < 32 && G < (W + SW - 1) / SW + 1) G *= 2;
    const long long threads = (long long)B * SH * SW * G;
    pool_level_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        (const uint8_t*)frames, B, H, W, SH, SW, G, (T*)pooled);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((PW + TW - 1) / TW, (PH + TH - 1) / TH, B);
  pnet_level_kernel<T><<<grid, NTHREADS, 0, s>>>(
      (const uint8_t*)frames, H, W, SH, SW, (const T*)pooled,
      (const float*)weights, (T*)reg, (float*)prob);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pnet_weight_count() { return NWEIGHTS; }

// frames: uint8 [B, H, W, 3] BGR; pooled: NULL for a level whose pool
// windows are at most 2 wide (pooled inside the kernel), else scratch T
// [B, 3, SH, SW] for the pre-pool; weights: float32 [NWEIGHTS]; reg: T
// [B, 4, PH, PW]; prob: float32 [B, PH, PW]; bf16 != 0 selects T = bf16.
// Returns the first failing launch's cudaGetLastError(), else 0.
extern "C" int pnet_level_launch(const void* frames, int B, int H, int W,
                                 int SH, int SW, void* pooled,
                                 const void* weights, void* reg, void* prob,
                                 int bf16, void* stream) {
  const int PH = (SH - 1) / 2 - 4, PW = (SW - 1) / 2 - 4;
  if (B <= 0 || PH <= 0 || PW <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(frames, B, H, W, SH, SW, pooled, weights, reg, prob, s);
  return launch<float>(frames, B, H, W, SH, SW, pooled, weights, reg, prob, s);
}
