// 3x3 stride-1 SAME convolution without bias, NHWC, for Hopper (sm_90a),
// plain C interface.
//
// Replaces horopose_tpu/ops/conv_pallas.py::_kernel (launched by
// conv3x3_s2d_pallas). y[b, i, j, f] = sum over (ky, kx, c) of
//   x[b, i + ky - 1, j + kx - 1, c] * w[ky, kx, c, f],
// x outside the image read as 0; x (B, H, W, C), w (3, 3, C, F) HWIO,
// y (B, H, W, F), all float32 or all bfloat16, float32 accumulation, y
// rounded once to its dtype.
//
// The Pallas kernel packed 2x2 output pixels into the lane dimension
// (space-to-depth) so that F = 32 output channels could fill the TPU's
// 128-lane MXU, at 16/9 the FLOPs. Nothing on Hopper asks for that, so this
// kernel computes the convolution directly (an implicit GEMM).
//
// Bound at the target shape (128, 64, 64, 32) -> 32 (HRNet branch 0): the
// input read once and the output written once, 67.1 MB in bf16, 0.020 ms at
// 3.35 TB/s; 2 * 9 * C * F operations a pixel, 9.66 GFLOP, 0.0098 ms at the
// bf16 tensor-core rate (989 TFLOP/s). In float32 the 67 TFLOP/s of the
// float32 units bound it: 0.144 ms.
//
// Design, simple first (no tensor cores, no TMA): one block of 256 threads
// per 8x16 tile of output pixels of one image and per 32 output channels.
// For each chunk of 16 input channels the block stages the (8+2) x (16+2)
// input patch, its halo zero-filled at the image border, and the chunk's
// 9 x 16 x 32 weights in shared memory as float32 (30.6 KB). Each thread
// accumulates 4 pixels (along a row) x 4 channels in float32 registers:
// per tap and input channel, one 16-byte weight load, 4 input loads and 16
// FMAs. The patch rows are padded to 17 floats per pixel, so the 4 pixel
// groups of a warp read 4 different banks. A chunk or a block that runs
// past C or F computes on zeros and stores nothing there, so any C and F
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;        // output rows per block
constexpr int kTileW = 16;       // output columns per block
constexpr int kCB = 16;          // input channels per staged chunk
constexpr int kFB = 32;          // output channels per block
constexpr int kPix = 4;          // pixels per thread, along a row
constexpr int kFPer = 4;         // output channels per thread
constexpr int kThreads = (kTileH * kTileW / kPix) * (kFB / kFPer);
constexpr int kPatchH = kTileH + 2;
constexpr int kPatchW = kTileW + 2;
constexpr int kCStride = kCB + 1;  // padded pixel stride in the patch
static_assert(kThreads == 256, "one warp = 4 pixel groups x 8 channel groups");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w, int H, int W,
               int C, int F, int tiles_w, T* __restrict__ y) {
  __shared__ float patch[kPatchH * kPatchW * kCStride];
  __shared__ __align__(16) float wts[9 * kCB * kFB];

  const int b = blockIdx.z;
  const int ty0 = (blockIdx.x / tiles_w) * kTileH;
  const int tx0 = (blockIdx.x % tiles_w) * kTileW;
  const int f0 = blockIdx.y * kFB;
  const int fg = threadIdx.x % (kFB / kFPer);      // channel group, 0..7
  const int pg = threadIdx.x / (kFB / kFPer);      // pixel group, 0..31
  const int row = pg / (kTileW / kPix);
  const int col0 = (pg % (kTileW / kPix)) * kPix;
  const T* xb = x + static_cast<size_t>(b) * H * W * C;

  float acc[kPix][kFPer];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < kFPer; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < kPatchH * kPatchW * kCB; i += kThreads) {
      const int c = i % kCB;
      const int p = i / kCB;
      const int gy = ty0 - 1 + p / kPatchW;
      const int gx = tx0 - 1 + p % kPatchW;
      const int gc = c0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        v = to_float(xb[(static_cast<size_t>(gy) * W + gx) * C + gc]);
      patch[p * kCStride + c] = v;
    }
    for (int i = threadIdx.x; i < 9 * kCB * kFB; i += kThreads) {
      const int f = i % kFB;
      const int c = (i / kFB) % kCB;
      const int tap = i / (kFB * kCB);
      const int gc = c0 + c;
      const int gf = f0 + f;
      float v = 0.f;
      if (gc < C && gf < F)
        v = to_float(w[(static_cast<size_t>(tap) * C + gc) * F + gf]);
      wts[i] = v;
    }
    __syncthreads();

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float* prow =
            patch + ((row + ky) * kPatchW + col0 + kx) * kCStride;
        const float* wtap = wts + (ky * 3 + kx) * kCB * kFB + fg * kFPer;
#pragma unroll
        for (int c = 0; c < kCB; ++c) {
          const float4 wv = *reinterpret_cast<const float4*>(wtap + c * kFB);
#pragma unroll
          for (int i = 0; i < kPix; ++i) {
            const float xv = prow[i * kCStride + c];
            acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
            acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
            acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
            acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
          }
        }
      }
    }
  }

  const int oy = ty0 + row;
  if (oy >= H) return;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int ox = tx0 + col0 + i;
    if (ox >= W) continue;
    const int f = f0 + fg * kFPer;
    T* out = y + ((static_cast<size_t>(b) * H + oy) * W + ox) * F + f;
#pragma unroll
    for (int j = 0; j < kFPer; ++j)
      if (f + j < F) store(out + j, acc[i][j]);
  }
}

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, F), y: (B, H, W, F), contiguous, all float32
// (is_bf16 = 0) or all bfloat16 (1). B at most 65535 (the grid's z limit).
// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int conv3x3_nhwc(const void* x, const void* w, int is_bf16, int B,
                            int H, int W, int C, int F, void* y, void* stream,
                            int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (F + kFB - 1) / kFB, B);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), H, W, C, F, tiles_w,
        static_cast<__nv_bfloat16*>(y));
  } else {
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), H, W, C,
        F, tiles_w, static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}
