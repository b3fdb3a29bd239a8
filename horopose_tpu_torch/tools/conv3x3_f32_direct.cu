// The earlier float32 3x3 conv kernel, kept as the baseline of
// tools/conv_variants.py: a direct kernel on the float32 units, one block of
// 256 threads per 8x16 tile of output pixels of one image and per 32 output
// channels. For each chunk of 16 input channels the block stages the
// (8+2) x (16+2) input patch, its halo zero-filled at the image border, and
// the chunk's 9 x 16 x 32 weights in shared memory with plain loads between
// two __syncthreads. Each thread accumulates 4 pixels (along a row) x 4
// channels: per tap and input channel, one 16-byte weight load, 4 input
// loads and 16 FMAs.
//
// The same C interface as csrc/conv3x3.cu's conv3x3_nhwc, float32 only
// (is_bf16 must be 0; `blocks` is not read). CONV_F32_SKIP 1 leaves out the
// products and 2 the staging of every chunk after the first, so that each
// half is timed alone; their outputs are wrong.

#include <cuda_runtime.h>

#ifndef CONV_F32_SKIP
#define CONV_F32_SKIP 0
#endif

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

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ w,
               int H, int W, int C, int F, int tiles_w,
               float* __restrict__ y) {
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
  const float* xb = x + static_cast<size_t>(b) * H * W * C;

  float acc[kPix][kFPer];
#pragma unroll
  for (int i = 0; i < kPix; ++i)
#pragma unroll
    for (int j = 0; j < kFPer; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCB) {
    __syncthreads();  // every thread is done with the previous chunk
    if (CONV_F32_SKIP != 2 || c0 == 0) {
      for (int i = threadIdx.x; i < kPatchH * kPatchW * kCB; i += kThreads) {
        const int c = i % kCB;
        const int p = i / kCB;
        const int gy = ty0 - 1 + p / kPatchW;
        const int gx = tx0 - 1 + p % kPatchW;
        const int gc = c0 + c;
        float v = 0.f;
        if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
          v = xb[(static_cast<size_t>(gy) * W + gx) * C + gc];
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
          v = w[(static_cast<size_t>(tap) * C + gc) * F + gf];
        wts[i] = v;
      }
    }
    __syncthreads();
    if (CONV_F32_SKIP == 1) {  // read the staged chunk, so it stays staged
      acc[0][0] += patch[threadIdx.x] + wts[threadIdx.x];
      continue;
    }

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
    float* out = y + ((static_cast<size_t>(b) * H + oy) * W + ox) * F + f;
#pragma unroll
    for (int j = 0; j < kFPer; ++j)
      if (f + j < F) out[j] = acc[i][j];
  }
}

}  // namespace

extern "C" int conv3x3_nhwc(const void* x, const void* w, int is_bf16, int B,
                            int H, int W, int C, int F, int blocks, void* y,
                            void* stream, int device) {
  (void)blocks;
  if (is_bf16 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const int tiles_h = (H + kTileH - 1) / kTileH;
  const dim3 grid(tiles_h * tiles_w, (F + kFB - 1) / kFB, B);
  conv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), H, W, C, F,
      tiles_w, static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}
