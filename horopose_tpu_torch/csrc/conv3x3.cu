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
// bfloat16: an implicit GEMM on the tensor cores, M = output pixels, N = F,
// K = 9 * C in (ky, kx, c) order. A tile is kRows = 8 whole output rows of
// kCols = 64 pixels of one image and kN = 32 output channels; one warp
// takes one output row, four m16 x 32 accumulators of float32. For each
// chunk of kK = 32 input channels the block copies the tile's 10 x 66 halo
// into shared memory with 16-byte cp.async copies (a zero-size source
// fills the SAME padding and the channels past C with zeros), in a ring of
// kStages = 3 buffers: two tiles' copies are in flight while a third runs
// its products. The weights of a (channel chunk, output chunk) are staged
// once as [tap][f][c] and stay resident while the block walks its tiles (a
// persistent grid of one block an SM, 222 KB of shared memory), so at C, F
// <= 32 each block reads them once. Products are mma.sync m16n8k16 bf16 ->
// f32 with ldmatrix from pixel rows padded to 40 bf16 (80 bytes), so the 8
// rows of an 8x8 matrix fall on 8 distinct bank groups. mma.sync rather
// than wgmma: at 144 FLOP a byte this shape sits under the card's bf16
// ridge (295), so bytes bound it and the simpler instruction serves. What
// holds it back is the products: with N = 32 every A fragment (16 pixels x
// 16 channels, one ldmatrix) feeds only four mma, and each warp reloads the
// weights' B fragments, so shared memory and the mma pipe, not HBM, set
// the pace (tools/conv_variants.py times the kernel without its products
// and without its loads). The epilogue rounds each f32 sum once to bf16,
// stages a warp's 64 x 32 tile in shared memory and writes it back in
// 16-byte stores. Any C and F: a chunk past C or F computes on zeros and
// stores nothing; C not a multiple of 8 (or x off 16 bytes) stages the
// halo with scalar loads, F not a multiple of 8 stores scalars.
//
// float32: a direct kernel, no tensor cores (TF32 would not keep
// float32's accuracy): one block of 256 threads per 8x16 tile of output
// pixels of one image and per 32 output channels. For each chunk of 16
// input channels the block stages the (8+2) x (16+2) input patch, its halo
// zero-filled at the image border, and the chunk's 9 x 16 x 32 weights in
// shared memory (30.6 KB). Each thread accumulates 4 pixels (along a row) x
// 4 channels in float32 registers: per tap and input channel, one 16-byte
// weight load, 4 input loads and 16 FMAs. The patch rows are padded to 17
// floats per pixel, so the 4 pixel groups of a warp read 4 different
// banks. A chunk or a block that runs past C or F computes on zeros and
// stores nothing there, so any C and F work.

#include <cstdint>

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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---- bfloat16: implicit GEMM on the tensor cores ----

using bf16 = __nv_bfloat16;
// Build-time variants for tools/conv_variants.py: the tile's output rows,
// the halo ring's depth, and CONV_BF16_SKIP 1 (leave out the products) or
// 2 (leave out the halo copies after the first) to time each half alone.
#ifndef CONV_BF16_ROWS
#define CONV_BF16_ROWS 8
#endif
#ifndef CONV_BF16_STAGES
#define CONV_BF16_STAGES 3
#endif
#ifndef CONV_BF16_SKIP
#define CONV_BF16_SKIP 0
#endif
constexpr int kRows = CONV_BF16_ROWS;      // output rows a tile, one a warp
constexpr int kStages = CONV_BF16_STAGES;  // halo buffers in the ring
constexpr int kCols = 64;                // output columns a tile
constexpr int kMt = kCols / 16;          // m16 tiles a warp
constexpr int kN = 32;                   // output channels a tile
constexpr int kK = 32;                   // input channels a chunk
constexpr int kMmaThreads = 32 * kRows;
constexpr int kHaloH = kRows + 2;
constexpr int kHaloW = kCols + 2;
constexpr int kCS = kK + 8;              // padded pixel stride, bf16
constexpr int kHaloElems = kHaloH * kHaloW * kCS;
constexpr int kWElems = 9 * kN * kCS;    // [tap][f][c]
constexpr int kSS = kN + 8;              // padded epilogue row, bf16
constexpr int kStageElems = kRows * kCols * kSS;
constexpr int kMmaSmem =
    (kStages * kHaloElems + kWElems + kStageElems) * 2;
static_assert(kHaloElems % 8 == 0 && kWElems % 8 == 0,
              "16-byte aligned shared regions");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem to smem; a src_bytes of 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(const bf16* p, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Tile {
  int fc, b, oy0, ox0, cc;
};

// Step s of this block: its (s / nC)-th tile (tiles blockIdx.x, + gridDim.x,
// ...), channel chunk s % nC. Tiles run output-chunk major, then image,
// row tile, column tile.
__device__ __forceinline__ Tile step_tile(int s, int nC, int B, int tiles_h,
                                          int tiles_w) {
  const int t = blockIdx.x + (s / nC) * gridDim.x;
  const int per_f = B * tiles_h * tiles_w;
  const int r = t % per_f;
  const int rt = r % (tiles_h * tiles_w);
  return {t / per_f, r / (tiles_h * tiles_w), (rt / tiles_w) * kRows,
          (rt % tiles_w) * kCols, s % nC};
}

__global__ void __launch_bounds__(kMmaThreads)
conv3x3_bf16_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        int B, int H, int W, int C, int F, int tiles_h,
                        int tiles_w, int n_tiles, int fast_in, int fast_out,
                        bf16* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* halo = reinterpret_cast<bf16*>(smem);  // kStages buffers
  bf16* wts = halo + kStages * kHaloElems;
  bf16* stage = wts + kWElems;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nC = (C + kK - 1) / kK;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_steps = my_tiles * nC;
  const bf16 zero = __float2bfloat16(0.f);

  auto load_halo = [&](int s) {
    const Tile t = step_tile(s, nC, B, tiles_h, tiles_w);
    bf16* dst = halo + (s % kStages) * kHaloElems;
    const int c0 = t.cc * kK;
    const bf16* xb = x + static_cast<size_t>(t.b) * H * W * C;
    if (fast_in) {
      for (int i = tid; i < kHaloH * kHaloW * 4; i += kMmaThreads) {
        const int part = i & 3;
        const int p = i >> 2;
        const int gy = t.oy0 - 1 + p / kHaloW;
        const int gx = t.ox0 - 1 + p % kHaloW;
        const int c = c0 + part * 8;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c < C;
        const bf16* src =
            ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + c : x;
        cp_async16(dst + p * kCS + part * 8, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kHaloH * kHaloW * kK; i += kMmaThreads) {
        const int c = i % kK;
        const int p = i / kK;
        const int gy = t.oy0 - 1 + p / kHaloW;
        const int gx = t.ox0 - 1 + p % kHaloW;
        const bool ok =
            gy >= 0 && gy < H && gx >= 0 && gx < W && c0 + c < C;
        dst[p * kCS + c] =
            ok ? xb[(static_cast<size_t>(gy) * W + gx) * C + c0 + c] : zero;
      }
    }
  };

  // ldmatrix lane roles: A rows are pixels, B rows output channels
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8;

  float acc[kMt][4][4];  // [m16 tile along the row][n8 tile][fragment]
  int w_key = -1;
  for (int s = 0; s < kStages - 1; ++s) {  // one commit group a step
    if (s < n_steps) load_halo(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    const Tile t = step_tile(s, nC, B, tiles_h, tiles_w);
    if (s + kStages - 1 < n_steps && CONV_BF16_SKIP != 2)
      load_halo(s + kStages - 1);
    cp_async_commit();  // maybe empty
    const int key = t.fc * nC + t.cc;
    if (key != w_key) {  // every thread is past the last step's products
      const int c0 = t.cc * kK;
      const int f0 = t.fc * kN;
      for (int i = tid; i < 9 * kK * kN; i += kMmaThreads) {
        const int f = i % kN;
        const int c = (i / kN) % kK;
        const int tap = i / (kN * kK);
        const bool ok = c0 + c < C && f0 + f < F;
        wts[(tap * kN + f) * kCS + c] =
            ok ? w[(static_cast<size_t>(tap) * C + c0 + c) * F + f0 + f]
               : zero;
      }
      w_key = key;
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();  // this step's halo and the weights are in place

    if (t.cc == 0) {
#pragma unroll
      for (int j = 0; j < kMt; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[j][n][q] = 0.f;
    }
    const int c_valid = CONV_BF16_SKIP == 1 ? 0 : min(kK, C - t.cc * kK);
    const bf16* hb = halo + (s % kStages) * kHaloElems;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < kK; kk += 16) {
        if (kk >= c_valid) break;
        unsigned bfr[2][4];
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
          ldmatrix_x4(wts + (tap * kN + nh * 16 + b_n) * kCS + kk + b_k,
                      bfr[nh]);
#pragma unroll
        for (int j = 0; j < kMt; ++j) {
          unsigned afr[4];
          ldmatrix_x4(hb + ((warp + ky) * kHaloW + j * 16 + a_row + kx) *
                               kCS +
                          kk + a_k,
                      afr);
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[j][n], afr, bfr[n >> 1][(n & 1) * 2],
                     bfr[n >> 1][(n & 1) * 2 + 1]);
        }
      }
    }

    if (t.cc == nC - 1) {  // round once, stage the warp's row, store
      bf16* st = stage + warp * kCols * kSS;
#pragma unroll
      for (int j = 0; j < kMt; ++j)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int px = j * 16 + (lane >> 2);
          const int f = n * 8 + (lane & 3) * 2;
          *reinterpret_cast<__nv_bfloat162*>(st + px * kSS + f) =
              __floats2bfloat162_rn(acc[j][n][0], acc[j][n][1]);
          *reinterpret_cast<__nv_bfloat162*>(st + (px + 8) * kSS + f) =
              __floats2bfloat162_rn(acc[j][n][2], acc[j][n][3]);
        }
      __syncwarp();
      const int oy = t.oy0 + warp;
      const int f0 = t.fc * kN;
      if (oy < H) {
        bf16* yrow = y + (static_cast<size_t>(t.b) * H + oy) * W * F;
        if (fast_out) {
          for (int i = lane; i < kCols * (kN / 8); i += 32) {
            const int px = i / (kN / 8);
            const int f = (i % (kN / 8)) * 8;
            const int ox = t.ox0 + px;
            if (ox < W && f0 + f < F)
              *reinterpret_cast<uint4*>(yrow + static_cast<size_t>(ox) * F +
                                        f0 + f) =
                  *reinterpret_cast<const uint4*>(st + px * kSS + f);
          }
        } else {
          for (int i = lane; i < kCols * kN; i += 32) {
            const int px = i / kN;
            const int f = i % kN;
            const int ox = t.ox0 + px;
            if (ox < W && f0 + f < F)
              yrow[static_cast<size_t>(ox) * F + f0 + f] = st[px * kSS + f];
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with this step's halo buffer
  }
}

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, F), y: (B, H, W, F), contiguous, all float32
// (is_bf16 = 0) or all bfloat16 (1). float32: B at most 65535 (the grid's z
// limit). bfloat16: `blocks` persistent blocks (at most the number of
// tiles, B * ceil(H / kRows) * ceil(W / 64) * ceil(F / 32)). Launches on
// `stream` of `device` and returns cudaGetLastError() (0 when the launch
// was accepted).
extern "C" int conv3x3_nhwc(const void* x, const void* w, int is_bf16, int B,
                            int H, int W, int C, int F, int blocks, void* y,
                            void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = cudaFuncSetAttribute(conv3x3_bf16_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_h = (H + kRows - 1) / kRows;
    const int tiles_w = (W + kCols - 1) / kCols;
    const int n_tiles = ((F + kN - 1) / kN) * B * tiles_h * tiles_w;
    const auto aligned = [](const void* p) {
      return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    conv3x3_bf16_mma_kernel<<<blocks, kMmaThreads, kMmaSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), B, H, W, C,
        F, tiles_h, tiles_w, n_tiles, C % 8 == 0 && aligned(x),
        F % 8 == 0 && aligned(y), static_cast<bf16*>(y));
  } else {
    const int tiles_w = (W + kTileW - 1) / kTileW;
    const int tiles_h = (H + kTileH - 1) / kTileH;
    const dim3 grid(tiles_h * tiles_w, (F + kFB - 1) / kFB, B);
    conv3x3_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), H, W, C,
        F, tiles_w, static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}
