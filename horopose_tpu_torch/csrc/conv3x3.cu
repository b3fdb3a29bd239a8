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
// float32: FFMA on the float32 units, no tensor cores (TF32 would not
// keep float32's accuracy), so the 0.144 ms of the FFMA rate bound it;
// what counts is the share of instruction slots that are FFMAs and how
// much of the staging hides behind them. The same tiles as bfloat16
// (kFRows = 8 output rows of kFCols = 64 pixels, kFN = 32 output channels)
// on a persistent grid of two blocks an SM, 128 threads a block. A warp takes
// two output rows; a thread holds a register tile of 2 rows x 8 pixels x 8
// output channels, 128 float32 accumulators (255 registers in all). For
// each input channel it loads its 72 weights (18 16-byte loads from a
// [tap][c][f] slab), then for each of the 4 input rows its rows touch, the
// 10 values of its row segment once, and applies every (ky, kx) tap that
// row feeds to them from registers: 58 shared loads feed 1152 FMAs. For
// each chunk of kFK = 8 input channels the block copies the tile's 10 x 66
// patch as 16-byte channel quads (cp.async; a zero-size source fills the
// SAME padding and the channels past C) and the chunk's weights into a
// ring of kFStages = 3 slots (33 KB each); one barrier a step, then the
// copies of the step two ahead, within a tile or into the next one, are
// started before the step's products. Each patch row of quads is padded by
// one quad every 8 pixels, so the loads of a warp's 8 pixel groups fall on
// distinct banks. Any C and F: a chunk past C or F computes on zeros and
// stores nothing there; C not a multiple of 4 (or x off 16 bytes) stages
// the patch with 4-byte copies, F not a multiple of 4 (or w, y off 16
// bytes) the weights, and y is then stored as scalars.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

// ---- float32: register tiles on the float32 units ----

// Build-time variants for tools/conv_variants.py: the staging ring's depth,
// and CONV_F32_SKIP 1 (leave out the products) or 2 (leave out the copies
// after the first steps) to time each half alone.
#ifndef CONV_F32_STAGES
#define CONV_F32_STAGES 3
#endif
#ifndef CONV_F32_SKIP
#define CONV_F32_SKIP 0
#endif
constexpr int kFStages = CONV_F32_STAGES;  // staged chunks in the ring
constexpr int kFRows = 8;        // output rows a tile
constexpr int kFCols = 64;       // output columns a tile
constexpr int kFN = 32;          // output channels a tile
constexpr int kFK = 8;           // input channels a staged chunk
constexpr int kFQ = kFK / 4;     // channel quads a chunk
constexpr int kFRpt = 2;         // output rows a thread (and a warp)
constexpr int kFPix = 8;         // pixels a thread, along each of its rows
constexpr int kFCpt = 8;         // output channels a thread
constexpr int kFThreads = 32 * kFRows / kFRpt;
constexpr int kFHaloH = kFRows + 2;
constexpr int kFHaloW = kFCols + 2;
// a patch row of channel quads (16 bytes): pixel p at p + p / 8, so that
// the loads of a warp's 8 pixel groups, 9 quads apart, fall on 8 banks
constexpr int kFRowQ = kFHaloW + kFHaloW / 8;
constexpr int kFPatch = kFQ * kFHaloH * kFRowQ * 4;  // [quad][row][pixel][4]
constexpr int kFWts = 9 * kFK * kFN;                 // [tap][c][f]
constexpr int kFStage = kFPatch + kFWts;             // floats a ring slot
constexpr int kFSmem = kFStages * kFStage * 4;
static_assert(kFCols == 8 * kFPix && kFN == 4 * kFCpt && kFCpt == 8,
              "a warp: 8 pixel groups of 8 columns x 4 channel groups of 8");
static_assert(kFStage % 4 == 0, "16-byte aligned ring slots");

// 4 bytes from gmem to smem; a src_bytes of 0 writes zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

struct FTile {
  int f0, b, oy0, ox0, c0;
};

// Step s of this block: its (s / nC)-th tile (tiles blockIdx.x, +
// gridDim.x, ...), input chunk s % nC. Tiles run output-chunk major, then
// image, row tile, column tile.
__device__ __forceinline__ FTile f32_step_tile(int s, int nC, int B,
                                               int tiles_h, int tiles_w) {
  const int t = blockIdx.x + (s / nC) * gridDim.x;
  const int per_f = B * tiles_h * tiles_w;
  const int r = t % per_f;
  const int rt = r % (tiles_h * tiles_w);
  return {(t / per_f) * kFN, r / (tiles_h * tiles_w), (rt / tiles_w) * kFRows,
          (rt % tiles_w) * kFCols, (s % nC) * kFK};
}

__global__ void __launch_bounds__(kFThreads, 2)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int B, int H, int W, int C, int F, int tiles_h,
                   int tiles_w, int n_tiles, int fast_in, int fast_w,
                   int fast_out, float* __restrict__ y) {
  extern __shared__ __align__(16) float fsmem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int pg = lane >> 2;    // pixel group: columns pg * 8 .. + 7
  const int fg = lane & 3;     // channels fg * 4 .. + 3 and 16 + fg * 4 .. + 3
  const int nC = (C + kFK - 1) / kFK;
  const int my_tiles = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_steps = my_tiles * nC;

  // Copy step s's patch (kFHaloH x kFHaloW pixels x kFK channels, zeros
  // outside the image and past C) and weights (9 x kFK x kFN, zeros past C
  // or F) into ring slot s % kFStages.
  auto stage = [&](int s) {
    const FTile t = f32_step_tile(s, nC, B, tiles_h, tiles_w);
    float* patch = fsmem + (s % kFStages) * kFStage;
    float* wts = patch + kFPatch;
    const float* xb = x + static_cast<size_t>(t.b) * H * W * C;
    if (fast_in) {  // C a multiple of 4 and x 16-byte aligned: quads
      for (int i = tid; i < kFQ * kFHaloH * kFHaloW; i += kFThreads) {
        const int q = i % kFQ;
        const int p = i / kFQ;
        const int pr = p / kFHaloW;
        const int pc = p - pr * kFHaloW;
        const int gy = t.oy0 - 1 + pr;
        const int gx = t.ox0 - 1 + pc;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W &&
                        t.c0 + 4 * q < C;
        const float* src =
            ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + t.c0 + 4 * q
               : x;
        cp_async16(patch + ((q * kFHaloH + pr) * kFRowQ + pc + pc / 8) * 4,
                   src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kFK * kFHaloH * kFHaloW; i += kFThreads) {
        const int c = i % kFK;
        const int p = i / kFK;
        const int pr = p / kFHaloW;
        const int pc = p - pr * kFHaloW;
        const int gy = t.oy0 - 1 + pr;
        const int gx = t.ox0 - 1 + pc;
        const bool ok =
            gy >= 0 && gy < H && gx >= 0 && gx < W && t.c0 + c < C;
        const float* src =
            ok ? xb + (static_cast<size_t>(gy) * W + gx) * C + t.c0 + c : x;
        cp_async4(patch + (((c / 4) * kFHaloH + pr) * kFRowQ + pc + pc / 8) *
                              4 + c % 4,
                  src, ok ? 4 : 0);
      }
    }
    if (fast_w) {  // F a multiple of 4 and w 16-byte aligned
      for (int i = tid; i < 9 * kFK * (kFN / 4); i += kFThreads) {
        const int f = (i % (kFN / 4)) * 4;
        const int ck = (i / (kFN / 4)) % kFK;
        const int tap = i / (kFK * (kFN / 4));
        const bool ok = t.c0 + ck < C && t.f0 + f < F;
        const float* src =
            ok ? w + (static_cast<size_t>(tap) * C + t.c0 + ck) * F + t.f0 + f
               : w;
        cp_async16(wts + (tap * kFK + ck) * kFN + f, src, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < kFWts; i += kFThreads) {
        const int f = i % kFN;
        const int ck = (i / kFN) % kFK;
        const int tap = i / (kFK * kFN);
        const bool ok = t.c0 + ck < C && t.f0 + f < F;
        const float* src =
            ok ? w + (static_cast<size_t>(tap) * C + t.c0 + ck) * F + t.f0 + f
               : w;
        cp_async4(wts + i, src, ok ? 4 : 0);
      }
    }
  };

  float acc[kFRpt][kFPix][kFCpt];  // [row][pixel][fg * 4 + j, 16 + fg * 4 + j]
  for (int s = 0; s < kFStages - 1; ++s) {  // one commit group a step
    if (s < n_steps) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < n_steps; ++s) {
    const FTile t = f32_step_tile(s, nC, B, tiles_h, tiles_w);
    cp_async_wait<kFStages - 2>();
    // step s's copies are in place, and every warp is done with step s - 1,
    // whose ring slot the next copies overwrite
    __syncthreads();
    if (s + kFStages - 1 < n_steps && CONV_F32_SKIP != 2)
      stage(s + kFStages - 1);
    cp_async_commit();  // maybe empty

    if (t.c0 == 0) {
#pragma unroll
      for (int o = 0; o < kFRpt; ++o)
#pragma unroll
        for (int i = 0; i < kFPix; ++i)
#pragma unroll
          for (int j = 0; j < kFCpt; ++j) acc[o][i][j] = 0.f;
    }
    const float* patch = fsmem + (s % kFStages) * kFStage;
    const float* prow = patch + (warp * kFRpt * kFRowQ + pg * (kFPix + 1)) * 4;
    const float* wcol = patch + kFPatch + fg * 4;
    if (CONV_F32_SKIP != 1) {
#pragma unroll 1
      for (int c = 0; c < kFK; ++c) {
        // the weights of channel c for the thread's output channels
        float wv[9][kFCpt];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int h = 0; h < kFCpt / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(
                wcol + (tap * kFK + c) * kFN + h * 16);
            wv[tap][4 * h] = v.x;
            wv[tap][4 * h + 1] = v.y;
            wv[tap][4 * h + 2] = v.z;
            wv[tap][4 * h + 3] = v.w;
          }
        const float* xc = prow + (c / 4) * kFHaloH * kFRowQ * 4 + c % 4;
#pragma unroll
        for (int r = 0; r < kFRpt + 2; ++r) {
          // input row r of the thread's rows: its 8 pixels and the two
          // beside them
          float xv[kFPix + 2];
#pragma unroll
          for (int i = 0; i < kFPix + 2; ++i)
            xv[i] = xc[(r * kFRowQ + i + i / kFPix) * 4];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const int o = r - ky;  // the output row this tap row feeds
            if (o < 0 || o >= kFRpt) continue;
#pragma unroll
            for (int kx = 0; kx < 3; ++kx)
#pragma unroll
              for (int i = 0; i < kFPix; ++i)
#pragma unroll
                for (int j = 0; j < kFCpt; ++j)
                  acc[o][i][j] = fmaf(xv[i + kx], wv[ky * 3 + kx][j],
                                      acc[o][i][j]);
          }
        }
      }
    }

    if (t.c0 + kFK >= C) {  // the tile's last chunk: write it back
#pragma unroll
      for (int o = 0; o < kFRpt; ++o) {
        const int oy = t.oy0 + warp * kFRpt + o;
        if (oy >= H) continue;
        float* yrow = y + (static_cast<size_t>(t.b) * H + oy) * W * F;
#pragma unroll
        for (int i = 0; i < kFPix; ++i) {
          const int ox = t.ox0 + pg * kFPix + i;
          if (ox >= W) continue;
          float* out = yrow + static_cast<size_t>(ox) * F + t.f0;
#pragma unroll
          for (int h = 0; h < kFCpt / 4; ++h) {
            const int f = h * 16 + fg * 4;
            if (fast_out) {  // F a multiple of 4, y 16-byte aligned
              if (t.f0 + f < F)
                *reinterpret_cast<float4*>(out + f) = make_float4(
                    acc[o][i][4 * h], acc[o][i][4 * h + 1],
                    acc[o][i][4 * h + 2], acc[o][i][4 * h + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (t.f0 + f + j < F) out[f + j] = acc[o][i][4 * h + j];
            }
          }
        }
      }
    }
  }
}

}  // namespace

// x: (B, H, W, C), w: (3, 3, C, F), y: (B, H, W, F), contiguous, all float32
// (is_bf16 = 0) or all bfloat16 (1). `blocks` persistent blocks, at most the
// number of tiles, B * ceil(H / 8) * ceil(W / 64) * ceil(F / 32), below
// 2^31. Launches on `stream` of `device` and returns cudaGetLastError() (0
// when the launch was accepted).
extern "C" int conv3x3_nhwc(const void* x, const void* w, int is_bf16, int B,
                            int H, int W, int C, int F, int blocks, void* y,
                            void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (is_bf16) {
    err = cudaFuncSetAttribute(conv3x3_bf16_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMmaSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_h = (H + kRows - 1) / kRows;
    const int tiles_w = (W + kCols - 1) / kCols;
    const int n_tiles = ((F + kN - 1) / kN) * B * tiles_h * tiles_w;
    conv3x3_bf16_mma_kernel<<<blocks, kMmaThreads, kMmaSmem, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), B, H, W, C,
        F, tiles_h, tiles_w, n_tiles, C % 8 == 0 && aligned(x),
        F % 8 == 0 && aligned(y), static_cast<bf16*>(y));
  } else {
    err = cudaFuncSetAttribute(conv3x3_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles_h = (H + kFRows - 1) / kFRows;
    const int tiles_w = (W + kFCols - 1) / kFCols;
    const int n_tiles = ((F + kFN - 1) / kFN) * B * tiles_h * tiles_w;
    conv3x3_f32_kernel<<<blocks, kFThreads, kFSmem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), B, H, W,
        C, F, tiles_h, tiles_w, n_tiles, C % 4 == 0 && aligned(x),
        F % 4 == 0 && aligned(w), F % 4 == 0 && aligned(y),
        static_cast<float*>(y));
  }
  return static_cast<int>(cudaGetLastError());
}
