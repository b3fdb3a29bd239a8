// Fused 3-D soft-argmax forward and backward for Hopper (sm_90a), plain C
// interface.
//
// Forward: replaces horopose_tpu/ops/integral_pallas.py::_fwd_kernel. For
// each of the BK cells of a (BK, D, H, W) logit volume, in float32:
//   m = max x,  e = exp(x - m),  s = sum e,
//   E_w, E_h, E_d = sum(e * idx_axis) / s,  uvd = E / dim - 0.5.
// The normalised tensor is never written. E and (m, s) are kept for the
// backward.
//
// Forward bound: the read of the logits, BK * D*H*W * sizeof(x) bytes. At
// the serving shape (7 cells of 64^3 per image, bf16) that is 3.7 MB per
// image, about 0.14 ms at b=128 at 3.35 TB/s. About 8 float32 operations
// per logit stay below the card's rate for them, so bytes bound it, as
// long as the kernel spends few instructions on each logit.
//
// Forward design: a grid of (cells, splits). Each split is a contiguous run
// of whole W-rows of one cell, so that even b=1 (7 cells) spreads over
// hundreds of blocks; the wrapper picks the split count. Inside a block the
// threads form rows_per_pass x tpr: tpr threads share a row, each taking
// 16-byte vectors (8 bf16 or 4 float32 logits) at stride tpr along it, so a
// warp reads whole rows, contiguous in memory. A thread's w comes from its
// vector's column; its (d, h) advance by a constant once per row, so no
// division is spent on a logit. Each thread keeps an online (m, s, s_w,
// s_h, s_d): per vector one max over its logits and at most one rescale,
// then one ex2.approx.ftz of (x - m) * log2 e per logit; s_h and s_d take
// the vector's sum once. Loads of kUnroll rows are issued before any is used. A block merge
// (warp shuffles, then shared memory) writes the split's partial tuple to
// a (cells, splits, 5) float32 scratch; a second small kernel merges each
// cell's splits (one warp a cell) and writes uvd, E and (m, s). The merge
// rescales by exp(m_part - m), so a split whose logits are all -inf (m =
// -FLT_MAX, s = 0) merges as a no-op. A base pointer that is not 16-byte
// aligned, or a row whose bytes are not a multiple of 16, takes the same
// kernel with one logit per "vector".
//
// Backward: replaces horopose_tpu/ops/integral_pallas.py::_bwd_kernel, the
// closed-form gradient of uvd with respect to the logits:
//   dx = exp(x - m) / s * (g_w/W (w - E_w) + g_h/H (h - E_h) + g_d/D (d - E_d))
// written in the logits' dtype, with float32 arithmetic. The Pallas kernel
// re-reduced each cell in VMEM to find m and s; this one reads the (m, s)
// the forward saved, so it is one elementwise pass.
//
// Backward bound: one read of x and one write of dx, BK * D*H*W * 2 *
// sizeof(x) bytes: 469.8 MB in bf16 at the training shape (64 images, 7
// cells of 64^3), 0.140 ms at 3.35 TB/s; 0.280 ms in float32. About 12
// float32 operations per logit stay far below the card's rate, so bytes
// bound it.
//
// Backward design, simple first: a 2-D grid, blockIdx.y the cell and
// blockIdx.x a fixed chunk of kChunk logits within it, so that even b=1
// runs hundreds of blocks. Each block loads its cell's (m, s, E, g) once;
// each thread handles kChunk / 256 logits at stride 256 (coalesced), and
// finds (d, h, w) by integer division. 16-byte loads and a row-wise index
// walk are left for later.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// logits per block in the backward: 8 per thread
constexpr int kChunk = 8 * kThreads;
// -FLT_MAX rather than -inf as the empty max: exp(-FLT_MAX - m) is 0 for
// any real m and exp(0) is 1 when both sides are empty, so no NaN appears
// from (-inf) - (-inf).
constexpr float kEmpty = -FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
// rows whose loads a thread of the forward has in flight at once
constexpr int kUnroll = 4;

struct Acc {
  float m, s, sw, sh, sd;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ Acc merge(const Acc& a, const Acc& b) {
  const float m = fmaxf(a.m, b.m);
  const float ca = expf(a.m - m);
  const float cb = expf(b.m - m);
  return {m, a.s * ca + b.s * cb, a.sw * ca + b.sw * cb,
          a.sh * ca + b.sh * cb, a.sd * ca + b.sd * cb};
}

__device__ __forceinline__ Acc shfl_xor(const Acc& a, int offset) {
  return {__shfl_xor_sync(0xffffffffu, a.m, offset),
          __shfl_xor_sync(0xffffffffu, a.s, offset),
          __shfl_xor_sync(0xffffffffu, a.sw, offset),
          __shfl_xor_sync(0xffffffffu, a.sh, offset),
          __shfl_xor_sync(0xffffffffu, a.sd, offset)};
}

__device__ __forceinline__ Acc warp_merge(Acc a) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) a = merge(a, shfl_xor(a, offset));
  return a;
}

// logits per 16-byte vector
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// n logits from p into v, as float32; one 16-byte load when n is the
// vector width (p then 16-byte aligned), else n scalar loads
template <int N>
__device__ __forceinline__ void load_logits(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_logits(const __nv_bfloat16* p,
                                            float (&v)[N]) {
  if constexpr (N == 8) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float32
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __bfloat162float(p[i]);
  }
}

// 2^x, flushing a result below 2^-126 to 0 (one MUFU.EX2; exp2f adds
// range scaling for subnormal results)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Fold one vector of N logits at columns w0 .. w0 + N - 1 of row (d, h)
// into a: one max, at most one rescale, one exp2 per logit.
template <int N>
__device__ __forceinline__ void fold(Acc& a, const float (&v)[N], float w0,
                                     float fh, float fd) {
  float vm = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i) vm = fmaxf(vm, v[i]);
  if (vm > a.m) {
    const float c = exp2_ftz((a.m - vm) * kLog2e);
    a.s *= c;
    a.sw *= c;
    a.sh *= c;
    a.sd *= c;
    a.m = vm;
  }
  float s = 0.f, si = 0.f;  // sum of e, and of e * i
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = exp2_ftz((v[i] - a.m) * kLog2e);
    s += e;
    si = fmaf(e, static_cast<float>(i), si);
  }
  a.s += s;
  a.sw += fmaf(s, w0, si);
  a.sh = fmaf(s, fh, a.sh);
  a.sd = fmaf(s, fd, a.sd);
}

// Block (cell, split) folds rows [split * rows_per_split, + rows_per_split)
// of its cell; N logits a vector (W a multiple of N when N > 1); tpr
// threads a row, a power of two. Writes the split's (m, s, s_w, s_h, s_d).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
soft_argmax_3d_fwd_kernel(const T* __restrict__ x, int D, int H, int W,
                          int rows_per_split, int tpr,
                          float* __restrict__ partial) {
  const int rows = D * H;
  const int row0 = blockIdx.y * rows_per_split;
  const int row1 = min(row0 + rows_per_split, rows);
  const int vpr = W / N;  // vectors a row
  const int tx = threadIdx.x & (tpr - 1);
  const int ty = threadIdx.x / tpr;
  const int rpp = kThreads / tpr;  // rows a pass
  const int dd = rpp / H;          // (d, h) step between a thread's rows
  const int dh = rpp - dd * H;
  const T* cell = x + static_cast<size_t>(blockIdx.x) * rows * W;

  Acc a = {kEmpty, 0.f, 0.f, 0.f, 0.f};
  for (int c = tx; c < vpr; c += tpr) {
    const float w0 = static_cast<float>(c * N);
    int r = row0 + ty;
    int d = r / H;
    int h = r - d * H;
    for (; r < row1; r += kUnroll * rpp) {
      float v[kUnroll][N];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (r + k * rpp < row1)
          load_logits(cell + static_cast<size_t>(r + k * rpp) * W + c * N,
                      v[k]);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (r + k * rpp < row1)
          fold(a, v[k], w0, static_cast<float>(h), static_cast<float>(d));
        h += dh;
        d += dd;
        if (h >= H) {
          h -= H;
          ++d;
        }
      }
    }
  }

  __shared__ Acc part[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_merge(a);
  if (lane == 0) part[warp] = a;
  __syncthreads();
  if (warp != 0) return;
  a = lane < kWarps ? part[lane] : Acc{kEmpty, 0.f, 0.f, 0.f, 0.f};
  a = warp_merge(a);
  if (lane == 0) {
    float* out = partial +
        5 * (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y);
    out[0] = a.m;
    out[1] = a.s;
    out[2] = a.sw;
    out[3] = a.sh;
    out[4] = a.sd;
  }
}

// One warp a cell: merge its `splits` partial tuples, write uvd, E and the
// cell's (m, s).
__global__ void __launch_bounds__(kThreads)
soft_argmax_3d_merge_kernel(const float* __restrict__ partial, long long bk,
                            int splits, int D, int H, int W,
                            float* __restrict__ uvd, float* __restrict__ ex,
                            float* __restrict__ stats) {
  const long long cell =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (cell >= bk) return;  // the whole warp leaves together
  Acc a = {kEmpty, 0.f, 0.f, 0.f, 0.f};
  for (int i = lane; i < splits; i += 32) {
    const float* p = partial + 5 * (cell * splits + i);
    a = merge(a, Acc{p[0], p[1], p[2], p[3], p[4]});
  }
  a = warp_merge(a);
  if (lane == 0) {
    const float inv_s = 1.f / a.s;
    const float e_w = a.sw * inv_s;
    const float e_h = a.sh * inv_s;
    const float e_d = a.sd * inv_s;
    stats[2 * cell] = a.m;  // the cell's max and sum, for the backward
    stats[2 * cell + 1] = a.s;
    ex[3 * cell] = e_w;
    ex[3 * cell + 1] = e_h;
    ex[3 * cell + 2] = e_d;
    uvd[3 * cell] = e_w / W - 0.5f;
    uvd[3 * cell + 1] = e_h / H - 0.5f;
    uvd[3 * cell + 2] = e_d / D - 0.5f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
soft_argmax_3d_bwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ ex,
                          const float* __restrict__ stats,
                          const float* __restrict__ g, int D, int H, int W,
                          T* __restrict__ dx) {
  const int hw = H * W;
  const int n = D * hw;
  const size_t cell = blockIdx.y;
  const int begin = blockIdx.x * kChunk;
  const int end = min(begin + kChunk, n);
  const float m = stats[2 * cell];
  // 1/s is inf for a cell of all -inf logits, whose softmax is undefined:
  // dx is then NaN there, as in the plain version. A -inf logit in any
  // other cell has exp(-inf - m) = 0 and gets dx = 0.
  const float inv_s = 1.f / stats[2 * cell + 1];
  const float e_w = ex[3 * cell], e_h = ex[3 * cell + 1],
              e_d = ex[3 * cell + 2];
  const float g_w = g[3 * cell] / W, g_h = g[3 * cell + 1] / H,
              g_d = g[3 * cell + 2] / D;
  const T* xc = x + cell * n;
  T* dxc = dx + cell * n;
  for (int i = begin + threadIdx.x; i < end; i += kThreads) {
    const int d = i / hw;
    const int r = i - d * hw;
    const int h = r / W;
    const int w = r - h * W;
    const float p = expf(to_float(xc[i]) - m) * inv_s;
    const float dev = g_w * (static_cast<float>(w) - e_w) +
                      g_h * (static_cast<float>(h) - e_h) +
                      g_d * (static_cast<float>(d) - e_d);
    store(dxc + i, p * dev);
  }
}

}  // namespace

template <typename T, int N>
static cudaError_t launch_fwd(const void* x, int bk, int D, int H, int W,
                              int splits, int rows_per_split, float* partial,
                              cudaStream_t s) {
  int tpr = 1;  // threads a row: a power of two covering the row's vectors
  while (tpr < W / N && tpr < kThreads) tpr <<= 1;
  soft_argmax_3d_fwd_kernel<T, N><<<dim3(bk, splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), D, H, W, rows_per_split, tpr, partial);
  return cudaGetLastError();
}

// x: (bk, D, H, W) contiguous, float32 (is_bf16 = 0) or bfloat16 (1);
// vec = 1 takes 16-byte loads, and then x must be 16-byte aligned and a row
// of W logits a multiple of 16 bytes. splits * rows_per_split covers the
// D*H rows of a cell, splits at most 65535; partial: (bk, splits, 5)
// float32 scratch. uvd, ex: (bk, 3) float32; stats: (bk, 2) float32, each
// cell's (m, s). Launches two kernels on `stream` of `device` and returns
// the first CUDA error (0 when both launches were accepted).
extern "C" int soft_argmax_3d_fwd(const void* x, int is_bf16, int vec, int bk,
                                  int D, int H, int W, int splits,
                                  int rows_per_split, float* partial,
                                  float* uvd, float* ex, float* stats,
                                  void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = vec ? launch_fwd<__nv_bfloat16, kVec<__nv_bfloat16>>(
                    x, bk, D, H, W, splits, rows_per_split, partial, s)
              : launch_fwd<__nv_bfloat16, 1>(x, bk, D, H, W, splits,
                                             rows_per_split, partial, s);
  } else {
    err = vec ? launch_fwd<float, kVec<float>>(x, bk, D, H, W, splits,
                                               rows_per_split, partial, s)
              : launch_fwd<float, 1>(x, bk, D, H, W, splits, rows_per_split,
                                     partial, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(bk) + kWarps - 1) / kWarps;
  soft_argmax_3d_merge_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(partial, bk, splits, D, H, W, uvd, ex,
                                     stats);
  return static_cast<int>(cudaGetLastError());
}

// x, dx: (bk, D, H, W) contiguous, both float32 (is_bf16 = 0) or both
// bfloat16 (1). ex, g: (bk, 3) and stats: (bk, 2), float32, contiguous.
// bk must be at most 65535 (the grid's y limit). Launches on `stream` of
// `device` and returns cudaGetLastError().
extern "C" int soft_argmax_3d_bwd(const void* x, int is_bf16, int bk, int D,
                                  int H, int W, const float* ex,
                                  const float* stats, const float* g,
                                  void* dx, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = D * H * W;
  const dim3 grid((n + kChunk - 1) / kChunk, bk);
  if (is_bf16) {
    soft_argmax_3d_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ex, stats, g, D, H, W,
        static_cast<__nv_bfloat16*>(dx));
  } else {
    soft_argmax_3d_bwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), ex, stats, g, D, H, W,
        static_cast<float*>(dx));
  }
  return static_cast<int>(cudaGetLastError());
}
