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
// cells of 64^3), 0.140 ms at 3.35 TB/s; 0.280 ms in float32. Bytes bound
// it as long as each logit costs few instructions: the card runs about
// 30 T thread-instructions a second, so ~14 a logit take 0.055 ms at that
// shape. A first design that found (d, h, w) by two runtime integer
// divisions a logit and moved 2-byte scalars spent ~60 and ran at 42% of
// the bound in bf16.
//
// Backward design: the forward's grid and walk. Blocks (cell, split) on
// (blockIdx.x, blockIdx.y), each split a run of whole W-rows of one cell
// (the wrapper's `plan_splits`), so b=1 fills the card and the cell count
// has no 65535 cap. tpr threads share a row, each taking 16-byte vectors
// (8 bf16 or 4 float32 logits) at stride tpr along it; loads of
// kBwdUnroll = 8 rows are started before any is used, twice the forward's
// depth, as a thread here also holds its results until it stores them. A
// thread's w comes from its vector's column, so its column terms
// g_w/W (w - E_w) are computed once a column; (d, h) advance by a constant
// once a row, and the row term g_h/H (h - E_h) + g_d/D (d - E_d) is
// computed once a row. A logit then costs a convert, x - m, expf, x 1/s, one add of its
// column term to the row term and one multiply; dx goes back as one
// 16-byte store a vector, bf16 pairs packed with round-to-nearest. expf
// (not ex2.approx of (x - m) * log2 e, whose rounded product costs ~1e-6
// relative at |x - m| ~ 33) keeps the card check's 2e-6 bound. A base
// pointer of x or dx that is not 16-byte aligned, or a row whose bytes are
// not a multiple of 16, takes the same kernel with one logit a "vector".

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// -FLT_MAX rather than -inf as the empty max: exp(-FLT_MAX - m) is 0 for
// any real m and exp(0) is 1 when both sides are empty, so no NaN appears
// from (-inf) - (-inf).
constexpr float kEmpty = -FLT_MAX;
constexpr float kLog2e = 1.4426950408889634f;
// rows whose loads a thread of the forward has in flight at once
constexpr int kUnroll = 4;
// ... of the backward, which holds its loads and results in registers
constexpr int kBwdUnroll = 8;

struct Acc {
  float m, s, sw, sh, sd;
};

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

// n float32 values into p in T, rounded to nearest; one 16-byte store when
// n is the vector width (p then 16-byte aligned), else n scalar stores
template <int N>
__device__ __forceinline__ void store_values(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

template <int N>
__device__ __forceinline__ void store_values(__nv_bfloat16* p,
                                             const float (&v)[N]) {
  if constexpr (N == 8) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// Block (cell, split) writes dx over rows [split * rows_per_split,
// + rows_per_split) of its cell, walking them as the forward does: N
// logits a vector (W a multiple of N when N > 1), tpr threads a row.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
soft_argmax_3d_bwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ ex,
                          const float* __restrict__ stats,
                          const float* __restrict__ g, int D, int H, int W,
                          int rows_per_split, int tpr, T* __restrict__ dx) {
  const int rows = D * H;
  const int row0 = blockIdx.y * rows_per_split;
  const int row1 = min(row0 + rows_per_split, rows);
  const int vpr = W / N;  // vectors a row
  const int tx = threadIdx.x & (tpr - 1);
  const int ty = threadIdx.x / tpr;
  const int rpp = kThreads / tpr;  // rows a pass
  const int dd = rpp / H;          // (d, h) step between a thread's rows
  const int dh = rpp - dd * H;
  const size_t cell = blockIdx.x;
  const float m = stats[2 * cell];
  // 1/s is inf for a cell of all -inf logits, whose softmax is undefined:
  // dx is then NaN there, as in the plain version. A -inf logit in any
  // other cell has exp(-inf - m) = 0 and gets dx = 0.
  const float inv_s = 1.f / stats[2 * cell + 1];
  const float e_w = ex[3 * cell], e_h = ex[3 * cell + 1],
              e_d = ex[3 * cell + 2];
  const float g_w = g[3 * cell] / W, g_h = g[3 * cell + 1] / H,
              g_d = g[3 * cell + 2] / D;
  const T* xc = x + cell * rows * W;
  T* dxc = dx + cell * rows * W;

  for (int c = tx; c < vpr; c += tpr) {
    float tw[N];  // the column terms g_w/W (w - E_w), fixed along a column
#pragma unroll
    for (int i = 0; i < N; ++i)
      tw[i] = g_w * (static_cast<float>(c * N + i) - e_w);
    int r = row0 + ty;
    int d = r / H;
    int h = r - d * H;
    for (; r < row1; r += kBwdUnroll * rpp) {
      float v[kBwdUnroll][N];
#pragma unroll
      for (int k = 0; k < kBwdUnroll; ++k)
        if (r + k * rpp < row1)
          load_logits(xc + static_cast<size_t>(r + k * rpp) * W + c * N,
                      v[k]);
#pragma unroll
      for (int k = 0; k < kBwdUnroll; ++k) {
        if (r + k * rpp < row1) {
          // the row term g_h/H (h - E_h) + g_d/D (d - E_d), once a row
          const float tr = g_h * (static_cast<float>(h) - e_h) +
                           g_d * (static_cast<float>(d) - e_d);
          float o[N];
#pragma unroll
          for (int i = 0; i < N; ++i)
            o[i] = expf(v[k][i] - m) * inv_s * (tw[i] + tr);
          store_values(dxc + static_cast<size_t>(r + k * rpp) * W + c * N, o);
        }
        h += dh;
        d += dd;
        if (h >= H) {
          h -= H;
          ++d;
        }
      }
    }
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

template <typename T, int N>
static cudaError_t launch_bwd(const void* x, int bk, int D, int H, int W,
                              int splits, int rows_per_split, const float* ex,
                              const float* stats, const float* g, void* dx,
                              cudaStream_t s) {
  int tpr = 1;  // threads a row: a power of two covering the row's vectors
  while (tpr < W / N && tpr < kThreads) tpr <<= 1;
  soft_argmax_3d_bwd_kernel<T, N><<<dim3(bk, splits), kThreads, 0, s>>>(
      static_cast<const T*>(x), ex, stats, g, D, H, W, rows_per_split, tpr,
      static_cast<T*>(dx));
  return cudaGetLastError();
}

// x, dx: (bk, D, H, W) contiguous, both float32 (is_bf16 = 0) or both
// bfloat16 (1); vec = 1 takes 16-byte loads and stores, and then x and dx
// must be 16-byte aligned and a row of W logits a multiple of 16 bytes.
// splits * rows_per_split covers the D*H rows of a cell, splits at most
// 65535. ex, g: (bk, 3) and stats: (bk, 2), float32, contiguous. Launches
// on `stream` of `device` and returns cudaGetLastError().
extern "C" int soft_argmax_3d_bwd(const void* x, int is_bf16, int vec, int bk,
                                  int D, int H, int W, int splits,
                                  int rows_per_split, const float* ex,
                                  const float* stats, const float* g,
                                  void* dx, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    err = vec ? launch_bwd<__nv_bfloat16, kVec<__nv_bfloat16>>(
                    x, bk, D, H, W, splits, rows_per_split, ex, stats, g, dx,
                    s)
              : launch_bwd<__nv_bfloat16, 1>(x, bk, D, H, W, splits,
                                             rows_per_split, ex, stats, g, dx,
                                             s);
  } else {
    err = vec ? launch_bwd<float, kVec<float>>(x, bk, D, H, W, splits,
                                               rows_per_split, ex, stats, g,
                                               dx, s)
              : launch_bwd<float, 1>(x, bk, D, H, W, splits, rows_per_split,
                                     ex, stats, g, dx, s);
  }
  return static_cast<int>(err);
}
