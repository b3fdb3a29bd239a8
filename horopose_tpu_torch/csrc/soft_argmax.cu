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
// image, about 0.14 ms at b=128 at 3.35 TB/s. The ~11 float32 operations
// per element stay below the card's rate for them, so bytes bound it.
//
// Forward design, simple first: one block of 256 threads per cell. Each
// thread strides over the cell keeping an online (m, s, s_w, s_h, s_d) and
// rescales its sums by exp(m_old - m_new) when its max rises. A block
// reduction (warp shuffles, then shared memory across the 8 warps) merges
// the per-thread tuples with the same rescaling. All accumulation is in
// float32. At b=1 only 7 blocks run on 132 SMs; splitting a cell over
// several blocks and 16-byte loads are left for later.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
soft_argmax_3d_fwd_kernel(const T* __restrict__ x, int D, int H, int W,
                          float* __restrict__ uvd, float* __restrict__ ex,
                          float* __restrict__ stats) {
  const int hw = H * W;
  const int n = D * hw;
  const T* cell = x + static_cast<size_t>(blockIdx.x) * n;

  Acc a = {kEmpty, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float v = to_float(cell[i]);
    const int d = i / hw;
    const int r = i - d * hw;
    const int h = r / W;
    const float fw = static_cast<float>(r - h * W);
    const float fh = static_cast<float>(h);
    const float fd = static_cast<float>(d);
    if (v > a.m) {  // new max: rescale what was summed so far
      const float c = expf(a.m - v);
      a.s = a.s * c + 1.f;
      a.sw = a.sw * c + fw;
      a.sh = a.sh * c + fh;
      a.sd = a.sd * c + fd;
      a.m = v;
    } else {
      const float e = expf(v - a.m);
      a.s += e;
      a.sw += e * fw;
      a.sh += e * fh;
      a.sd += e * fd;
    }
  }

  __shared__ Acc partial[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_merge(a);
  if (lane == 0) partial[warp] = a;
  __syncthreads();
  if (warp != 0) return;
  a = lane < kWarps ? partial[lane] : Acc{kEmpty, 0.f, 0.f, 0.f, 0.f};
  a = warp_merge(a);
  if (lane == 0) {
    const float inv_s = 1.f / a.s;
    const float e_w = a.sw * inv_s;
    const float e_h = a.sh * inv_s;
    const float e_d = a.sd * inv_s;
    float* e_out = ex + 3 * static_cast<size_t>(blockIdx.x);
    float* u_out = uvd + 3 * static_cast<size_t>(blockIdx.x);
    float* st_out = stats + 2 * static_cast<size_t>(blockIdx.x);
    st_out[0] = a.m;  // the block-merged max and sum, for the backward
    st_out[1] = a.s;
    e_out[0] = e_w;
    e_out[1] = e_h;
    e_out[2] = e_d;
    u_out[0] = e_w / W - 0.5f;
    u_out[1] = e_h / H - 0.5f;
    u_out[2] = e_d / D - 0.5f;
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

// x: (bk, D, H, W) contiguous, float32 (is_bf16 = 0) or bfloat16 (1).
// uvd, ex: (bk, 3) float32; stats: (bk, 2) float32, each cell's (m, s).
// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int soft_argmax_3d_fwd(const void* x, int is_bf16, int bk, int D,
                                  int H, int W, float* uvd, float* ex,
                                  float* stats, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    soft_argmax_3d_fwd_kernel<__nv_bfloat16><<<bk, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), D, H, W, uvd, ex, stats);
  } else {
    soft_argmax_3d_fwd_kernel<float><<<bk, kThreads, 0, s>>>(
        static_cast<const float*>(x), D, H, W, uvd, ex, stats);
  }
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
