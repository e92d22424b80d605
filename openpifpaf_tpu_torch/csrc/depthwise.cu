// Stride-1 'SAME' KxK depthwise convolution + bias + optional ReLU or leaky
// ReLU (slope 0.01) on NHWC activations, i.e. the memory of a channels_last
// NCHW PyTorch tensor; or, in its VALID mode, the conv alone (no bias, no
// activation) of an input whose halo is data: (H + K - 1, W + K - 1) pixels
// in, (H, W) out.
//
// Replaces two Pallas TPU kernels:
// - openpifpaf_tpu/models/dw_pallas.py::_dw_kernel (driven by
//   depthwise_conv), the 'SAME' mode. The TPU kernel zero-pads the
//   activation to (8, 128)-aligned row tiles, reads each tile's halo through
//   a second block view and loops over the images of a batch; none of that
//   carries over.
// - tools/mosaic_lab.py::dw_kernel, the VALID mode: the Mosaic lab's 5x5
//   depthwise conv of a pre-haloed input. The staged tile's origin is the
//   output tile's origin in the input, and nothing is zero-filled for the
//   conv (a staged pixel that an output reads lies inside the input).
//
// What bounds it on the H100: bytes. At K=5 it does 25 multiply-adds per
// element, far below the card's ratio of operations to HBM bytes, so its
// floor is one read and one write of the activation. A kernel that loads
// each tap from global memory, one thread per output, is bound by load
// instructions instead: 50 scalar loads per output. The design cuts the
// instructions per output:
// - A CTA owns one image's channel group (at most 32 channel vectors) and a
//   spatial tile. It stages the tile's haloed input in shared memory with
//   cp.async (zero-filled outside the image, which is the 'SAME' conv's
//   padding), each copy as wide as one channel vector.
// - The vector width VEC is the widest that the pixel stride allows: 16
//   bytes (float4, 8 bf16) where C * sizeof(T) is a multiple of 16, else 8,
//   4 or one channel (odd C). k16's stage 2 (C = 174) gets 2 channels.
// - Each thread keeps its channels' K*K weights and bias in registers (in
//   float32; in the storage type for 8-channel vectors, converted exactly at
//   use), and computes a strip of R = 8 output rows (4 for 8-channel
//   vectors) at one column. The rows are dilation apart, so the taps of all
//   R outputs read one sliding window of R + K - 1 input rows, and each
//   staged value is read from shared memory once per thread and used for up
//   to K outputs (60 shared loads per 8 outputs at K=5, against 25 global
//   loads per output).
// - Index arithmetic is per thread, not per element: no div/mod in the
//   loops.
// The launch plan (vector width, channel groups, tile) is chosen per call in
// Python (models/dw_cuda.py::plan) from (N, H, W, C, K, dilation, type) so
// that the grid fills the card's 132 SMs; the kernel checks it.
//
// Storage is float32 or bfloat16 (the weights and bias in the same type as
// the activation); the sum is taken in float32 in both, tap by tap in
// ascending (ky, kx) order by fused multiply-adds from zero, bias last (none
// in the VALID mode), and the output is rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// output rows per thread: 8, or 4 for 8-channel vectors, whose taps and
// sums would not fit the registers at 8
__host__ __device__ constexpr int strip_rows(int vec) {
  return vec == 8 ? 4 : 8;
}
constexpr int MAX_THREADS = 256;
constexpr int MAX_NV = 32;     // channel vectors per CTA

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// act: 0 none, 1 ReLU, 2 leaky ReLU with slope 0.01
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return fmaxf(v, 0.f);
  if (act == 2) return v > 0.f ? v : v * 0.01f;
  return v;
}

// VEC consecutive channels, moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// one channel vector from global to shared memory; zeros where !inside
template <int BYTES>
__device__ __forceinline__ void stage(void* dst, const void* src,
                                      bool inside) {
  if constexpr (BYTES >= 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(inside ? BYTES : 0));
  } else {
    *static_cast<uint16_t*>(dst) =
        inside ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

struct Plan {
  int vec, nv, groups, tw, strips, threads;
  size_t smem;
};

// VALID: the input is (height + 2 halo, width + 2 halo) pixels, its halo
// data; no bias is read and no activation applied
template <typename T, int VEC, int K, bool VALID>
__global__ void __launch_bounds__(MAX_THREADS) depthwise_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ out, int height, int width, int channels, int dilation,
    int act, int nv, int tw, int strips) {
  using V = Vec<T, VEC>;
  constexpr int R = strip_rows(VEC);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* tile = reinterpret_cast<V*>(smem_raw);  // [sh][sw][nv]

  const int d = dilation;
  const int halo = (K - 1) / 2 * d;
  const int th = strips * R;
  const int sh = th + 2 * halo, sw = tw + 2 * halo;
  const int tiles_x = (width + tw - 1) / tw;
  const int y0 = (blockIdx.x / tiles_x) * th;
  const int x0 = (blockIdx.x % tiles_x) * tw;
  const int vec0 = blockIdx.y * nv;  // first channel vector of the group
  const int nvec = channels / VEC;
  const int64_t image = (int64_t)blockIdx.z * height * width;
  const int tid = threadIdx.x;

  // stage the haloed tile: element e = (row * sw + col) * nv + v
  {
    int v = tid % nv, pix = tid / nv;
    const int step = blockDim.x / nv, n_pix = sh * sw;
    int row = pix / sw, col = pix % sw;
    const int col_step = step % sw, row_step = step / sw;
    for (; pix < n_pix; pix += step) {
      if constexpr (VALID) {
        // the input is (height + 2 halo, width + 2 halo) pixels, and the
        // tile starts at the output tile's origin in it
        const int in_h = height + 2 * halo, in_w = width + 2 * halo;
        const int gy = y0 + row, gx = x0 + col;
        const bool inside = gy < in_h && gx < in_w && vec0 + v < nvec;
        const T* src =
            inside ? x + ((int64_t)blockIdx.z * in_h * in_w +
                          (int64_t)gy * in_w + gx) * channels +
                         (int64_t)(vec0 + v) * VEC
                   : x;
        stage<sizeof(V)>(&tile[pix * nv + v], src, inside);
      } else {
        const int gy = y0 - halo + row, gx = x0 - halo + col;
        const bool inside = gy >= 0 && gy < height && gx >= 0 &&
                            gx < width && vec0 + v < nvec;
        const T* src = inside ? x + (image + (int64_t)gy * width + gx) *
                                        channels + (int64_t)(vec0 + v) * VEC
                              : x;
        stage<sizeof(V)>(&tile[pix * nv + v], src, inside);
      }
      col += col_step;
      row += row_step;
      if (col >= sw) {
        col -= sw;
        ++row;
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
  __syncthreads();

  const int v = tid % nv;
  const int col = (tid / nv) % tw;
  const int q = tid / (nv * tw);
  if (vec0 + v >= nvec || q >= strips) return;
  const int c = (vec0 + v) * VEC;

  // the channels' taps and bias, in registers: as float32, or for
  // 8-channel vectors in the storage type (converted exactly at use), whose
  // float32 taps would not fit
  using W = typename std::conditional<VEC == 8, T, float>::type;
  W wr[K * K][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
#pragma unroll
    for (int t = 0; t < K * K; ++t)
      wr[t][e] = w[(int64_t)(c + e) * K * K + t];
  float bias[VEC];
  if constexpr (!VALID) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) bias[e] = to_float(b[c + e]);
  }

  // this strip's rows are d apart: tile rows rbase + r * d
  const int rbase = (q / d) * R * d + q % d;
  float acc[R][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

  const V* base = tile + ((int64_t)rbase * sw + col) * nv + v;
  const int row_stride = d * sw * nv, col_stride = d * nv;
#pragma unroll
  for (int j = 0; j < R + K - 1; ++j) {
#pragma unroll
    for (int kx = 0; kx < K; ++kx) {
      const V in = base[j * row_stride + kx * col_stride];
      float xf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) xf[e] = to_float(in.v[e]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ky = j - r;  // output r's tap row reading input row j
        if (ky >= 0 && ky < K) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][e] =
                fmaf(xf[e], to_float(wr[ky * K + kx][e]), acc[r][e]);
        }
      }
    }
  }

  const int ox = x0 + col;
  if (ox >= width) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int oy = y0 + rbase + r * d;
    if (oy >= height) continue;
    V o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      // no bias in the VALID mode, and act 0: through activate() all the
      // same, or its float32 kernels take ~60% more registers
      if constexpr (VALID)
        o.v[e] = from_float<T>(activate(acc[r][e], act));
      else
        o.v[e] = from_float<T>(activate(acc[r][e] + bias[e], act));
    }
    *reinterpret_cast<V*>(out + (image + (int64_t)oy * width + ox) *
                                    channels + c) = o;
  }
}

template <typename T, int VEC, int K, bool VALID>
int launch_k(const Plan& p, const void* x, const void* w, const void* b,
             void* out, int batch, int height, int width, int channels,
             int dilation, int act, cudaStream_t stream) {
  auto kernel = depthwise_kernel<T, VEC, K, VALID>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const int th = p.strips * strip_rows(VEC);
  const int tiles = ((height + th - 1) / th) * ((width + p.tw - 1) / p.tw);
  kernel<<<dim3(tiles, p.groups, batch), p.threads, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), height, width,
      channels, dilation, act, p.nv, p.tw, p.strips);
  return (int)cudaGetLastError();
}

template <typename T, int VEC, bool VALID>
int by_k(const Plan& p, const void* x, const void* w, const void* b,
         void* out, int batch, int height, int width, int channels, int k,
         int dilation, int act, cudaStream_t s) {
  switch (k) {
    case 3: return launch_k<T, VEC, 3, VALID>(p, x, w, b, out, batch, height,
                                              width, channels, dilation, act,
                                              s);
    case 5: return launch_k<T, VEC, 5, VALID>(p, x, w, b, out, batch, height,
                                              width, channels, dilation, act,
                                              s);
    case 7: return launch_k<T, VEC, 7, VALID>(p, x, w, b, out, batch, height,
                                              width, channels, dilation, act,
                                              s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool VALID>
int launch(const Plan& p, const void* x, const void* w, const void* b,
           void* out, int batch, int height, int width, int channels, int k,
           int dilation, int act, cudaStream_t s) {
  if ((int64_t)batch * height * width * channels == 0) return 0;
  const int halo = (k - 1) / 2 * dilation;
  const int th = p.strips * strip_rows(p.vec);
  const int64_t tiles =
      (int64_t)((height + th - 1) / th) * ((width + p.tw - 1) / p.tw);
  // the plan must cover the channels and the rows' dilation phases, and
  // fit one CTA
  if (dilation < 1 || p.strips % dilation || channels % p.vec ||
      (int64_t)p.nv * p.groups * p.vec < channels || p.nv > MAX_NV ||
      p.threads != p.nv * p.tw * p.strips || p.threads > MAX_THREADS ||
      tiles >= ((int64_t)1 << 31) || p.groups > 65535 || batch > 65535 ||
      p.smem != (size_t)(th + 2 * halo) * (p.tw + 2 * halo) * p.nv * p.vec *
                    sizeof(T) ||
      p.smem > 227 * 1024 || (VALID && act != 0))
    return (int)cudaErrorInvalidValue;
  switch (p.vec) {
    case 1: return by_k<T, 1, VALID>(p, x, w, b, out, batch, height, width,
                                     channels, k, dilation, act, s);
    case 2: return by_k<T, 2, VALID>(p, x, w, b, out, batch, height, width,
                                     channels, k, dilation, act, s);
    case 4: return by_k<T, 4, VALID>(p, x, w, b, out, batch, height, width,
                                     channels, k, dilation, act, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return by_k<T, 8, VALID>(p, x, w, b, out, batch, height, width,
                                 channels, k, dilation, act, s);
      [[fallthrough]];
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool VALID>
int by_dtype(int dtype, const Plan& p, const void* x, const void* w,
             const void* b, void* out, int batch, int height, int width,
             int channels, int k, int dilation, int act, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, VALID>(p, x, w, b, out, batch, height, width,
                                channels, k, dilation, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, VALID>(p, x, w, b, out, batch, height,
                                        width, channels, k, dilation, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. valid 0 ('SAME'): x and out (batch, height,
// width, channels), b (channels,); valid 1: x (batch, height + 2 halo,
// width + 2 halo, channels) with halo = (k - 1) / 2 * dilation, out (batch,
// height, width, channels), b unused (may be null) and act 0. w (channels,
// k, k); every tensor contiguous and of the dtype; k 3, 5 or 7. The plan
// (models/dw_cuda.py::plan, for the output's size): vec channels per vector
// (x and out aligned to it), nv vectors per CTA in groups channel groups,
// tiles of tw columns by strips * 8 rows (strips a multiple of dilation),
// threads = nv * tw * strips, smem its shared bytes. A plan that does not
// cover the tensor or fit a CTA is refused. Returns the CUDA error of the
// launch (0 on success).
extern "C" int depthwise_conv(int dtype, int valid, const void* x,
                              const void* w, const void* b, void* out,
                              int batch, int height, int width, int channels,
                              int k, int dilation, int act, int vec, int nv,
                              int groups, int tw, int strips, int threads,
                              int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p{vec, nv, groups, tw, strips, threads, (size_t)smem};
  if (valid == 0)
    return by_dtype<false>(dtype, p, x, w, b, out, batch, height, width,
                           channels, k, dilation, act, s);
  if (valid == 1)
    return by_dtype<true>(dtype, p, x, w, b, out, batch, height, width,
                          channels, k, dilation, act, s);
  return (int)cudaErrorInvalidValue;
}
