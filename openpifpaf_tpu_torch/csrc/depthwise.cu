// Stride-1 'SAME' KxK depthwise convolution + bias + optional ReLU or leaky
// ReLU (slope 0.01) on NHWC activations, i.e. the memory of a channels_last
// NCHW PyTorch tensor.
//
// Replaces the Pallas TPU kernel
// openpifpaf_tpu/models/dw_pallas.py::_dw_kernel (driven by
// depthwise_conv). The TPU kernel zero-pads the activation to (8, 128)-
// aligned row tiles, reads each tile's halo through a second block view
// and loops over the images of a batch. None of that is needed here:
// one thread computes one output (n, y, x, c), consecutive threads take
// consecutive channels so every tap's load is coalesced, bounds checks stand
// in for the zero padding, and the batch lives in the grid.
//
// What bounds it on the H100: bytes, not operations. At K=5 it does 25
// multiply-adds per element, far below the card's ratio of operations to
// HBM bytes, so its floor is one read and one write of the activation;
// the taps' re-reads of a neighbour's input hit L1/L2.
//
// Storage is float32 or bfloat16 (the weights and bias in the same type as
// the activation); the sum is taken in float32 in both, and the output is
// rounded once. (The TPU kernel accumulates in the storage type, which under
// bf16 loses precision; this one does not.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T>
__global__ void __launch_bounds__(256) depthwise_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
    T* __restrict__ out, int height, int width, int channels, int k,
    int dilation, int act, int total) {
  const int halo = (k - 1) / 2 * dilation;
  // unsigned: i + the grid's stride stays below 2^32 for total < 2^31
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < (unsigned)total;
       u += gridDim.x * blockDim.x) {
    const int i = (int)u;
    const int c = i % channels;
    const int pixel = i / channels;
    const int ox = pixel % width;
    const int row = pixel / width;  // image * height + oy
    const int oy = row % height;
    const T* xc = x + (row - oy) * width * channels + c;  // image's origin
    const T* wc = w + c * k * k;
    float acc = 0.f;
    for (int ky = 0; ky < k; ++ky) {
      const int iy = oy - halo + ky * dilation;
      if (iy < 0 || iy >= height) continue;
      for (int kx = 0; kx < k; ++kx) {
        const int ix = ox - halo + kx * dilation;
        if (ix < 0 || ix >= width) continue;
        acc = fmaf(to_float(xc[(iy * width + ix) * channels]),
                   to_float(wc[ky * k + kx]), acc);
      }
    }
    out[i] = from_float<T>(activate(acc + to_float(b[c]), act));
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int batch,
           int height, int width, int channels, int k, int dilation, int act,
           cudaStream_t stream) {
  const int64_t total = (int64_t)batch * height * width * channels;
  if (total == 0) return 0;
  if (total >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // the grid-stride loop covers what a capped grid leaves
  if (blocks > (1 << 20)) blocks = 1 << 20;
  depthwise_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(out), height, width, channels,
      k, dilation, act, (int)total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x and out (batch, height, width, channels),
// w (channels, k, k), b (channels,), all contiguous and of that type, with
// fewer than 2^31 elements in x.
// Returns the CUDA error of the launch (0 on success).
extern "C" int depthwise_conv(int dtype, const void* x, const void* w,
                              const void* b, void* out, int batch, int height,
                              int width, int channels, int k, int dilation,
                              int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, out, batch, height, width, channels, k,
                         dilation, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, out, batch, height, width, channels,
                                 k, dilation, act, s);
  return (int)cudaErrorInvalidValue;
}
