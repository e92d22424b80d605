// The Mosaic lab's lane interleave on Hopper (sm_90a), timed alone at k16's
// stage geometries by openpifpaf_tpu_torch/lab/mosaic_lab.py. Activations
// are NHWC (the memory of a channels_last NCHW tensor); storage is float32
// or bfloat16.
//
// Replaces the Pallas TPU kernel tools/mosaic_lab.py::interleave_kernel:
// out[p, 2i] = a[p, i], out[p, 2i + 1] = b[p, i]. The TPU kernel goes
// through float32 because Mosaic inserts a minor dimension only for 32-bit
// types; here one thread moves one (a, b) pair as a single 2-element store,
// in any type. Bound by bytes: it reads a and b once and writes out once.
//
// The lab's two other kernels are modes of the backbone's kernels:
// dw_kernel the VALID mode of depthwise.cu, branch2_kernel the LAB mode of
// shuffle_block.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

constexpr int THREADS = 256;

// ------------------------------------------------------------- interleave

template <typename T>
__global__ void __launch_bounds__(THREADS) interleave_kernel(
    const T* __restrict__ a, const T* __restrict__ b,
    typename Pair<T>::type* __restrict__ out, unsigned total) {
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    typename Pair<T>::type v;
    v.x = a[i];
    v.y = b[i];
    out[i] = v;  // out[p, 2c], out[p, 2c + 1] with i = p * C + c
  }
}

// grid of a 1-d elementwise kernel over `total` items; the grid-stride loop
// covers what a capped grid leaves
unsigned elementwise_blocks(int64_t total) {
  int64_t blocks = (total + THREADS - 1) / THREADS;
  return (unsigned)(blocks > (1 << 20) ? (1 << 20) : blocks);
}

template <typename T>
int launch_interleave(const void* a, const void* b, void* out, int64_t total,
                      cudaStream_t stream) {
  interleave_kernel<T><<<elementwise_blocks(total), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<typename Pair<T>::type*>(out), (unsigned)total);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype 0 float32, 1 bfloat16; a, b (P, C) and out (P, 2C), contiguous,
// with P C < 2^31. The launch goes on `stream` and the CUDA error of the
// launch is returned (0 on success). Nothing synchronises.
extern "C" int lab_interleave(int dtype, const void* a, const void* b,
                              void* out, int pixels, int channels,
                              void* stream) {
  const int64_t total = (int64_t)pixels * channels;
  if (total == 0) return 0;
  if (total >= (int64_t)1 << 31) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_interleave<float>(a, b, out, total, s);
  if (dtype == 1) return launch_interleave<__nv_bfloat16>(a, b, out, total, s);
  return (int)cudaErrorInvalidValue;
}
