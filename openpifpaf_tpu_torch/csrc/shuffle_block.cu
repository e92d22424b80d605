// One BN-folded non-first ShuffleNetV2K block (InvertedResidualK) in one
// launch: with x = [x1 | x2] split on channels,
//
//   y1  = act(x2 . W1 + b1)                     1x1, kept in float32
//   z   = depthwise_KxK(y1) + bdw               rounded to the storage type
//   y3  = act(z . W3 + b3)
//   out = interleave(x1, y3)   out[2j] = x1[j], out[2j + 1] = y3[j]
//
// on NHWC activations (the memory of a channels_last NCHW tensor).
//
// Replaces two Pallas TPU kernels:
// - openpifpaf_tpu/models/shuffle_pallas.py::_block_kernel (INTERLEAVE=true):
//   the whole block, with the interleave that the TPU kernel folds into
//   one-hot scatter matmuls. Here it is an output index map, which copies
//   x1 exactly whatever its sign.
// - openpifpaf_tpu/models/block_pallas.py::_branch2_kernel
//   (INTERLEAVE=false): branch2 only, written as (N, H, W, Cb); the caller
//   interleaves.
// The TPU kernels pad the two channel halves to 128 lanes, keep them in
// separate halo-framed arrays and move rows with hand-made DMAs. Here the
// split is a pointer offset of Cb into the block's input, nothing is
// padded, and bounds checks stand in for the zero frame.
//
// Design: one CTA of 256 threads per (image, TH x TW output tile). y1 and z
// never go to HBM: the block reads x once (x2 with its halo, x1 once) and
// writes its output once, as the TPU kernel does.
// - y1 is computed on the tile plus its halo, (TH + 2h) x (TW + 2h) pixels,
//   CC output channels at a time, with x2 and W1 streamed through shared
//   memory CI input channels at a time; each thread holds RC channels of up
//   to 12 pixels in registers. Pixels outside the image get y1 = 0: the 1x1
//   of a padding pixel would give act(b1), not the depthwise conv's zero
//   padding.
// - The chunk's depthwise taps go into a shared z[TH * TW, Cb] buffer.
// - act(z . W3 + b3) is written, interleaved with x1 or alone; each thread
//   holds 4 pixels x RC channels.
// What bounds it on the H100: the two 1x1 products on CUDA cores in
// float32 (the halo makes the first one (TH + 2h)(TW + 2h) / (TH TW) times
// the useful work), fed from shared memory; and at stage 4 of a 513x641
// input the grid itself, 54 tiles for 132 SMs. Tensor cores (wgmma) and
// splitting a tile's channels over a thread-block cluster are the next
// steps.
//
// Storage is float32 or bfloat16 (weights in the activation's type); every
// sum is taken in float32, z is rounded to the storage type before the
// second 1x1 and the output is rounded once, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 4;           // output tile rows
constexpr int TW = 8;           // output tile columns
constexpr int TP = TH * TW;     // output pixels per CTA
constexpr int THREADS = 256;
constexpr int CI = 32;          // x2 input channels per shared-memory stage
constexpr int CC = 64;          // y1 / z channels per chunk
constexpr int RC = 4;           // channels per thread in both 1x1 products
constexpr int XS = CI + 1;      // padded row strides: two pixels of a warp
constexpr int YS = CC + 1;      // fall in different banks
constexpr int CO = 32 * RC;     // output channels per pass of the second 1x1
static_assert(CC == 16 * RC, "first 1x1: 16 channel lanes x RC channels");
static_assert(TP == 8 * 4, "second 1x1: 8 warps x 4 pixels");
static_assert(TP * CC == THREADS * 8, "depthwise: 8 outputs per thread");

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

// act: 1 ReLU, 2 leaky ReLU with slope 0.01
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 2) return v > 0.f ? v : v * 0.01f;
  return fmaxf(v, 0.f);
}

struct BlockArgs {
  const void* x;    // (N, H, W, 2 Cb)
  const void* w1;   // (Cb, Cb) [in, out]
  const void* b1;   // (Cb,)
  const void* wdw;  // (Cb, K, K)
  const void* bdw;  // (Cb,)
  const void* w3;   // (Cb, Cb) [in, out]
  const void* b3;   // (Cb,)
  void* out;        // (N, H, W, 2 Cb) interleaved, or (N, H, W, Cb)
  int height, width, cb, k, dilation, act;
};

template <int HALO>
__host__ __device__ constexpr int tile_pixels() {
  return (TH + 2 * HALO) * (TW + 2 * HALO);
}

template <int HALO>
size_t shared_bytes(int cb) {
  return sizeof(float) * ((size_t)tile_pixels<HALO>() * (XS + YS) +
                          (size_t)CI * CC + (size_t)TP * cb);
}

// Every sum runs over its input channels in ascending order, one fused
// multiply-add at a time from zero, and adds the bias last: the order of a
// plain loop (on the H100 it gives the same bits as cuDNN for these convs).
template <typename T, int HALO, bool INTERLEAVE>
__global__ void __launch_bounds__(THREADS) shuffle_block_kernel(BlockArgs a) {
  constexpr int PW = TW + 2 * HALO;
  constexpr int PIN = tile_pixels<HALO>();
  constexpr int NJ = (PIN + 15) / 16;  // halo pixels per thread, first 1x1

  extern __shared__ float smem[];
  float* xs = smem;              // [PIN][XS]  x2 stage
  float* ws = xs + PIN * XS;     // [CI][CC]   W1 stage
  float* ys = ws + CI * CC;      // [PIN][YS]  y1 chunk
  float* zs = ys + PIN * YS;     // [TP][Cb]   z

  const T* x = static_cast<const T*>(a.x);
  const T* w1 = static_cast<const T*>(a.w1);
  const T* b1 = static_cast<const T*>(a.b1);
  const T* wdw = static_cast<const T*>(a.wdw);
  const T* bdw = static_cast<const T*>(a.bdw);
  const T* w3 = static_cast<const T*>(a.w3);
  const T* b3 = static_cast<const T*>(a.b3);
  T* out = static_cast<T*>(a.out);

  const int height = a.height, width = a.width, cb = a.cb, k = a.k;
  const int d = a.dilation, act = a.act;
  const int c2 = 2 * cb;
  const int tiles_x = (width + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int64_t image_pixel0 = (int64_t)blockIdx.y * height * width;
  const int tid = threadIdx.x;

  for (int co0 = 0; co0 < cb; co0 += CC) {
    // y1[p, c] of the halo tile for c in [co0, co0 + CC): thread
    // (g, l) = (tid / 16, tid % 16) holds pixels g + 16 j of the chunk's
    // channels l + 16 q
    const int g = tid >> 4, l = tid & 15;
    float acc[NJ][RC];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[j][q] = 0.f;
    for (int ci0 = 0; ci0 < cb; ci0 += CI) {
      __syncthreads();  // the previous stage (and chunk) is consumed
      for (int e = tid; e < PIN * CI; e += THREADS) {
        const int p = e / CI, ci = ci0 + e % CI;
        const int gy = y0 - HALO + p / PW, gx = x0 - HALO + p % PW;
        float v = 0.f;
        if (gy >= 0 && gy < height && gx >= 0 && gx < width && ci < cb)
          v = to_float(x[(image_pixel0 + (int64_t)gy * width + gx) * c2 +
                         cb + ci]);
        xs[p * XS + e % CI] = v;
      }
      for (int e = tid; e < CI * CC; e += THREADS) {
        const int ci = ci0 + e / CC, c = co0 + e % CC;
        ws[e] = (ci < cb && c < cb) ? to_float(w1[(int64_t)ci * cb + c])
                                    : 0.f;
      }
      __syncthreads();
      const int n_ci = min(CI, cb - ci0);
      for (int ci = 0; ci < n_ci; ++ci) {
        float w[RC];
#pragma unroll
        for (int q = 0; q < RC; ++q) w[q] = ws[ci * CC + l + 16 * q];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int p = g + 16 * j;
          if (p < PIN) {
            const float v = xs[p * XS + ci];
#pragma unroll
            for (int q = 0; q < RC; ++q) acc[j][q] = fmaf(v, w[q], acc[j][q]);
          }
        }
      }
    }
    // bias and activation; y1 = 0 outside the image (the depthwise conv's
    // zero padding, which the 1x1 of a padding pixel would not give)
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int c = co0 + l + 16 * q;
      const float bias1 = c < cb ? to_float(b1[c]) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int p = g + 16 * j;
        if (p < PIN) {
          const int gy = y0 - HALO + p / PW, gx = x0 - HALO + p % PW;
          const bool inside =
              gy >= 0 && gy < height && gx >= 0 && gx < width && c < cb;
          ys[p * YS + l + 16 * q] =
              inside ? activate(acc[j][q] + bias1, act) : 0.f;
        }
      }
    }
    __syncthreads();

    // depthwise taps of this chunk into z, rounded to the storage type:
    // thread tid holds channel tid % CC of pixels tid / CC + 4 j
    const int c = tid % CC, co = co0 + c;
    if (co < cb) {
      const T* wc = wdw + (int64_t)co * k * k;
      const float bias_dw = to_float(bdw[co]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tid / CC + 4 * j;
        const int ty = p / TW, tx = p % TW;
        float z = 0.f;
        for (int ky = 0; ky < k; ++ky)
          for (int kx = 0; kx < k; ++kx)
            z = fmaf(ys[((ty + ky * d) * PW + tx + kx * d) * YS + c],
                     to_float(wc[ky * k + kx]), z);
        zs[p * cb + co] = to_float(from_float<T>(z + bias_dw));
      }
    }
  }
  __syncthreads();

  // y3 = act(z . W3 + b3), CO output channels per pass: warp g holds
  // pixels g + 8 j, lane l the channels c0 + l + 32 q
  const int g = tid >> 5, l = tid & 31;
  for (int c0 = 0; c0 < cb; c0 += CO) {
    float acc[4][RC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[j][q] = 0.f;
    for (int ci = 0; ci < cb; ++ci) {
      float w[RC], z[4];
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int c = c0 + l + 32 * q;
        w[q] = c < cb ? to_float(w3[(int64_t)ci * cb + c]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) z[j] = zs[(g + 8 * j) * cb + ci];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[j][q] = fmaf(z[j], w[q], acc[j][q]);
    }
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int co = c0 + l + 32 * q;
      if (co >= cb) continue;
      const float bias3 = to_float(b3[co]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = g + 8 * j;
        const int oy = y0 + p / TW, ox = x0 + p % TW;
        if (oy >= height || ox >= width) continue;  // ragged last tile
        const int64_t pixel = image_pixel0 + (int64_t)oy * width + ox;
        const T v = from_float<T>(activate(acc[j][q] + bias3, act));
        if (INTERLEAVE) {
          out[pixel * c2 + 2 * co] = x[pixel * c2 + co];
          out[pixel * c2 + 2 * co + 1] = v;
        } else {
          out[pixel * cb + co] = v;
        }
      }
    }
  }
}

template <typename T, int HALO, bool INTERLEAVE>
int launch(const BlockArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = shared_bytes<HALO>(a.cb);
  auto kernel = shuffle_block_kernel<T, HALO, INTERLEAVE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((a.height + TH - 1) / TH) * ((a.width + TW - 1) / TW);
  shuffle_block_kernel<T, HALO, INTERLEAVE>
      <<<dim3(tiles, batch), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool INTERLEAVE>
int by_halo(const BlockArgs& a, int batch, cudaStream_t stream) {
  switch ((a.k - 1) / 2 * a.dilation) {
    case 1: return launch<T, 1, INTERLEAVE>(a, batch, stream);
    case 2: return launch<T, 2, INTERLEAVE>(a, batch, stream);
    case 3: return launch<T, 3, INTERLEAVE>(a, batch, stream);
    case 4: return launch<T, 4, INTERLEAVE>(a, batch, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_mode(const BlockArgs& a, int interleave, int batch,
            cudaStream_t stream) {
  return interleave ? by_halo<T, true>(a, batch, stream)
                    : by_halo<T, false>(a, batch, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; interleave: 1 writes the whole block's
// (N, H, W, 2 Cb) output, 0 branch2's (N, H, W, Cb); act: 1 ReLU, 2 leaky.
// (k - 1) / 2 * dilation must be 1 to 4, and a CTA's shared memory,
// 4 bytes x ((TH + 2h)(TW + 2h)(XS + YS) + CI CC + TH TW Cb), at most the
// card's 227 KB, or the launch is refused. Returns the CUDA error of the
// launch (0 on success).
extern "C" int shuffle_block(int dtype, int interleave, const void* x,
                             const void* w1, const void* b1, const void* wdw,
                             const void* bdw, const void* w3, const void* b3,
                             void* out, int batch, int height, int width,
                             int cb, int k, int dilation, int act,
                             void* stream) {
  if (batch == 0 || height == 0 || width == 0) return 0;
  const BlockArgs a{x,   w1,     b1,    wdw, bdw, w3,       b3,
                    out, height, width, cb,  k,   dilation, act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return by_mode<float>(a, interleave, batch, s);
  if (dtype == 1) return by_mode<__nv_bfloat16>(a, interleave, batch, s);
  return (int)cudaErrorInvalidValue;
}
