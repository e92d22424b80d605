// The Mosaic lab's three kernels on Hopper (sm_90a): the primitives of the
// fused-block design, timed alone at k16's stage geometries by
// openpifpaf_tpu_torch/lab/mosaic_lab.py. Activations are NHWC (the memory
// of a channels_last NCHW tensor); storage is float32 or bfloat16 and every
// sum is taken in float32.
//
// Replaces the Pallas TPU kernels of tools/mosaic_lab.py:
// - interleave_kernel -> lab_interleave: out[p, 2i] = a[p, i],
//   out[p, 2i + 1] = b[p, i]. The TPU kernel goes through float32 because
//   Mosaic inserts a minor dimension only for 32-bit types; here one thread
//   moves one (a, b) pair as a single 2-element store, in any type.
//   Bound by bytes: it reads a and b once and writes out once.
// - dw_kernel -> lab_dw_valid: VALID KxK depthwise conv of the pre-haloed
//   (H + K - 1, W + K - 1, C) input, no bias and no activation, as K^2
//   shifted multiply-adds. One thread per output, channels fastest, so
//   every tap's load is coalesced; the taps' re-reads of a neighbour's
//   input hit L1/L2. Bound by bytes (25 multiply-adds per output). The TPU
//   kernel multiplies and sums in the storage type; this one sums in
//   float32 and rounds once.
// - branch2_kernel -> lab_branch2: branch2 of a repeat block on an input
//   whose 2-pixel halo is real data (no zero mask, unlike shuffle_block.cu):
//     y1 = relu(x2 . W1 + b1)       float32, rounded to the storage type
//     z  = VALID dw(y1) + bd         float32 taps and bias, rounded
//     out = relu(z . W3 + b3)        rounded once
//   The TPU kernel walks a grid of row tiles in order and DMAs each tile's
//   haloed rows into VMEM by hand. Here every (r_tile x 8)-pixel tile is
//   its own CTA, which reads its haloed input straight from HBM; y1 and z
//   stay in shared memory. Both 1x1 products run on CUDA cores in float32
//   (register tiles of 4 channels x 8 pixels and 4 x 4), so the kernel is
//   bound by operations on CUDA cores, far from the bytes it moves; tensor
//   cores are the next step.

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

// the value of v rounded to the storage type, as a float
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

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

// ----------------------------------------------------------------- dw VALID

template <typename T>
__global__ void __launch_bounds__(THREADS) dw_valid_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int height, int width, int channels, int k, unsigned total) {
  const int win = width + k - 1, hin = height + k - 1;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += gridDim.x * blockDim.x) {
    const int i = (int)u;
    const int c = i % channels;
    const int pixel = i / channels;
    const int ox = pixel % width;
    const int row = pixel / width;  // image * height + oy
    const int oy = row % height;
    const int n = row / height;
    const T* xc = x + ((int64_t)(n * hin + oy) * win + ox) * channels + c;
    const T* wc = w + c * k * k;
    float acc = 0.f;
    for (int ky = 0; ky < k; ++ky)
      for (int kx = 0; kx < k; ++kx)
        acc = fmaf(to_float(xc[((int64_t)ky * win + kx) * channels]),
                   to_float(wc[ky * k + kx]), acc);
    out[i] = from_float<T>(acc);
  }
}

// ------------------------------------------------------------------ branch2

constexpr int TW = 8;         // output tile columns; rows are r_tile
constexpr int CI = 32;        // x2 input channels per shared-memory stage
constexpr int CC = 64;        // y1 / z channels per chunk
constexpr int RC = 4;         // channels per thread in both 1x1 products
constexpr int NJ = 8;         // pixels per thread in the first 1x1
constexpr int PG = 16 * NJ;   // haloed pixels per pass of the first 1x1
constexpr int XS = CI + 1;    // padded row strides: two pixels of a warp
constexpr int YS = CC + 1;    // fall in different banks
constexpr int CO = 32 * RC;   // output channels per pass of the second 1x1
constexpr int PO = 32;        // output pixels per pass of the second 1x1
static_assert(CC == 16 * RC, "first 1x1: 16 channel lanes x RC channels");
static_assert(PO == 8 * 4, "second 1x1: 8 warps x 4 pixels");

struct Branch2Args {
  const void* x2;   // (N, H + 2h, W + 2h, C), storage type
  const void* w1;   // (C, C) [in, out], storage type
  const float* b1;  // (C,)
  const float* wd;  // (C, K, K)
  const float* bd;  // (C,)
  const void* w3;   // (C, C) [in, out], storage type
  const float* b3;  // (C,)
  void* out;        // (N, H, W, C), storage type
  int height, width, c, k, r_tile;
};

// Shared memory of one CTA, in bytes; lab/kernels.py mirrors it.
size_t branch2_shared_bytes(int c, int k, int r_tile) {
  const int halo = k / 2;
  const size_t pin = (size_t)(r_tile + 2 * halo) * (TW + 2 * halo);
  return sizeof(float) * ((size_t)PG * XS + (size_t)CI * CC + pin * YS +
                          (size_t)r_tile * TW * c);
}

// Every sum runs over its inputs in ascending order, one fused multiply-add
// at a time from zero, and adds the bias last.
template <typename T>
__global__ void __launch_bounds__(THREADS) branch2_kernel(Branch2Args a) {
  const int c = a.c, k = a.k, rt = a.r_tile;
  const int halo = k / 2;
  const int pw = TW + 2 * halo;             // haloed tile columns
  const int pin = (rt + 2 * halo) * pw;     // haloed tile pixels
  const int tp = rt * TW;                   // output tile pixels
  const int win = a.width + 2 * halo, hin = a.height + 2 * halo;

  extern __shared__ float smem[];
  float* xs = smem;            // [PG][XS]   x2 stage
  float* ws = xs + PG * XS;    // [CI][CC]   W1 stage
  float* ys = ws + CI * CC;    // [pin][YS]  y1 chunk
  float* zs = ys + pin * YS;   // [tp][C]    z

  const T* x2 = static_cast<const T*>(a.x2) + (int64_t)blockIdx.y * hin * win * c;
  const T* w1 = static_cast<const T*>(a.w1);
  const T* w3 = static_cast<const T*>(a.w3);
  T* out = static_cast<T*>(a.out) + (int64_t)blockIdx.y * a.height * a.width * c;

  const int tiles_x = (a.width + TW - 1) / TW;
  // the tile's output origin; its haloed input starts there too (VALID)
  const int y0 = (blockIdx.x / tiles_x) * rt;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int tid = threadIdx.x;

  for (int co0 = 0; co0 < c; co0 += CC) {
    // y1[p, co0 + l + 16 q] of haloed pixels pg0 + g + 16 j, thread
    // (g, l) = (tid / 16, tid % 16)
    const int g = tid >> 4, l = tid & 15;
    for (int pg0 = 0; pg0 < pin; pg0 += PG) {
      float acc[NJ][RC];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[j][q] = 0.f;
      for (int ci0 = 0; ci0 < c; ci0 += CI) {
        __syncthreads();  // the previous stage (and chunk) is consumed
        for (int e = tid; e < PG * CI; e += THREADS) {
          const int p = pg0 + e / CI, ci = ci0 + e % CI;
          const int iy = y0 + p / pw, ix = x0 + p % pw;
          // beyond the input only for pixels no output of the tile reads
          float v = 0.f;
          if (p < pin && iy < hin && ix < win && ci < c)
            v = to_float(x2[((int64_t)iy * win + ix) * c + ci]);
          xs[(e / CI) * XS + e % CI] = v;
        }
        for (int e = tid; e < CI * CC; e += THREADS) {
          const int ci = ci0 + e / CC, cc = co0 + e % CC;
          ws[e] = (ci < c && cc < c) ? to_float(w1[(int64_t)ci * c + cc]) : 0.f;
        }
        __syncthreads();
        const int n_ci = min(CI, c - ci0);
        for (int ci = 0; ci < n_ci; ++ci) {
          float w[RC];
#pragma unroll
          for (int q = 0; q < RC; ++q) w[q] = ws[ci * CC + l + 16 * q];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const float v = xs[(g + 16 * j) * XS + ci];
#pragma unroll
            for (int q = 0; q < RC; ++q) acc[j][q] = fmaf(v, w[q], acc[j][q]);
          }
        }
      }
      // bias, ReLU, rounded to the storage type
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int cc = co0 + l + 16 * q;
        const float bias1 = cc < c ? a.b1[cc] : 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int p = pg0 + g + 16 * j;
          if (p < pin)
            ys[p * YS + l + 16 * q] =
                round_to<T>(fmaxf(acc[j][q] + bias1, 0.f));
        }
      }
    }
    __syncthreads();

    // depthwise taps of this chunk into z, rounded to the storage type:
    // thread tid holds channel tid % CC of pixels tid / CC + 4 j
    const int cl = tid % CC, co = co0 + cl;
    if (co < c) {
      const float* wc = a.wd + (int64_t)co * k * k;
      const float bias_dw = a.bd[co];
      for (int p = tid / CC; p < tp; p += THREADS / CC) {
        const int ty = p / TW, tx = p % TW;
        float z = 0.f;
        for (int ky = 0; ky < k; ++ky)
          for (int kx = 0; kx < k; ++kx)
            z = fmaf(ys[((ty + ky) * pw + tx + kx) * YS + cl], wc[ky * k + kx],
                     z);
        zs[p * c + co] = round_to<T>(z + bias_dw);
      }
    }
    // the next chunk overwrites ys only after the __syncthreads of its
    // first stage
  }
  __syncthreads();

  // out = relu(z . W3 + b3), PO pixels x CO channels per pass: warp g
  // holds pixels p0 + g + 8 j, lane l the channels c0 + l + 32 q
  const int g = tid >> 5, l = tid & 31;
  for (int p0 = 0; p0 < tp; p0 += PO) {
    for (int c0 = 0; c0 < c; c0 += CO) {
      float acc[4][RC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[j][q] = 0.f;
      for (int ci = 0; ci < c; ++ci) {
        float w[RC], z[4];
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const int cc = c0 + l + 32 * q;
          w[q] = cc < c ? to_float(w3[(int64_t)ci * c + cc]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) z[j] = zs[(p0 + g + 8 * j) * c + ci];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < RC; ++q) acc[j][q] = fmaf(z[j], w[q], acc[j][q]);
      }
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int co = c0 + l + 32 * q;
        if (co >= c) continue;
        const float bias3 = a.b3[co];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + g + 8 * j;
          const int oy = y0 + p / TW, ox = x0 + p % TW;
          if (oy >= a.height || ox >= a.width) continue;  // ragged tiles
          out[((int64_t)oy * a.width + ox) * c + co] =
              from_float<T>(fmaxf(acc[j][q] + bias3, 0.f));
        }
      }
    }
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

template <typename T>
int launch_dw(const void* x, const void* w, void* out, int height, int width,
              int channels, int k, int64_t total, cudaStream_t stream) {
  dw_valid_kernel<T><<<elementwise_blocks(total), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      height, width, channels, k, (unsigned)total);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_branch2(const Branch2Args& a, int batch, cudaStream_t stream) {
  const size_t smem = branch2_shared_bytes(a.c, a.k, a.r_tile);
  auto kernel = branch2_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      ((a.height + a.r_tile - 1) / a.r_tile) * ((a.width + TW - 1) / TW);
  kernel<<<dim3(tiles, batch), THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// All entry points: dtype 0 float32, 1 bfloat16; contiguous NHWC arrays;
// the launch goes on `stream` and the CUDA error of the launch is returned
// (0 on success). Nothing synchronises.

// a, b (P, C) and out (P, 2C), with P C < 2^31.
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

// x (N, H + K - 1, W + K - 1, C), w (C, K, K) and out (N, H, W, C), all of
// the dtype, with fewer than 2^31 elements in x.
extern "C" int lab_dw_valid(int dtype, const void* x, const void* w,
                            void* out, int batch, int height, int width,
                            int channels, int k, void* stream) {
  const int64_t total = (int64_t)batch * height * width * channels;
  if (total == 0) return 0;
  if ((int64_t)batch * (height + k - 1) * (width + k - 1) * channels >=
      (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dw<float>(x, w, out, height, width, channels, k, total, s);
  if (dtype == 1)
    return launch_dw<__nv_bfloat16>(x, w, out, height, width, channels, k,
                                     total, s);
  return (int)cudaErrorInvalidValue;
}

// x2 (N, H + 2h, W + 2h, C) with h = K / 2 (odd K), w1 and w3 (C, C)
// [in, out] of the dtype; b1, bd, b3 (C,) and wd (C, K, K) float32; out
// (N, H, W, C) of the dtype. r_tile, the tile's rows, is a multiple of 4;
// the CTA's shared memory, branch2_shared_bytes, must fit the card's
// 227 KB or the launch is refused.
extern "C" int lab_branch2(int dtype, const void* x2, const void* w1,
                           const float* b1, const float* wd, const float* bd,
                           const void* w3, const float* b3, void* out,
                           int batch, int height, int width, int channels,
                           int k, int r_tile, void* stream) {
  if (batch == 0 || height == 0 || width == 0) return 0;
  if (k % 2 == 0 || r_tile <= 0 || r_tile % 4)
    return (int)cudaErrorInvalidValue;
  const Branch2Args a{x2,     w1,    b1,       wd, bd,    w3, b3,
                      out,    height, width,   channels, k, r_tile};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_branch2<float>(a, batch, s);
  if (dtype == 1) return launch_branch2<__nv_bfloat16>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
