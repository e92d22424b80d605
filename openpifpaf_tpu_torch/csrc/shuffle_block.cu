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
// Replaces three Pallas TPU kernels, one mode each:
// - openpifpaf_tpu/models/shuffle_pallas.py::_block_kernel (BLOCK): the
//   whole block, with the interleave that the TPU kernel folds into one-hot
//   scatter matmuls. Here it is an output index map, which copies x1
//   exactly whatever its sign.
// - openpifpaf_tpu/models/block_pallas.py::_branch2_kernel (BRANCH2):
//   branch2 only, written as (N, H, W, Cb); the caller interleaves.
// - tools/mosaic_lab.py::branch2_kernel (LAB): the Mosaic lab's branch2,
//   ReLU and dilation 1, on an x2 of its own whose halo is data: (N, H + 2
//   halo, W + 2 halo, Cb) in, (N, H, W, Cb) out. The haloed tile's offsets
//   are the input's own (nothing outside the image to zero), y1 is rounded
//   to the storage type before the depthwise conv as in the TPU kernel,
//   and b1, the taps and their bias and b3 are float32 in either storage
//   type.
// The TPU kernels pad the two channel halves to 128 lanes in HBM and move
// rows with hand-made DMAs. Here the split is a pointer offset of Cb into
// the block's input and the tensors in HBM are not padded: channels are
// padded with zeros to a multiple of 16 in shared memory only.
//
// What bounds it on the H100: in bfloat16, bytes (the block reads x once
// and writes its output once); in float32, the two 1x1 products on CUDA
// cores. y1 and z never go to HBM. The design:
// - A cluster of CTAs (1 to 8, thread-block cluster) owns one (TH x TW)
//   output tile of one image. CTA rank r owns a slice of `slice` channels
//   (a multiple of 16): it computes y1 and z for its slice on the haloed
//   tile (the depthwise conv is per channel, so the slices are
//   independent), writes its z slice into every CTA of the cluster through
//   distributed shared memory, and after a cluster barrier computes its
//   slice of the second 1x1's output channels from the whole z.
// - First 1x1: an (M = haloed pixels) x slice x Cb product whose
//   accumulators stay in registers while x2's haloed tile and W1 stream
//   through shared memory in K-slices of 32 input channels, double
//   buffered with cp.async (one barrier per slice): x2 is read once per
//   CTA. The second 1x1 streams W3 the same way.
// - bfloat16: both products on tensor cores, mma.sync m16n8k16 bf16 ->
//   float32 fed by ldmatrix from rows padded by 16 bytes (no bank
//   conflicts); z, rounded to bf16, is the second product's A operand.
// - float32: the same tiles and staging, the products on CUDA cores: each
//   thread holds the accumulators of up to 9 x 3 m16n8 tiles (18 pixels x
//   6 channels per k as outer products from shared memory, A's rows read
//   four k at a time as float4), summing each output over its input
//   channels in ascending order.
// - The depthwise taps read y1 (float32, in shared memory) with a sliding
//   window of K + 7 rows down a strip of up to 8 output rows, the taps'
//   weights staged once per CTA in shared memory and held in registers.
// - The tile (TH, TW), the cluster size and the slice are chosen per call
//   in Python (models/shuffle_cuda.py::plan) so that the grid fills the
//   card; the kernel checks the plan and refuses one that does not fit.
//
// Storage is float32 or bfloat16 (weights in the activation's type, but
// for the LAB mode's float32 biases and taps); every sum is taken in
// float32, y1 stays float32 (zero outside the image, the depthwise conv's
// padding; rounded to the storage type in the LAB mode), z is rounded to the
// storage type before the second 1x1 and the output is rounded once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KS = 32;         // input channels per staged K-slice
constexpr int MT1 = 9;         // 16-pixel m-tiles of the haloed tile, at most
constexpr int MT2 = 4;         // 16-pixel m-tiles of the output tile, at most
constexpr int NT = 3;          // 8-channel n-tiles per warp, at most
constexpr int R = 8;           // output rows per depthwise strip, at most
constexpr int MAX_SLICE = WARPS * NT * 8;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 227 * 1024;

// the kernel's modes (`mode` of the C entry)
constexpr int BRANCH2 = 0;  // branch2 of x's second channel half
constexpr int BLOCK = 1;    // the whole block, interleaved with x1
constexpr int LAB = 2;      // the lab's branch2 of a pre-haloed x2

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

// two and four consecutive elements
template <typename T>
struct alignas(2 * sizeof(T)) Pair {
  T v[2];
};
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T v[4];
};

// act: 1 ReLU, 2 leaky ReLU with slope 0.01
__device__ __forceinline__ float activate(float v, int act) {
  if (act == 2) return v > 0.f ? v : v * 0.01f;
  return fmaxf(v, 0.f);
}

// b1, wdw, bdw and b3 are of the storage type, float32 in the LAB mode
struct BlockArgs {
  const void* x;    // (N, H, W, 2 Cb); LAB: x2 (N, H + 2 halo, W + 2 halo, Cb)
  const void* w1;   // (Cb, Cb) [in, out]
  const void* b1;   // (Cb,)
  const void* wdw;  // (Cb, K, K)
  const void* bdw;  // (Cb,)
  const void* w3;   // (Cb, Cb) [in, out]
  const void* b3;   // (Cb,)
  void* out;        // BLOCK (N, H, W, 2 Cb) interleaved, else (N, H, W, Cb)
  int height, width, cb, dilation, act;
  // the plan: output tile th x tw, CTAs per cluster, channels per CTA,
  // bytes per staged vector (a divisor of 16 that aligns every row)
  int th, tw, cluster, slice, vb;
};

// Shared-memory layout of one CTA (the same formula as
// models/shuffle_cuda.py::shared_bytes). Region A holds in turn the first
// 1x1's two K-slice buffers (x2 and W1), then y1 with the taps'
// weights and biases (float32), then the second 1x1's two W3 K-slices
// and the output tile's x1;
// region Z the whole z of the tile, [tile pixel][cluster * slice]; then the
// tables of the haloed tile's x2 offsets and the output tile's pixels.
struct Layout {
  int halo, ph, pw, pin, m_tiles, tp, tp_tiles, cb_pad, pe, xs, ws, ys, zs;
  int stage1;  // elements of one K-slice buffer of the first 1x1
  size_t a_bytes, z_bytes, tab_bytes;

  __host__ __device__ Layout(const BlockArgs& a, int k, int size) {
    halo = (k - 1) / 2 * a.dilation;
    ph = a.th + 2 * halo;
    pw = a.tw + 2 * halo;
    pin = ph * pw;
    m_tiles = (pin + 15) / 16;
    tp = a.th * a.tw;
    tp_tiles = (tp + 15) / 16;
    cb_pad = a.cluster * a.slice;
    pe = 16 / size;  // one 16-byte chunk of row padding
    xs = KS + pe;
    ws = a.slice + pe;
    ys = a.slice + 4;
    zs = cb_pad + pe;
    stage1 = m_tiles * 16 * xs + KS * ws;
    const size_t bufs1 = (size_t)2 * stage1 * size;
    const size_t taps =
        ((size_t)pin * ys + (size_t)(k * k + 1) * a.slice) * 4;
    // W3's two buffers, then the tile's x1 in this CTA's channels
    const size_t bufs2 = (size_t)2 * KS * ws * size +
                         (size_t)tp_tiles * 16 * ws * size;
    a_bytes = bufs1 > taps ? bufs1 : taps;
    if (bufs2 > a_bytes) a_bytes = bufs2;
    a_bytes = (a_bytes + 15) / 16 * 16;
    z_bytes = ((size_t)tp_tiles * 16 * zs * size + 15) / 16 * 16;
    tab_bytes = (size_t)(m_tiles + tp_tiles) * 16 * sizeof(int64_t);
  }
  __host__ __device__ size_t bytes() const {
    return a_bytes + z_bytes + tab_bytes;
  }
};

// ---------------------------------------------------------------- copies

// One vector of VB bytes from global to shared memory, zeros where
// !inside. cp.async takes 4, 8 or 16 bytes; 2 (odd Cb in bf16) is copied by
// hand.
template <int VB>
__device__ __forceinline__ void copy_vec(void* dst, const void* src,
                                         bool inside) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const unsigned n = inside ? (unsigned)VB : 0u;
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else if constexpr (VB >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(VB), "r"(n));
  } else {
    *static_cast<uint16_t*>(dst) =
        inside ? *static_cast<const uint16_t*>(src) : (uint16_t)0;
  }
}

// f(std::integral_constant<int, vb>) for the plan's vector bytes, at compile
// time: the copy loops below have no per-element division or switch
template <typename T, typename F>
__device__ __forceinline__ void with_vb(int vb, F f) {
  switch (vb) {
    case 16: f(std::integral_constant<int, 16>()); break;
    case 8: f(std::integral_constant<int, 8>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    default:
      if constexpr (sizeof(T) == 2) f(std::integral_constant<int, 2>());
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// rows [k0, k0 + KS) x columns [n0, n0 + n) of a (rows, ld) matrix into
// dst[KS][dst_ld]; zeros beyond (rows, cols). Each thread copies one column
// vector of every THREADS / (n / G)-th row.
template <int VB, typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_ld, const T* src,
                                           int ld, int rows, int cols, int k0,
                                           int n0, int n) {
  constexpr int G = VB / (int)sizeof(T);  // elements per vector
  const int per_row = n / G;
  const int step = THREADS / per_row;
  int r = threadIdx.x / per_row;
  if (r >= step) return;
  const int c = (threadIdx.x - r * per_row) * G;
  const bool col_in = n0 + c < cols;
  const T* s = src + (int64_t)(k0 + r) * ld + n0 + c;
  T* d = dst + r * dst_ld + c;
  for (; r < KS; r += step, s += (int64_t)step * ld, d += step * dst_ld) {
    const bool inside = col_in && k0 + r < rows;
    copy_vec<VB>(d, inside ? s : src, inside);
  }
}

// channels [k0, k0 + KS) of x2 at the haloed tile's rows into
// dst[rows][xs_ld]; off[p] is row p's x2 offset in x, -1 outside the image
template <int VB, typename T>
__device__ __forceinline__ void stage_x2(T* dst, int xs_ld, const T* x,
                                         const int64_t* off, int rows, int k0,
                                         int cb) {
  constexpr int G = VB / (int)sizeof(T);
  constexpr int PER_PX = KS / G;
  constexpr int STEP = THREADS / PER_PX;
  const int c = (threadIdx.x % PER_PX) * G;
  const bool ch_in = k0 + c < cb;
  for (int p = threadIdx.x / PER_PX; p < rows; p += STEP) {
    const int64_t o = off[p];
    const bool inside = o >= 0 && ch_in;
    copy_vec<VB>(dst + p * xs_ld + c, inside ? x + o + k0 + c : x, inside);
  }
}

// channels [c0, c0 + n) of x1 at the output tile's rows into dst[rows][ld];
// px[p] is row p's pixel, -1 outside the image
template <int VB, typename T>
__device__ __forceinline__ void stage_x1(T* dst, int ld, const T* x,
                                         const int64_t* px, int rows, int c2,
                                         int c0, int n, int cb) {
  constexpr int G = VB / (int)sizeof(T);
  const int per_row = n / G;
  const int step = THREADS / per_row;
  int r = threadIdx.x / per_row;
  if (r >= step) return;
  const int c = (threadIdx.x - r * per_row) * G;
  const bool col_in = c0 + c < cb;
  for (; r < rows; r += step) {
    const int64_t o = px[r];
    const bool inside = o >= 0 && col_in;
    copy_vec<VB>(dst + r * ld + c, inside ? x + o * c2 + c0 + c : x, inside);
  }
}

// ------------------------------------------------------------- products

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  // registers only: not volatile, so the compiler may interleave it with
  // the next fragments' loads
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += A[16 m_tiles rows][16 ksteps] . B[16 ksteps][8 n_tiles] for this
// warp's n-tiles (warp + WARPS j). A row-major (lda), B row-major [k][n]
// (ldb), both in shared memory. The accumulators follow the m16n8 layout
// of mma.sync: lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8,
// columns 2t and 2t + 1 of each tile.
template <typename T, int MT>
__device__ __forceinline__ void warp_product(float (&acc)[MT][NT][4],
                                             const T* A, int lda,
                                             int m_tiles, const T* B, int ldb,
                                             int n_tiles, int ksteps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      if (ks >= ksteps) break;
      unsigned b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int nt = warp + WARPS * j;
        if (nt < n_tiles)
          ldmatrix_x2_trans(b[j], B + (ks * 16 + (lane & 15)) * ldb + nt * 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= m_tiles) break;
        unsigned a[4];
        ldmatrix_x4(a, A + (mt * 16 + (lane & 15)) * lda + ks * 16 +
                           (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (warp + WARPS * j < n_tiles) mma_bf16(acc[mt][j], a, b[j]);
      }
    }
  } else {
    // four k at a time: A's rows as float4 loads, B's four rows of this
    // lane's two columns as float2 loads; each output still sums over k in
    // ascending order
    const int g = lane >> 2, t = lane & 3;
    const int kn = ksteps * 16 < KS ? ksteps * 16 : KS;
    for (int k = 0; k < kn; k += 4) {
      float2 b[4][NT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int nt = warp + WARPS * j;
          b[kk][j] = nt < n_tiles ? *reinterpret_cast<const float2*>(
                                        B + (k + kk) * ldb + nt * 8 + 2 * t)
                                  : make_float2(0.f, 0.f);
        }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt >= m_tiles) break;
        const float4 a0 =
            *reinterpret_cast<const float4*>(A + (mt * 16 + g) * lda + k);
        const float4 a1 =
            *reinterpret_cast<const float4*>(A + (mt * 16 + g + 8) * lda + k);
        const float r0[4] = {a0.x, a0.y, a0.z, a0.w};
        const float r1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            acc[mt][j][0] = fmaf(r0[kk], b[kk][j].x, acc[mt][j][0]);
            acc[mt][j][1] = fmaf(r0[kk], b[kk][j].y, acc[mt][j][1]);
            acc[mt][j][2] = fmaf(r1[kk], b[kk][j].x, acc[mt][j][2]);
            acc[mt][j][3] = fmaf(r1[kk], b[kk][j].y, acc[mt][j][3]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------- kernel

template <typename T, int K, int MODE>
__global__ void __launch_bounds__(THREADS) shuffle_block_kernel(BlockArgs a) {
  constexpr bool INTERLEAVE = MODE == BLOCK;
  // the biases' and taps' type
  using P = typename std::conditional<MODE == LAB, float, T>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(a, K, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* region_a = smem;
  T* zbuf = reinterpret_cast<T*>(smem + L.a_bytes);
  // x2 offset of each haloed tile row in x and pixel of each output tile
  // row in the image, -1 outside the input and the output
  int64_t* x2_off = reinterpret_cast<int64_t*>(smem + L.a_bytes + L.z_bytes);
  int64_t* out_px = x2_off + L.m_tiles * 16;

  const T* __restrict__ x = static_cast<const T*>(a.x);
  const T* __restrict__ w1 = static_cast<const T*>(a.w1);
  const P* __restrict__ b1 = static_cast<const P*>(a.b1);
  const P* __restrict__ wdw = static_cast<const P*>(a.wdw);
  const P* __restrict__ bdw = static_cast<const P*>(a.bdw);
  const T* __restrict__ w3 = static_cast<const T*>(a.w3);
  const P* __restrict__ b3 = static_cast<const P*>(a.b3);
  T* __restrict__ out = static_cast<T*>(a.out);

  const int height = a.height, width = a.width, cb = a.cb, c2 = 2 * cb;
  const int d = a.dilation, act = a.act, slice = a.slice;
  const int rank = (int)cluster.block_rank();
  const int c0 = rank * slice;  // this CTA's first channel
  const int tile = blockIdx.x / a.cluster;
  const int tiles_x = (width + a.tw - 1) / a.tw;
  const int y0 = (tile / tiles_x) * a.th;
  const int x0 = (tile % tiles_x) * a.tw;
  const int64_t image_pixel0 = (int64_t)blockIdx.y * height * width;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n_tiles = slice / 8;

  if constexpr (MODE == LAB) {
    // x2 is a tensor of its own, (height + 2 halo, width + 2 halo) pixels of
    // cb channels, its halo data: the haloed tile starts at the output
    // tile's origin and is outside x2 only beyond its far edges
    const int in_h = height + 2 * L.halo, in_w = width + 2 * L.halo;
    const int64_t in_pixel0 = (int64_t)blockIdx.y * in_h * in_w;
    for (int p = tid; p < L.m_tiles * 16; p += THREADS) {
      const int gy = y0 + p / L.pw, gx = x0 + p % L.pw;
      x2_off[p] = p < L.pin && gy < in_h && gx < in_w
                      ? (in_pixel0 + (int64_t)gy * in_w + gx) * cb
                      : -1;
    }
  } else {
    for (int p = tid; p < L.m_tiles * 16; p += THREADS) {
      const int gy = y0 - L.halo + p / L.pw, gx = x0 - L.halo + p % L.pw;
      x2_off[p] = p < L.pin && gy >= 0 && gy < height && gx >= 0 && gx < width
                      ? (image_pixel0 + (int64_t)gy * width + gx) * c2 + cb
                      : -1;
    }
  }
  for (int p = tid; p < L.tp_tiles * 16; p += THREADS) {
    const int oy = y0 + p / a.tw, ox = x0 + p % a.tw;
    out_px[p] = p < L.tp && oy < height && ox < width  // ragged last tile
                    ? image_pixel0 + (int64_t)oy * width + ox
                    : -1;
  }
  __syncthreads();

  // ---- first 1x1: acc1 = x2 . W1[:, c0:c0+slice], K streamed through two
  // buffers: slice s + 1 is staged while slice s is used
  T* buf = reinterpret_cast<T*>(region_a);
  auto stage1 = [&](int s) {
    T* xs = buf + (s & 1) * L.stage1;
    with_vb<T>(a.vb, [&](auto vb) {
      constexpr int VB = decltype(vb)::value;
      stage_x2<VB>(xs, L.xs, x, x2_off, L.m_tiles * 16, s * KS, cb);
      stage_rows<VB>(xs + L.m_tiles * 16 * L.xs, L.ws, w1, cb, cb, cb,
                     s * KS, c0, slice);
    });
  };

  float acc1[MT1][NT][4];
#pragma unroll
  for (int i = 0; i < MT1; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][j][e] = 0.f;

  const int n_slices = (L.cb_pad + KS - 1) / KS;
  stage1(0);
  commit();
  for (int s = 0; s < n_slices; ++s) {
    wait_all();       // slice s has landed
    __syncthreads();  // ... for every thread; slice s - 1 is consumed
    if (s + 1 < n_slices) {
      stage1(s + 1);
      commit();
    }
    const T* xs = buf + (s & 1) * L.stage1;
    warp_product<T, MT1>(acc1, xs, L.xs, L.m_tiles, xs + L.m_tiles * 16 * L.xs,
                         L.ws, n_tiles, (L.cb_pad - s * KS) / 16);
  }
  wait_all();
  __syncthreads();  // the buffers are consumed: region A becomes y1

  // the taps' weights [K * K][slice] and biases [slice], float32, zero
  // beyond Cb
  float* y1 = reinterpret_cast<float*>(region_a);
  float* wt = y1 + L.pin * L.ys;
  float* bt = wt + K * K * slice;
  for (int e = tid; e < slice * K * K; e += THREADS) {
    const int c = e / (K * K), q = e - c * (K * K);
    wt[q * slice + c] =
        c0 + c < cb ? to_float(wdw[(int64_t)(c0 + c) * K * K + q]) : 0.f;
  }
  for (int c = tid; c < slice; c += THREADS)
    bt[c] = c0 + c < cb ? to_float(bdw[c0 + c]) : 0.f;

  // ---- y1 = act(acc1 + b1), zero outside the image and beyond Cb; in the
  // LAB mode rounded to the storage type
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt) {
    if (mt >= L.m_tiles) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = warp + WARPS * j;
      if (nt >= n_tiles) continue;
      const int c = nt * 8 + 2 * t;
      const float bias0 = c0 + c < cb ? to_float(b1[c0 + c]) : 0.f;
      const float bias1 = c0 + c + 1 < cb ? to_float(b1[c0 + c + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= L.pin) continue;
        const bool inside = x2_off[p] >= 0;
        float2 v;
        v.x = inside && c0 + c < cb
                  ? activate(acc1[mt][j][2 * h] + bias0, act)
                  : 0.f;
        v.y = inside && c0 + c + 1 < cb
                  ? activate(acc1[mt][j][2 * h + 1] + bias1, act)
                  : 0.f;
        if constexpr (MODE == LAB) {
          v.x = round_to<T>(v.x);
          v.y = round_to<T>(v.y);
        }
        *reinterpret_cast<float2*>(y1 + p * L.ys + c) = v;
      }
    }
  }
  __syncthreads();

  // ---- z = depthwise(y1) + bdw for this slice, rounded to T, into the z
  // of every CTA of the cluster. Item (pair, column, phase): channels
  // c, c + 1 of the strip of output rows phase + r d at column tx.
  {
    const int pairs = slice / 2;
    for (int item = tid; item < pairs * a.tw * d; item += THREADS) {
      const int c = 2 * (item % pairs);
      const int rest = item / pairs;
      const int tx = rest % a.tw, phase = rest / a.tw;
      const int gc = c0 + c;
      float2 wk[K * K];
#pragma unroll
      for (int q = 0; q < K * K; ++q)
        wk[q] = *reinterpret_cast<const float2*>(wt + q * slice + c);
      const float2 bz = *reinterpret_cast<const float2*>(bt + c);
      float acc[R][2];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
      for (int j = 0; j < R + K - 1; ++j) {
        const int row = phase + j * d;
        if (row >= L.ph) break;
        const float* yr = y1 + (row * L.pw + tx) * L.ys + c;
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          const float2 v =
              *reinterpret_cast<const float2*>(yr + kx * d * L.ys);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int ky = j - r;
            if (ky >= 0 && ky < K) {
              acc[r][0] = fmaf(v.x, wk[ky * K + kx].x, acc[r][0]);
              acc[r][1] = fmaf(v.y, wk[ky * K + kx].y, acc[r][1]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int ty = phase + r * d;
        if (ty >= a.th) break;
        Pair<T> zp;
        zp.v[0] = from_float<T>(acc[r][0] + bz.x);
        zp.v[1] = from_float<T>(acc[r][1] + bz.y);
        const int off = (ty * a.tw + tx) * L.zs + gc;
        for (int rr = 0; rr < a.cluster; ++rr)
          *reinterpret_cast<Pair<T>*>(cluster.map_shared_rank(zbuf + off,
                                                              rr)) = zp;
      }
    }
  }
  cluster.sync();  // every slice of z is in every CTA; y1 is dead

  // ---- second 1x1: acc2 = z . W3[:, c0:c0+slice], W3 streamed through
  // two buffers as above
  auto stage2 = [&](int s) {
    with_vb<T>(a.vb, [&](auto vb) {
      stage_rows<decltype(vb)::value>(buf + (s & 1) * KS * L.ws, L.ws, w3,
                                      cb, cb, cb, s * KS, c0, slice);
    });
  };
  float acc2[MT2][NT][4];
#pragma unroll
  for (int i = 0; i < MT2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;

  T* x1_tile = buf + 2 * KS * L.ws;  // [tile pixel][ws]
  if (INTERLEAVE)
    with_vb<T>(a.vb, [&](auto vb) {
      stage_x1<decltype(vb)::value>(x1_tile, L.ws, x, out_px,
                                    L.tp_tiles * 16, c2, c0, slice, cb);
    });
  stage2(0);
  commit();
  for (int s = 0; s < n_slices; ++s) {
    wait_all();
    __syncthreads();
    if (s + 1 < n_slices) {
      stage2(s + 1);
      commit();
    }
    warp_product<T, MT2>(acc2, zbuf + s * KS, L.zs, L.tp_tiles,
                         buf + (s & 1) * KS * L.ws, L.ws, n_tiles,
                         (L.cb_pad - s * KS) / 16);
  }
  wait_all();
  __syncthreads();  // x1's tile has landed for every thread

  // ---- out: act(acc2 + b3), rounded once, interleaved with x1 or alone:
  // each lane writes channels co, co + 1, as one vector where the rows
  // allow it (even Cb)
  const bool even = cb % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < MT2; ++mt) {
    if (mt >= L.tp_tiles) break;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int nt = warp + WARPS * j;
      if (nt >= n_tiles) continue;
      const int c = nt * 8 + 2 * t, co = c0 + c;
      if (co >= cb) continue;
      const bool pair = co + 1 < cb;
      const float bias0 = to_float(b3[co]);
      const float bias1 = pair ? to_float(b3[co + 1]) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        const int64_t pixel = out_px[p];
        if (pixel < 0) continue;
        const T v0 = from_float<T>(activate(acc2[mt][j][2 * h] + bias0, act));
        const T v1 =
            from_float<T>(activate(acc2[mt][j][2 * h + 1] + bias1, act));
        if (INTERLEAVE) {
          const T* x1 = x1_tile + p * L.ws + c;
          T* o = out + pixel * c2 + 2 * co;
          if (even) {
            Vec4<T> q;
            q.v[0] = x1[0];
            q.v[1] = v0;
            q.v[2] = x1[1];
            q.v[3] = v1;
            *reinterpret_cast<Vec4<T>*>(o) = q;
          } else {
            Pair<T> p0;
            p0.v[0] = x1[0];
            p0.v[1] = v0;
            *reinterpret_cast<Pair<T>*>(o) = p0;
            if (pair) {
              p0.v[0] = x1[1];
              p0.v[1] = v1;
              *reinterpret_cast<Pair<T>*>(o + 2) = p0;
            }
          }
        } else if (even) {
          Pair<T> p0;
          p0.v[0] = v0;
          p0.v[1] = v1;
          *reinterpret_cast<Pair<T>*>(out + pixel * cb + co) = p0;
        } else {
          out[pixel * cb + co] = v0;
          if (pair) out[pixel * cb + co + 1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch

// The plan covers the channels and fits one CTA: the kernel's register
// tiles, the vector alignment of every staged row and 227 KB of shared
// memory.
bool plan_fits(const BlockArgs& a, int k, int size, size_t smem) {
  const Layout L(a, k, size);
  const int g = a.vb / size;
  return a.th >= 1 && a.tw >= 1 && a.dilation >= 1 &&
         (a.th + a.dilation - 1) / a.dilation <= R && L.m_tiles <= MT1 &&
         L.tp_tiles <= MT2 && a.cluster >= 1 && a.cluster <= MAX_CLUSTER &&
         a.slice % 16 == 0 && a.slice <= MAX_SLICE &&
         L.cb_pad >= a.cb && L.cb_pad - a.slice < a.cb &&
         (a.vb == 2 || a.vb == 4 || a.vb == 8 || a.vb == 16) && g >= 1 &&
         a.vb % size == 0 && a.cb % g == 0 && a.slice % g == 0 &&
         L.bytes() == smem && smem <= (size_t)MAX_SMEM;
}

template <typename T, int K, int MODE>
int launch(const BlockArgs& a, int batch, size_t smem, cudaStream_t stream) {
  auto kernel = shuffle_block_kernel<T, K, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles =
      ((a.height + a.th - 1) / a.th) * ((a.width + a.tw - 1) / a.tw);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cluster, batch, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// clusters of the plan's size and shared memory that the card holds at once
template <typename T, int K, int MODE>
int max_clusters(const BlockArgs& a, size_t smem, int* clusters) {
  auto kernel = shuffle_block_kernel<T, K, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <typename T, int MODE>
int by_k(const BlockArgs& a, int k, int batch, size_t smem, cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3, MODE>(a, batch, smem, s);
    case 5: return launch<T, 5, MODE>(a, batch, smem, s);
    case 7: return launch<T, 7, MODE>(a, batch, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_mode(const BlockArgs& a, int mode, int k, int batch, size_t smem,
            cudaStream_t s) {
  if (!plan_fits(a, k, sizeof(T), smem)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case BRANCH2: return by_k<T, BRANCH2>(a, k, batch, smem, s);
    case BLOCK: return by_k<T, BLOCK>(a, k, batch, smem, s);
    case LAB:
      if (a.dilation != 1 || a.act != 1) return (int)cudaErrorInvalidValue;
      return by_k<T, LAB>(a, k, batch, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16; mode: 1 (BLOCK) writes the whole block's
// (N, H, W, 2 Cb) output, 0 (BRANCH2) branch2's (N, H, W, Cb), 2 (LAB) the
// lab's branch2 (N, H, W, Cb) of x2 = x (N, H + 2 halo, W + 2 halo, Cb) with
// float32 b1, wdw, bdw and b3, act 1 and dilation 1; height and width are
// the output's; k 3, 5 or 7; act: 1 ReLU, 2 leaky. The plan
// (models/shuffle_cuda.py::plan): output tiles of th x tw pixels, clusters
// of `cluster` CTAs of `slice` channels each, x2 and the weight rows staged
// in vectors of vb bytes, two K-slices at a time, smem shared bytes per
// CTA; a plan that does not cover the block or fit a CTA is refused.
// Returns the CUDA error of the launch (0 on success).
extern "C" int shuffle_block(int dtype, int mode, const void* x,
                             const void* w1, const void* b1, const void* wdw,
                             const void* bdw, const void* w3, const void* b3,
                             void* out, int batch, int height, int width,
                             int cb, int k, int dilation, int act, int th,
                             int tw, int cluster, int slice, int vb,
                             int smem, void* stream) {
  if (batch == 0 || height == 0 || width == 0) return 0;
  if (batch > 65535) return (int)cudaErrorInvalidValue;
  const BlockArgs a{x,   w1,     b1,    wdw, bdw,      w3,  b3,
                    out, height, width, cb,  dilation, act, th,
                    tw,  cluster, slice, vb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_mode<float>(a, mode, k, batch, (size_t)smem, s);
  if (dtype == 1)
    return by_mode<__nv_bfloat16>(a, mode, k, batch, (size_t)smem, s);
  return (int)cudaErrorInvalidValue;
}

// The number of clusters of `cluster` CTAs with `smem` shared bytes each
// that the card runs at once, into *clusters (for the caller to print
// beside a plan). Returns the CUDA error (0 on success).
extern "C" int shuffle_block_clusters(int dtype, int k, int cluster,
                                      int smem, int* clusters) {
  BlockArgs a{};
  a.cluster = cluster;
  if (dtype == 0 && k == 5)
    return max_clusters<float, 5, BLOCK>(a, (size_t)smem, clusters);
  if (dtype == 1 && k == 5)
    return max_clusters<__nv_bfloat16, 5, BLOCK>(a, (size_t)smem, clusters);
  return (int)cudaErrorInvalidValue;
}
