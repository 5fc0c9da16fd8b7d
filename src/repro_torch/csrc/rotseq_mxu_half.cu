// Accumulated (rs_gemm) application of one band of plane rotations in
// bfloat16 or float16 on the tensor cores (mma.sync, float32 sums), sm_90a.
//
// Replaces: src/repro/kernels/rotseq_mxu/kernel.py::rotseq_mxu_pallas (body
// _mxu_kernel) for half-precision operands, where the body forms
// dot(x, Q_t, preferred_element_type=float32).astype(x.dtype).  The IEEE
// float32 tier is rotseq_mxu.cu; this source holds only the half tier.
//
// What it computes, natural layout: for each block of rows of A it walks
// the T tiles of the band in order, Y_t = [carry | fresh_t] (rows, w) @ Q_t
// (w, w) with w = k_b + n_b, the products' sums in float32, each Y_t
// rounded to the half type T once; Y_t[:, :n_b] is emitted and
// Y_t[:, n_b:] is the next carry, which never leaves the SM.  The tile
// factors Q_t come in T, built outside the kernel by one half-precision
// rotseq_batched launch a band (kernels/rotseq_mxu/ops.py::band_factors),
// and are read transposed (qt[t][j][i] = Q_t[i][j], rows padded to ldq).
//
// What bounds it on an H100: 2*m*w*w flops a tile, 3.1e10 at the paper's
// shape (n_b = k_b = 128, m = n = 3840, k = 180): 0.032 ms at 989 TFLOP/s
// of dense bf16/f16; the bytes (fresh in and the result out once a band,
// 2 bytes a value, and the factors) take about as long, 0.04 ms at 3.35
// TB/s.  In practice every block reads all of each Q_t from L2 (128 KB a
// tile at w = 256, 120 blocks at the paper shape), and that read is not
// overlapped with the products: this first version is simple, not fast.
//
// Design (one block: kRows rows of A, kWarps warps, the tiles in order):
// - Shared memory holds Q_t^T (WP rows), X = [carry | fresh_t] and Y_t,
//   each row padded by kPad elements so that a warp's fragment loads hit
//   32 distinct banks.  Columns and rows past w stay +0 (zeroed once), so
//   the products over the padded depth add +0 terms.
// - Warp v computes the columns [v*WP/kWarps, (v+1)*WP/kWarps) of Y_t for
//   all kRows rows with mma.sync.m16n8k16 (row.col, f32 accumulators);
//   A fragments from X, B fragments from Q_t^T, both as 32-bit loads of two
//   consecutive elements.
// - After the products Y_t is rounded to T into shared memory; then the
//   next tile's Q^T and fresh columns are copied in with cp.async (16-byte
//   pieces; the fresh columns element by element where n_b or k_b is not a
//   multiple of kVec), the carry Y_t[:, n_b:w] moves to X[:, :k_b] and
//   Y_t[:, :n_b] is stored.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// rows of A a block
constexpr int kRows = 32;
// elements of T in one 16-byte piece: Q^T's row stride ldq is a multiple
// (repro_torch.kernels.limits.MXU_HALF_VEC)
constexpr int kVec = 8;
// warps a block, each a quarter of Y_t's columns
constexpr int kWarps = 4;
// elements a shared-memory row is padded by
constexpr int kPad = 8;
static_assert(kRows % 16 == 0, "rows a block: whole m16 tiles");

// One m16n8k16 product of the half type, float32 accumulators in place,
// and the packing of two float32 values into a pair of T (lower column in
// the lower half).
template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Grid: one block a group of kRows rows of A.  fresh/out are (M, T*n_b),
// init (M, k_b), qt (T, w, ldq), all in T and contiguous.  With vec (n_b
// and k_b multiples of kVec, fresh and out 16-byte aligned) the fresh
// columns, the carry and the result move in 16-byte pieces.
template <typename T, int WP>
__global__ void __launch_bounds__(kWarps * 32)
rotseq_mxu_half_kernel(const T* __restrict__ fresh, const T* __restrict__ qt,
                       const T* __restrict__ init, T* __restrict__ out,
                       int tiles, int n_b, int k_b, int M, int ldq,
                       bool vec) {
  constexpr int LDS = WP + kPad;        // shared row stride, elements
  constexpr int WN = WP / kWarps;       // columns of Y a warp
  constexpr int NT8 = WN / 8;           // its n8 tiles
  constexpr int MT = kRows / 16;        // m16 tiles of the block
  constexpr int NTH = kWarps * 32;
  static_assert(WN % 8 == 0 && LDS % kVec == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);   // Q_t^T, WP rows
  T* xs = qs + WP * LDS;                    // [carry | fresh_t]
  T* ys = xs + kRows * LDS;                 // Y_t rounded to T
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                  // the fragments' row group
  const int tq = lane & 3;                  // and thread in the group
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, M - row0);
  const int w = n_b + k_b;
  const int wk = (w + 15) / 16 * 16;        // depth the products run over
  const long long ldf = (long long)tiles * n_b;  // row stride of fresh/out
  const int n0 = warp * WN;

  {  // +0 everywhere: the padding columns and rows are never written again
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    constexpr int pieces = (WP + 2 * kRows) * LDS * (int)sizeof(T) / 16;
    for (int i = tid; i < pieces; i += NTH) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  auto load_q = [&](int t) {                // rows 0 .. w-1 of Q_t^T
    const T* src = qt + (size_t)t * w * ldq;
    const int per_row = ldq / kVec;
    for (int i = tid; i < w * per_row; i += NTH) {
      const int r = i / per_row;
      const int c = i % per_row * kVec;
      __pipeline_memcpy_async(qs + r * LDS + c, src + (size_t)r * ldq + c,
                              16);
    }
  };
  auto load_fresh = [&](int t) {            // X[:, k_b:w] = fresh_t
    const T* src = fresh + (long long)row0 * ldf + (long long)t * n_b;
    if (vec) {
      const int per_row = n_b / kVec;
      for (int i = tid; i < rows * per_row; i += NTH) {
        const int r = i / per_row;
        const int c = i % per_row * kVec;
        __pipeline_memcpy_async(xs + r * LDS + k_b + c, src + r * ldf + c,
                                16);
      }
    } else {
      for (int i = tid; i < rows * n_b; i += NTH) {
        const int r = i / n_b;
        const int c = i % n_b;
        xs[r * LDS + k_b + c] = src[r * ldf + c];
      }
    }
  };

  for (int i = tid; i < rows * k_b; i += NTH) {   // the initial carry
    const int r = i / k_b;
    const int c = i % k_b;
    xs[r * LDS + c] = init[(size_t)(row0 + r) * k_b + c];
  }
  load_q(0);
  load_fresh(0);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  for (int t = 0; t < tiles; ++t) {
    float acc[MT][NT8][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    for (int k0 = 0; k0 < wk; k0 += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        // rows g and g + 8, columns k0 + 2tq (+1) and 8 further
        const T* x0 = xs + (mi * 16 + g) * LDS + k0 + 2 * tq;
        const T* x1 = x0 + 8 * LDS;
        a[mi][0] = ld32(x0);
        a[mi][1] = ld32(x1);
        a[mi][2] = ld32(x0 + 8);
        a[mi][3] = ld32(x1 + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni) {
        // column n0 + 8ni + g of Q_t, rows k0 + 2tq (+1) and 8 further
        const T* q = qs + (n0 + ni * 8 + g) * LDS + k0 + 2 * tq;
        const uint32_t b0 = ld32(q);
        const uint32_t b1 = ld32(q + 8);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          Mma<T>::run(acc[mi][ni], a[mi], b0, b1);
      }
    }
    // Y_t rounded to T: accumulators (g, 2tq..2tq+1) and (g + 8, ...)
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
#pragma unroll
      for (int ni = 0; ni < NT8; ++ni) {
        T* y = ys + (mi * 16 + g) * LDS + n0 + ni * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(y) =
            Mma<T>::pack(acc[mi][ni][0], acc[mi][ni][1]);
        *reinterpret_cast<uint32_t*>(y + 8 * LDS) =
            Mma<T>::pack(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
    // Y_t is whole, and no warp reads X or Q_t again in this tile
    __syncthreads();
    if (t + 1 < tiles) {
      load_q(t + 1);
      load_fresh(t + 1);
      __pipeline_commit();
    }
    T* dst = out + (long long)row0 * ldf + (long long)t * n_b;
    if (vec) {
      const int carry_row = k_b / kVec;
      for (int i = tid; i < kRows * carry_row; i += NTH) {
        const int r = i / carry_row;
        const int c = i % carry_row * kVec;
        *reinterpret_cast<uint4*>(xs + r * LDS + c) =
            *reinterpret_cast<const uint4*>(ys + r * LDS + n_b + c);
      }
      const int out_row = n_b / kVec;
      for (int i = tid; i < rows * out_row; i += NTH) {
        const int r = i / out_row;
        const int c = i % out_row * kVec;
        *reinterpret_cast<uint4*>(dst + r * ldf + c) =
            *reinterpret_cast<const uint4*>(ys + r * LDS + c);
      }
    } else {
      for (int i = tid; i < kRows * k_b; i += NTH) {
        const int r = i / k_b;
        const int c = i % k_b;
        xs[r * LDS + c] = ys[r * LDS + n_b + c];
      }
      for (int i = tid; i < rows * n_b; i += NTH) {
        const int r = i / n_b;
        const int c = i % n_b;
        dst[r * ldf + c] = ys[r * LDS + c];
      }
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // X and Q_{t+1} in place before the next products
  }
}

template <typename T, int WP>
int launch(const T* fresh, const T* qt, const T* init, T* out, int tiles,
           int n_b, int k_b, int M, int ldq, cudaStream_t stream) {
  constexpr int smem = (WP + 2 * kRows) * (WP + kPad) * (int)sizeof(T);
  auto kernel = rotseq_mxu_half_kernel<T, WP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = n_b % kVec == 0 && k_b % kVec == 0 &&
                   (size_t)fresh % 16 == 0 && (size_t)out % 16 == 0;
  kernel<<<(M + kRows - 1) / kRows, kWarps * 32, smem, stream>>>(
      fresh, qt, init, out, tiles, n_b, k_b, M, ldq, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int rotseq_mxu_half(const T* fresh, const T* qt, const T* init, T* out,
                    int tiles, int n_b, int k_b, int M, int ldq,
                    void* stream) {
  const int w = n_b + k_b;
  if (n_b < 1 || k_b < 1 || tiles < 1 || M < 1 || w > 256 || ldq < w ||
      ldq % kVec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= 64) return launch<T, 64>(fresh, qt, init, out, tiles, n_b, k_b, M,
                                    ldq, s);
  if (w <= 128)
    return launch<T, 128>(fresh, qt, init, out, tiles, n_b, k_b, M, ldq, s);
  return launch<T, 256>(fresh, qt, init, out, tiles, n_b, k_b, M, ldq, s);
}

}  // namespace

// C interface, loaded with ctypes.  Sweeps one band: `fresh` (M, T*n_b),
// the transposed factors `qt` (T, n_b + k_b, ldq), `init` (M, k_b) into
// `out` (M, T*n_b), all in one type; launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a width past 256 or an ldq that is not a
// multiple of kVec at least n_b + k_b.
extern "C" int rotseq_mxu_bf16(const __nv_bfloat16* fresh,
                               const __nv_bfloat16* qt,
                               const __nv_bfloat16* init, __nv_bfloat16* out,
                               int tiles, int n_b, int k_b, int M, int ldq,
                               void* stream) {
  return rotseq_mxu_half(fresh, qt, init, out, tiles, n_b, k_b, M, ldq,
                         stream);
}

extern "C" int rotseq_mxu_f16(const __half* fresh, const __half* qt,
                              const __half* init, __half* out, int tiles,
                              int n_b, int k_b, int M, int ldq,
                              void* stream) {
  return rotseq_mxu_half(fresh, qt, init, out, tiles, n_b, k_b, M, ldq,
                         stream);
}
