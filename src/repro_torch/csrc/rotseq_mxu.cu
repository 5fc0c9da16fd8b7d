// Accumulated (rs_gemm) application of one band of plane rotations:
// IEEE float32 products on the CUDA cores (fmaf, no TF32), sm_90a.
//
// Replaces: src/repro/kernels/rotseq_mxu/kernel.py::rotseq_mxu_pallas (body
// _mxu_kernel).
//
// What it computes, natural layout: for each block of rows of A it walks
// the T tiles of the band in order, Y_t = [carry | fresh_t] (rows, w) @ Q_t
// (w, w) with w = k_b + n_b; Y_t[:, :n_b] is emitted and Y_t[:, n_b:] is
// the next carry, which never leaves the SM.  The tile factors Q_t are
// built outside the kernel (kernels/rotseq_mxu/ops.py::band_factors).
//
// What bounds it on an H100: 2*m*w*w flops a tile, 3.1e10 at the paper's
// shape (n_b = k_b = 128, m = n = 3840, k = 180), 0.47 ms at 67 TFLOP/s of
// float32 on the CUDA cores.  wgmma has no IEEE float32 mode, so the
// products are fmaf on the CUDA cores.  Next to the flops, every block
// reads all of Q_t: 256 KB a tile at w = 256.  The paper shape gives 120
// blocks of 32 rows, so 120 of 132 SMs work: blocks of 16 rows, two an
// SM, measured slower (tools/mxu_sweep.py).
//
// Design (one block: kRows rows of A, the tiles in order, the carry on
// chip):
// - Q_t streams through a ring of kStages slabs of kSlab rows in shared
//   memory, filled by TMA (cp.async.bulk.tensor, a full and an empty
//   mbarrier a slot).  Blocks run in clusters of kCluster on the same
//   slabs: each block's producer loads 1/kCluster of a slab and
//   multicasts it to every block of the cluster, so L2 serves each slab
//   once a cluster.
// - Warp specialised: the FMA warps wait on a slot's full barrier, and
//   each, done with slab j, arrives on the slot's empty barrier in every
//   block of the cluster; one producer warp waits there and refills the
//   slot with slab j + kStages at once, so a slot is never written while
//   a block of the cluster may read it and kStages - 1 slabs stay in
//   flight while the FMAs run.  (Refilled by an FMA thread after its own
//   next slab, the launch measured 18-29% slower; with a cluster barrier
//   a slab in place of the empty barriers, slower still.)
// - X = [carry | fresh_t] is double-buffered: tile t reads X[t % 2];
//   fresh_{t+1} is copied into X[(t+1) % 2] with cp.async at the start of
//   tile t, and tile t's carry is written there after its last slab.
//   That buffer's last reads were tile t - 1's, which the barrier at the
//   end of tile t - 1 closed, so neither write can meet a read.
// - A register micro-tile sized to the padded width WP (64, 128 or 256
//   columns, any w <= WP): warps of 4 row groups x 8 column groups, each
//   thread 4 rows x 8 columns (two float4 at 4*cg and WP/2 + 4*cg).  Per
//   4 k steps a warp issues 4 float4 X loads (4 distinct rows) and 8
//   float4 Q loads (8 distinct float4), free of bank conflicts, for 128
//   fmaf a thread.  The shared memory's 128 bytes a cycle and the 2 FMA
//   warps a scheduler hold the loop near half the FMA issue rate.
// Columns past w (TMA's zero fill of Q, zeroed X columns) add +0 terms.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;    // rows of A a block
constexpr int kSlab = 32;    // rows of Q_t a shared-memory slab
constexpr int kStages = 3;   // slabs in the ring
constexpr int kCluster = 2;  // blocks a cluster sharing each slab
constexpr int kTM = 4;       // rows a thread
constexpr int kRG = kRows / kTM;  // row groups: 4 a warp
constexpr int kRW = kRG / 4;      // warps along the rows
static_assert(kRows % (4 * kTM) == 0, "rows a block: whole warps");
static_assert(kSlab % (4 * kCluster) == 0, "a slab splits over the cluster");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a slab that never lands (a fault in the schedule) aborts the launch
// with an error after some seconds instead of hanging the card
constexpr uint32_t kMaxTries = 1u << 26;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == kMaxTries) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one warp's release of a slot: an arrival on that slot's empty barrier
// in every block of the cluster (its slab lands in all of them)
__device__ __forceinline__ void release_slot(uint32_t bar) {
#pragma unroll
  for (int c = 0; c < kCluster; ++c) {
    if constexpr (kCluster == 1) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(bar) : "memory");
    } else {
      asm volatile(
          "{\n .reg .b32 remote;\n"
          " mapa.shared::cluster.u32 remote, %0, %1;\n"
          " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
          :: "r"(bar), "r"(c) : "memory");
    }
  }
}

// a barrier of the N FMA threads alone (the producer warp never joins)
template <int N>
__device__ __forceinline__ void fma_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the producer: expect one slab on this block's slot barrier and load
// this block's share of it into every block of the cluster
__device__ __forceinline__ void issue_slab(const CUtensorMap* qmap,
                                           float* slot, uint32_t bar,
                                           int k0, int t, int wp,
                                           uint32_t rank) {
  constexpr int share = kSlab / kCluster;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(kSlab * wp * 4) : "memory");
  const uint32_t dst = smem_u32(slot + rank * share * wp);
  const uint64_t map = reinterpret_cast<uint64_t>(qmap);
  const int row = k0 + (int)rank * share;
  if constexpr (kCluster == 1) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
        :: "r"(dst), "l"(map), "r"(0), "r"(row), "r"(t), "r"(bar)
        : "memory");
  } else {
    const uint16_t mask = (uint16_t)((1u << kCluster) - 1u);
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], "
        "[%5], %6;\n"
        :: "r"(dst), "l"(map), "r"(0), "r"(row), "r"(t), "r"(bar),
           "h"(mask)
        : "memory");
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

template <int WP>
struct Shape {
  static constexpr int kCW = WP / 64;              // warps along columns
  static constexpr int kThreads = 32 * kCW * kRW;   // FMA threads
  static constexpr int kBlock = kThreads + 32;       // and the producer
  static constexpr int kXW = WP + 4;               // X row stride, floats
  static constexpr int kSlabFloats = kSlab * WP;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlabFloats * 4 + 2ull * kRows * kXW * 4 +
      2 * kStages * 8;
};

// fresh_t of this block's rows into columns k_b .. w of X (cp.async;
// rows past M read as zeros)
__device__ __forceinline__ void stage_fresh(float* X, const float* fresh,
                                            int t, int n_b, int k_b,
                                            int xw, int U, int row0, int M,
                                            bool vec, int nth) {
  if (vec) {
    const int q4 = n_b / 4;
    for (int idx = threadIdx.x; idx < kRows * q4; idx += nth) {
      const int r = idx / q4, c = 4 * (idx % q4);
      const bool ok = row0 + r < M;
      const float* src =
          ok ? fresh + (size_t)(row0 + r) * U + (size_t)t * n_b + c : fresh;
      cp_async16(X + r * xw + k_b + c, src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * n_b; idx += nth) {
      const int r = idx / n_b, c = idx % n_b;
      const bool ok = row0 + r < M;
      const float* src =
          ok ? fresh + (size_t)(row0 + r) * U + (size_t)t * n_b + c : fresh;
      cp_async4(X + r * xw + k_b + c, src, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// four k steps of the thread's micro-tile: X columns kx .. kx + 3 of its
// kTM rows against slab rows kq .. kq + 3 of its 8 columns
template <int WP>
__device__ __forceinline__ void fma_steps(float (&acc)[kTM][2][4],
                                          const float* X, const float* Qs,
                                          int rg, int cg, int kx, int kq) {
  constexpr int XW = Shape<WP>::kXW;
  float4 xv[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    xv[i] = *reinterpret_cast<const float4*>(X + (rg + kRG * i) * XW + kx);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 q0 =
        *reinterpret_cast<const float4*>(Qs + (kq + u) * WP + 4 * cg);
    const float4 q1 = *reinterpret_cast<const float4*>(
        Qs + (kq + u) * WP + WP / 2 + 4 * cg);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const float x = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                    : u == 2 ? xv[i].z : xv[i].w;
      acc[i][0][0] = fmaf(x, q0.x, acc[i][0][0]);
      acc[i][0][1] = fmaf(x, q0.y, acc[i][0][1]);
      acc[i][0][2] = fmaf(x, q0.z, acc[i][0][2]);
      acc[i][0][3] = fmaf(x, q0.w, acc[i][0][3]);
      acc[i][1][0] = fmaf(x, q1.x, acc[i][1][0]);
      acc[i][1][1] = fmaf(x, q1.y, acc[i][1][1]);
      acc[i][1][2] = fmaf(x, q1.z, acc[i][1][2]);
      acc[i][1][3] = fmaf(x, q1.w, acc[i][1][3]);
    }
  }
}

template <int WP>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(Shape<WP>::kBlock, 1)
    rotseq_mxu_kernel(const __grid_constant__ CUtensorMap qmap,
                      const float* __restrict__ fresh,
                      const float* __restrict__ init,
                      float* __restrict__ out, int T, int n_b, int k_b,
                      int M) {
  using S = Shape<WP>;
  constexpr int nth = S::kThreads;
  constexpr int XW = S::kXW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring 1024-byte aligned (TMA writes 128-byte aligned boxes), by
  // an offset from the shared array, so that the compiler keeps every
  // read of X and Q a shared-memory load (LDS), not a generic one
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  float* Xbuf = ring + kStages * S::kSlabFloats;     // [2][kRows][XW]
  uint64_t* full = reinterpret_cast<uint64_t*>(Xbuf + 2 * kRows * XW);
  uint64_t* empty = full + kStages;

  const int w = n_b + k_b;
  const int w4 = (w + 3) & ~3;
  const int U = T * n_b;
  const int NS = (w + kSlab - 1) / kSlab;   // slabs a tile
  const int J = T * NS;                      // slabs a band
  const int row0 = blockIdx.x * kRows;
  const uint32_t rank = kCluster == 1 ? 0u : cluster_rank();
  const bool vec = (n_b % 4 == 0) && (k_b % 4 == 0);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg = 8 * (warp % S::kCW) + (lane & 7);   // column group
  const int rg = 4 * (warp / S::kCW) + (lane >> 3);  // row group
  // the last warp is the producer; its lane 0 issues the slabs
  const bool producer = threadIdx.x >= nth;
  const bool issuer = threadIdx.x == nth;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(full + s)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                   :: "r"(smem_u32(empty + s)), "r"(nth / 32 * kCluster)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("prefetch.tensormap [%0];\n"
                 :: "l"(reinterpret_cast<uint64_t>(&qmap)) : "memory");
  }
  // X: zero the columns past w (never written), the initial carry, fresh_0
  if (!producer) {
    for (int idx = threadIdx.x; idx < 2 * kRows * (XW - w); idx += nth) {
      const int r = idx / (XW - w), c = w + idx % (XW - w);
      Xbuf[r * XW + c] = 0.0f;
    }
    for (int idx = threadIdx.x; idx < kRows * k_b; idx += nth) {
      const int r = idx / k_b, c = idx % k_b;
      const int row = row0 + r;
      Xbuf[r * XW + c] = row < M ? init[(size_t)row * k_b + c] : 0.0f;
    }
    stage_fresh(Xbuf, fresh, 0, n_b, k_b, XW, U, row0, M, vec, nth);
  }
  // every block's slot barriers exist before any multicast reaches them
  cluster_arrive();
  cluster_wait();
  if (producer) {
    // fill the ring, then refill each slot once every FMA warp of the
    // cluster has released the slab it held
    if (issuer)
      for (int i = 0; i < J; ++i) {
        const int ps = i % kStages;
        if (i >= kStages)
          mbar_wait(smem_u32(empty + ps), (uint32_t)((i / kStages - 1) & 1));
        issue_slab(&qmap, ring + ps * S::kSlabFloats, smem_u32(full + ps),
                   (i % NS) * kSlab, i / NS, WP, rank);
      }
    __syncwarp();
    cluster_arrive();
    cluster_wait();
    return;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  fma_sync<nth>();

  float acc[kTM][2][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;

  for (int j = 0; j < J; ++j) {
    const int t = j / NS;
    const int ks = j % NS;
    const int k0 = ks * kSlab;
    const float* X = Xbuf + (t & 1) * kRows * XW;
    if (ks == 0 && t + 1 < T)
      stage_fresh(Xbuf + ((t + 1) & 1) * kRows * XW, fresh, t + 1, n_b, k_b,
                  XW, U, row0, M, vec, nth);

    const int slot = j % kStages;
    mbar_wait(smem_u32(full + slot), (uint32_t)((j / kStages) & 1));
    const float* Qs = ring + slot * S::kSlabFloats;
    const int kend = min(kSlab, w4 - k0);
    if (kend == kSlab) {
      // a whole slab: a constant trip count, so the loads of later steps
      // are scheduled under the FMAs of earlier ones
#pragma unroll
      for (int kk = 0; kk < kSlab; kk += 4)
        fma_steps<WP>(acc, X, Qs, rg, cg, k0 + kk, kk);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < kend; kk += 4)
        fma_steps<WP>(acc, X, Qs, rg, cg, k0 + kk, kk);
    }
    // this warp is done with slab j's slot in every block of the cluster
    __syncwarp();
    if (lane == 0) release_slot(smem_u32(empty + slot));

    if (ks == NS - 1) {
      // Y_t: its first n_b columns out, the rest the carry of tile t + 1,
      // into the buffer that tile t + 1 reads (closed since tile t - 1)
      float* Xn = Xbuf + ((t + 1) & 1) * kRows * XW;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = rg + kRG * i;
        const int row = row0 + r;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = h * (WP / 2) + 4 * cg;
          if (vec) {
            const float4 v = make_float4(acc[i][h][0], acc[i][h][1],
                                         acc[i][h][2], acc[i][h][3]);
            if (c < n_b) {
              if (row < M)
                *reinterpret_cast<float4*>(out + (size_t)row * U +
                                           (size_t)t * n_b + c) = v;
            } else if (c < w && t + 1 < T) {
              *reinterpret_cast<float4*>(Xn + r * XW + c - n_b) = v;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ce = c + e;
              if (ce < n_b) {
                if (row < M)
                  out[(size_t)row * U + (size_t)t * n_b + ce] = acc[i][h][e];
              } else if (ce < w && t + 1 < T) {
                Xn[r * XW + ce - n_b] = acc[i][h][e];
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.0f;
        }
      }
      // fresh_{t+1} landed and the carry is written, for every thread
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      fma_sync<nth>();
    }
  }
  // no block leaves while a block of its cluster may still multicast to
  // it or arrive on its barriers
  cluster_arrive();
  cluster_wait();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, fetched through the runtime so the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int WP>
int launch(const float* fresh, const float* q, const float* init, float* out,
           int T, int n_b, int k_b, int M, int ldq, cudaStream_t stream) {
  using S = Shape<WP>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  // Q as (T, ldq, ldq), a box of one slab share: WP columns (zero past
  // ldq), kSlab / kCluster rows (zero past ldq) of one tile
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)ldq, (cuuint64_t)ldq,
                              (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)ldq * 4,
                                 (cuuint64_t)ldq * ldq * 4};
  const cuuint32_t box[3] = {(cuuint32_t)WP, (cuuint32_t)(kSlab / kCluster),
                             1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult cr = enc(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                    const_cast<float*>(q), dims, strides, box, estr,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  auto kernel = rotseq_mxu_kernel<WP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (M + kRows - 1) / kRows;
  blocks = (blocks + kCluster - 1) / kCluster * kCluster;
  kernel<<<blocks, S::kBlock, S::kSmem, stream>>>(map, fresh, init, out, T,
                                                    n_b, k_b, M);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns a cudaError_t.  Q is
// (T, ldq, ldq) with ldq a multiple of 4, n_b + k_b <= ldq, and zeros past
// n_b + k_b; n_b + k_b <= 256.
extern "C" int rotseq_mxu_f32(const float* fresh, const float* q,
                              const float* init, float* out, int T, int n_b,
                              int k_b, int M, int ldq, void* stream) {
  const int w = n_b + k_b;
  if (n_b < 1 || k_b < 1 || T < 1 || M < 1 || w > 256 || ldq < w ||
      ldq % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (w <= 64) return launch<64>(fresh, q, init, out, T, n_b, k_b, M, ldq, s);
  if (w <= 128)
    return launch<128>(fresh, q, init, out, T, n_b, k_b, M, ldq, s);
  return launch<256>(fresh, q, init, out, T, n_b, k_b, M, ldq, s);
}
