// Accumulated (rs_gemm) application of one band of plane rotations in
// bfloat16 or float16 on the tensor cores (wgmma, float32 sums), sm_90a.
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
// factors come in T, built outside the kernel by one half-precision
// rotseq_batched launch a band (kernels/rotseq_mxu/ops.py::band_factors),
// as that launch leaves them: transposed, qt[t][j][i] = Q_t[i][j], which
// is the K-major B operand wgmma reads (repacked by the wrapper only
// where k_b or w is not a multiple of kVec: TMA reads from 16-byte
// aligned coordinates and strides).
//
// What bounds it on an H100: 2*m*w*w flops a tile, 3.1e10 at the paper's
// shape (n_b = k_b = 128, m = n = 3840, k = 180): 0.032 ms at 989 TFLOP/s
// of dense bf16/f16; the bytes (fresh in and the result out once a band,
// 2 bytes a value, and the factors) take about as long, 0.04 ms at 3.35
// TB/s.  The tiles of a band form a chain, so the only parallelism is
// over rows: 60 row tiles of 64 at the paper shape, each a chain of steps
// whose latency, not the card's rates, sets the time.  A step streams all
// of Q_t (128 KB at w = 256) through shared memory for only 64 rows, and
// wgmma reads both operands from there: about 100 bytes a clock, near
// shared memory's 128, against the tensor cores' 2048 multiply-adds.
//
// Design (one block: kRows = 64 rows of A, wgmma's M; the tiles in order;
// the carry on chip):
// - Products by wgmma.mma_async m64nNk16, float32 accumulators.  A =
//   [carry | fresh_t] and B = Q_t^T both come from shared memory in the
//   128-byte swizzled K-major layout TMA writes, in chunks of kChunk = 64
//   K columns (one swizzle row).  Two consumer warpgroups split Y_t's
//   columns: warpgroup g computes [g*WP/2, (g+1)*WP/2) for all 64 rows (64
//   accumulators a thread at WP = 256).  Split there, not between the
//   blocks of a cluster, the carry both halves need moves through the
//   block's own shared memory and one named barrier, never through
//   distributed shared memory on the chain; the cost is 60 busy SMs of
//   132 at the paper shape (the cluster split was not tried).
// - A TMA ring of kStages chunks of Q_t (WP rows x kChunk K) with a full
//   and an empty mbarrier a slot, filled by one producer warp.  Blocks run
//   in clusters of kCluster on the same chunks: each block's producer
//   loads its half of a chunk's rows and multicasts it to both blocks, so
//   L2 serves each chunk once a cluster.  A consumer warp, done with a
//   chunk, arrives on the slot's empty barrier in both blocks; the
//   producer refills a slot once all of them have.  fresh_t comes by TMA
//   too, into one of two X buffers (its own full/empty barriers), a tile
//   ahead.  The producer warpgroup hands its registers to the consumers
//   (setmaxnreg): at launch a thread of a 384-thread block has 168.
// - A tile's chunks run fresh first, then carry; only the carry waits on
//   the tile before.  Step t: carry_t @ Q_t[:k_b] into the accumulators
//   that hold fresh_t @ Q_t[k_b:]; Y_t summed in float32 and rounded to T
//   once; its carry columns written to the other X buffer (the one tile
//   t + 1 reads, so no write meets a read), its first n_b columns stored
//   (a quad's 4 x 4 transpose by butterfly shuffles makes 16-byte stores,
//   rows past M dropped); then fresh_{t+1}'s products, overwriting the
//   accumulators, run while the warpgroups meet at the named barrier.
//   Measured on the card: with the stores or the carry's writes issued
//   while products were in flight, they queued behind the products'
//   shared-memory reads and the accumulators' live ranges spilled, and
//   the step was no faster.
// - No wgmma group is in flight across a merge of control flow, each
//   chunk's four k16 steps sit between an explicit fence and their commit
//   in one basic block, and an mbarrier is polled inside PTX: otherwise
//   the compiler adds a fence or commit of its own and serialises every
//   wgmma of the kernel (ptxas notes C7515, C7520).
// - Ragged shapes: X's columns past k_b (carry) and n_b (fresh) are zeros
//   (zeroed once, or TMA's zero fill), and so are qt's past kq + n_b (the
//   wrapper's padding to ldq, then TMA's zero fill), so the padded depth
//   adds +0 terms; rows past M read as zeros.  Where TMA cannot describe
//   fresh (n_b not a multiple of kVec, or fresh or out not 16-byte
//   aligned) the producer warp copies it element by element into the same
//   swizzled layout, and out is stored element by element.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

// rows of A a block: wgmma's M
constexpr int kRows = 64;
// K columns of a shared-memory chunk: one 128-byte swizzle row of T
constexpr int kChunk = 64;
// chunks of Q_t in the TMA ring
constexpr int kStages = 4;
// blocks a cluster sharing each chunk of Q_t (TMA multicast)
constexpr int kCluster = 2;
// elements of T in one 16-byte piece: TMA's row strides are multiples
// (repro_torch.kernels.limits.MXU_HALF_VEC)
constexpr int kVec = 8;
// consumer warpgroups a block, each its share of Y_t's columns
constexpr int kGroups = 2;
static_assert(kRows == 64, "one wgmma M a warpgroup");

constexpr int kConsumers = 128 * kGroups;   // wgmma threads
// registers a thread after setmaxnreg: the consumer warpgroups take what
// the producer warp gives up, within the SM's 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumers * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "registers of the SM");
constexpr int kXChunkBytes = kRows * kChunk * 2;

template <int WP>
struct Shape {
  static constexpr int kN = WP / kGroups;        // columns a warpgroup
  static constexpr int kAcc = kN / 2;            // accumulators a thread
  static constexpr int kQBytes = WP * kChunk * 2;  // a chunk of Q_t^T
  // X = [carry | fresh_t]: ceil(k_b/64) + ceil(n_b/64) <= WP/64 + 1 chunks
  static constexpr int kXBytes = (WP / kChunk + 1) * kXChunkBytes;
  // and the producer warpgroup, of which one warp works
  static constexpr int kThreads = kConsumers + 128;
  static constexpr size_t kSmem = 1024 + (size_t)kStages * kQBytes +
                                  2ull * kXBytes + 8 * (2 * kStages + 4);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of (row r, column c) in a run of swizzled chunks: 128 bytes
// a row, 16-byte pieces XORed with the row's low 3 bits, as TMA's
// SWIZZLE_128B writes from a 1024-byte aligned base and wgmma reads
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)((c >> 6) * kXChunkBytes + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1));
}

// a chunk that never lands (a fault in the schedule) aborts the launch
// with an error after some seconds instead of hanging the card.  The
// polling loop is PTX's own, so that the compiler sees no divergent
// branch between the wgmma instructions around a wait.
constexpr uint32_t kMaxTries = 1u << 26;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @p bra DONE;\n"
      " add.u32 n, n, 1;\n"
      " setp.ne.u32 p, n, %2;\n"
      " @p bra WAIT;\n"
      " trap;\n"
      "DONE:\n}\n"
      :: "r"(bar), "r"(parity), "n"(kMaxTries) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// one warp's release of a ring slot: an arrival on that slot's empty
// barrier in every block of the cluster (its chunk lands in all of them)
__device__ __forceinline__ void release_slot(uint32_t bar) {
#pragma unroll
  for (int c = 0; c < kCluster; ++c)
    asm volatile(
        "{\n .reg .b32 remote;\n"
        " mapa.shared::cluster.u32 remote, %0, %1;\n"
        " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
        :: "r"(bar), "r"(c) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// shared-memory writes of the generic proxy, made visible to TMA and wgmma
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier of the consumer warpgroups alone (the producer never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint32_t dst, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_multicast(const CUtensorMap* map,
                                              uint32_t dst, uint32_t bar,
                                              int c0, int c1, int c2) {
  const uint16_t mask = (uint16_t)((1u << kCluster) - 1u);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], "
      "[%5], %6;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(bar), "h"(mask)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major, 128-byte swizzled
// operand at `addr` (1024-byte aligned atoms of 8 rows): stride 1024
// bytes between 8-row groups; a k16 step further is 32 bytes, +2
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// the accumulators are neither read before nor moved past a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// a wgmma's accumulator operands: read and written ("+f"), or only
// written ("=f": the product overwrites them, so their old values are
// dead and free their registers for what runs before it)
#define ROTSEQ_F4(c, i) c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3])
#define ROTSEQ_F16(c, i)                                           \
  ROTSEQ_F4(c, i), ROTSEQ_F4(c, i + 4), ROTSEQ_F4(c, i + 8),       \
      ROTSEQ_F4(c, i + 12)
#define ROTSEQ_WGMMA(N, PTX, SCALE, REGS, A, B, P, ...)                      \
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %" P ", 0;\n"             \
               " wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." PTX "."    \
               PTX " {" REGS "}, %" A ", %" B ", p, 1, 1, 0, 0;\n}\n"        \
               : __VA_ARGS__                                                \
               : "l"(a), "l"(b), "r"(SCALE))

#define ROTSEQ_R16 "%0, %1, %2, %3, %4, %5, %6, %7, " \
                   "%8, %9, %10, %11, %12, %13, %14, %15"
#define ROTSEQ_R32 ROTSEQ_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, " \
                   "%24, %25, %26, %27, %28, %29, %30, %31"
#define ROTSEQ_R64 ROTSEQ_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, " \
                   "%40, %41, %42, %43, %44, %45, %46, %47, "              \
                   "%48, %49, %50, %51, %52, %53, %54, %55, "              \
                   "%56, %57, %58, %59, %60, %61, %62, %63"

// the instruction in T's PTX type
#define ROTSEQ_WGMMA_T(N, SCALE, REGS, A, B, P, ...)                       \
  if constexpr (std::is_same_v<T, __half>)                                 \
    ROTSEQ_WGMMA(N, "f16", SCALE, REGS, A, B, P, __VA_ARGS__);             \
  else                                                                     \
    ROTSEQ_WGMMA(N, "bf16", SCALE, REGS, A, B, P, __VA_ARGS__)

// d = A (64 x 16, descriptor a) @ B (16 x N, descriptor b), plus d unless
// kZero.  The three widths of a warpgroup's share of Y_t.
template <typename T, bool kZero>
__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a,
                                      uint64_t b) {
  if constexpr (kZero) {
    ROTSEQ_WGMMA_T(32, 0, ROTSEQ_R16, "16", "17", "18", ROTSEQ_F16("=f", 0));
  } else {
    ROTSEQ_WGMMA_T(32, 1, ROTSEQ_R16, "16", "17", "18", ROTSEQ_F16("+f", 0));
  }
}

template <typename T, bool kZero>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a,
                                      uint64_t b) {
  if constexpr (kZero) {
    ROTSEQ_WGMMA_T(64, 0, ROTSEQ_R32, "32", "33", "34", ROTSEQ_F16("=f", 0),
                   ROTSEQ_F16("=f", 16));
  } else {
    ROTSEQ_WGMMA_T(64, 1, ROTSEQ_R32, "32", "33", "34", ROTSEQ_F16("+f", 0),
                   ROTSEQ_F16("+f", 16));
  }
}

template <typename T, bool kZero>
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a,
                                      uint64_t b) {
  if constexpr (kZero) {
    ROTSEQ_WGMMA_T(128, 0, ROTSEQ_R64, "64", "65", "66", ROTSEQ_F16("=f", 0),
                   ROTSEQ_F16("=f", 16), ROTSEQ_F16("=f", 32),
                   ROTSEQ_F16("=f", 48));
  } else {
    ROTSEQ_WGMMA_T(128, 1, ROTSEQ_R64, "64", "65", "66", ROTSEQ_F16("+f", 0),
                   ROTSEQ_F16("+f", 16), ROTSEQ_F16("+f", 32),
                   ROTSEQ_F16("+f", 48));
  }
}

// two float32 sums rounded to T once each, packed (lower column low)
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  uint32_t v;
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 h = __floats2half2_rn(lo, hi);
    memcpy(&v, &h, 4);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    memcpy(&v, &h, 4);
  }
  return v;
}

// the 4 x 4 transpose of a quad's (4 lanes') 32-bit values: lane q holds
// v[i] = item (i, q) before and item (q, i) after; two rounds of
// butterfly shuffles and selects, no branch
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool odd = q & 1, high = q & 2;
  uint32_t a = odd ? v[0] : v[1], b = odd ? v[2] : v[3];
  a = __shfl_xor_sync(0xffffffffu, a, 1);
  b = __shfl_xor_sync(0xffffffffu, b, 1);
  if (odd) {
    v[0] = a;
    v[2] = b;
  } else {
    v[1] = a;
    v[3] = b;
  }
  a = high ? v[0] : v[2];
  b = high ? v[1] : v[3];
  a = __shfl_xor_sync(0xffffffffu, a, 2);
  b = __shfl_xor_sync(0xffffffffu, b, 2);
  if (high) {
    v[0] = a;
    v[1] = b;
  } else {
    v[2] = a;
    v[3] = b;
  }
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* m) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(m)) : "memory");
}

// One consumer warpgroup's state and steps: its accumulators, Y_t rounded
// in pairs, where it stands in the ring.
template <typename T, int WP>
struct Group {
  using S = Shape<WP>;
  float acc[S::kAcc];
  uint32_t yv[S::kAcc / 2];   // Y_t rounded: [2j + h] rows r0 + 8h
  int lane, q, r0, n0;
  uint32_t ring_b;            // B: this group's rows of ring slot 0
  uint32_t full, empty;       // the ring's barriers
  int i;                      // ring position of the next chunk

  // one chunk's four k16 steps, between an explicit fence and their
  // commit, in one basic block (a fence or commit the compiler has to add
  // itself, at a merge of control flow, serialises every wgmma of the
  // kernel); with kZero the first overwrites the accumulators
  template <bool kZero>
  __device__ __forceinline__ void chunk(uint32_t xa, int s) {
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const uint64_t da = desc(xa);
    const uint64_t db = desc(ring_b + s * S::kQBytes);
    if constexpr (!kZero) fence_regs(acc);
    wg_fence();
    wgmma<T, kZero>(acc, da, db);
#pragma unroll
    for (int k = 1; k < kChunk / 16; ++k)
      wgmma<T, false>(acc, da + 2 * k, db + 2 * k);
    wg_commit();
    ++i;
  }

  // the chunks of one segment of a tile: X's chunks from x0 against the
  // ring's next ones, all kChunk K columns of each (past the segment's
  // depth both operands are zeros), a commit group each; kZero starts
  // the sums from zero
  template <bool kZero>
  __device__ __forceinline__ void issue(uint32_t x0, int chunks) {
    chunk<kZero>(x0, i % kStages);
    for (int j = 1; j < chunks; ++j)
      chunk<false>(x0 + j * kXChunkBytes, i % kStages);
    fence_regs(acc);
  }

  // every group issued is done, and the accumulators hold its sums
  __device__ __forceinline__ void wait_all() {
    wg_wait_all();
    fence_regs(acc);
  }

  // this warp is done with ring positions [first, first + count), and
  // with X's fresh columns where `fresh_empty` is not 0
  __device__ __forceinline__ void release(int first, int count,
                                          uint32_t fresh_empty) {
    __syncwarp();
    if (lane == 0) {
      for (int p = first; p < first + count; ++p)
        release_slot(empty + 8 * (p % kStages));
      if (fresh_empty) mbar_arrive(fresh_empty);
    }
  }

  __device__ __forceinline__ void round() {
#pragma unroll
    for (int j = 0; j < S::kN / 8; ++j) {
      yv[2 * j] = pack<T>(acc[4 * j], acc[4 * j + 1]);
      yv[2 * j + 1] = pack<T>(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }

  // Y_t's columns [0, n_b) of rows below M to out: 16-byte pieces after a
  // quad transpose with vec, else element by element
  __device__ __forceinline__ void store_out(T* out, int t, int n_b, int U,
                                            int row0, int M, int vec) {
    if (vec) {
      T* dst = out + (size_t)t * n_b;
#pragma unroll
      for (int m = 0; m < S::kN / 32; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = yv[2 * (4 * m + e) + h];
          quad_transpose(v, q);
          const int col = n0 + 8 * (4 * m + q);
          const int row = row0 + r0 + 8 * h;
          if (col < n_b && row < M)
            *reinterpret_cast<uint4*>(dst + (size_t)row * U + col) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    } else {
      uint16_t* o16 = reinterpret_cast<uint16_t*>(out);
#pragma unroll
      for (int j = 0; j < S::kN / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * j + 2 * q;
          const int row = row0 + r0 + 8 * h;
          if (row < M) {
            const size_t at = (size_t)row * U + (size_t)t * n_b + col;
            if (col < n_b) o16[at] = (uint16_t)(yv[2 * j + h] & 0xffffu);
            if (col + 1 < n_b) o16[at + 1] = (uint16_t)(yv[2 * j + h] >> 16);
          }
        }
      }
    }
  }

  // Y_t's columns [n_b, w) into the carry chunks of the X buffer at xc:
  // with n_b a multiple of 8, whole 8-column blocks (a block is carry or
  // not for the whole warpgroup; columns past w are +0 and land in the
  // carry's zero padding), else element by element
  __device__ __forceinline__ void write_carry(unsigned char* xc, int n_b,
                                              int w) {
    if (n_b % 8 == 0) {
#pragma unroll
      for (int j = 0; j < S::kN / 8; ++j) {
        const int col = n0 + 8 * j;   // the block's first column
        if (col >= n_b && col < w) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(
                xc + swz(r0 + 8 * h, col - n_b + 2 * q)) = yv[2 * j + h];
        }
      }
      return;
    }
#pragma unroll
    for (int j = 0; j < S::kN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + 8 * j + 2 * q;
        const int r = r0 + 8 * h;
        const uint32_t v = yv[2 * j + h];
        if (col >= n_b && col < w)
          *reinterpret_cast<uint16_t*>(xc + swz(r, col - n_b)) =
              (uint16_t)(v & 0xffffu);
        if (col + 1 >= n_b && col + 1 < w)
          *reinterpret_cast<uint16_t*>(xc + swz(r, col + 1 - n_b)) =
              (uint16_t)(v >> 16);
      }
    }
  }
};

// Grid: one block a group of kRows rows of A, in clusters of kCluster.
// qm is the TMA map of qt (T, w, ldq), fm of fresh as (M, T, n_b) when
// vec.  fresh/out (M, T*n_b), init (M, k_b).
template <typename T, int WP>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(Shape<WP>::kThreads, 1)
    rotseq_mxu_half_kernel(const __grid_constant__ CUtensorMap qm,
                           const __grid_constant__ CUtensorMap fm,
                           const T* __restrict__ fresh,
                           const T* __restrict__ init, T* __restrict__ out,
                           int tiles, int n_b, int k_b, int M, int vec) {
  using S = Shape<WP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring and X 1024-byte aligned (swizzle atoms), by an offset from
  // the shared array, so that every access stays a shared-memory one
  unsigned char* ring =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* xbuf = ring + kStages * S::kQBytes;   // X[2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xbuf + 2 * S::kXBytes);
  const uint32_t full = smem_u32(bars);               // ring slot landed
  const uint32_t empty = full + 8 * kStages;          // ring slot read
  const uint32_t ffull = empty + 8 * kStages;         // X[b]'s fresh landed
  const uint32_t fempty = ffull + 16;                 // X[b]'s fresh read

  const int w = n_b + k_b;
  const int kc = (k_b + kChunk - 1) / kChunk;   // carry chunks a tile
  const int kf = (n_b + kChunk - 1) / kChunk;   // fresh chunks a tile
  const int kq = (k_b + kVec - 1) / kVec * kVec;  // qt's first fresh column
  const int U = tiles * n_b;
  const int row0 = blockIdx.x * kRows;
  const uint32_t rank = cluster_rank();
  const int tid = threadIdx.x;
  // the warp's index as a warp-uniform value: the roles below branch on
  // it, and the compiler keeps wgmma pipelined only outside paths it
  // thinks divergent
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32 * kCluster);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(ffull + 8 * b, vec ? 1 : 32);
      mbar_init(fempty + 8 * b, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    prefetch_map(&qm);
    if (vec) prefetch_map(&fm);
  }
  if (warp < kConsumers / 32) {
    // X zeroed (columns and rows past the data stay +0), then the carry
    for (int i = tid; i < 2 * S::kXBytes / 16; i += kConsumers)
      reinterpret_cast<uint4*>(xbuf)[i] = make_uint4(0, 0, 0, 0);
    consumers_sync();
    const uint16_t* i16 = reinterpret_cast<const uint16_t*>(init);
    for (int i = tid; i < kRows * k_b; i += kConsumers) {
      const int r = i / k_b, c = i % k_b;
      if (row0 + r < M)
        *reinterpret_cast<uint16_t*>(xbuf + swz(r, c)) =
            i16[(size_t)(row0 + r) * k_b + c];
    }
    fence_async();
  }
  __syncthreads();
  // every block's barriers exist before any multicast reaches them
  cluster_sync();

  if (warp >= kConsumers / 32) {
    // the producer warpgroup gives up registers to the consumers (at
    // launch every thread has 168, too few for 64 accumulators and their
    // rounded pairs); its first warp is the producer: fresh_t into
    // X[t % 2], then Q_t's chunks, fresh rows first, into the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (warp == kConsumers / 32) {
      const int lane = tid & 31;
      const uint16_t* f16 = reinterpret_cast<const uint16_t*>(fresh);
      int i = 0;   // ring position
      for (int t = 0; t < tiles; ++t) {
        const int b = t & 1;
        unsigned char* xf = xbuf + b * S::kXBytes + kc * kXChunkBytes;
        if (t >= 2) mbar_wait(fempty + 8 * b, ((t >> 1) - 1) & 1);
        if (vec) {
          if (lane == 0) {
            mbar_expect(ffull + 8 * b, kf * kXChunkBytes);
            for (int j = 0; j < kf; ++j)
              tma_load(&fm, smem_u32(xf + j * kXChunkBytes), ffull + 8 * b,
                       j * kChunk, t, row0);
          }
        } else {
          for (int e = lane; e < kRows * n_b; e += 32) {
            const int r = e / n_b, c = e % n_b;
            if (row0 + r < M)
              *reinterpret_cast<uint16_t*>(xf + swz(r, c)) =
                  f16[(size_t)(row0 + r) * U + (size_t)t * n_b + c];
          }
          fence_async();
          mbar_arrive(ffull + 8 * b);
        }
        if (lane == 0)
          for (int j = 0; j < kf + kc; ++j, ++i) {
            const int s = i % kStages;
            if (i >= kStages)
              mbar_wait(empty + 8 * s, ((i / kStages) - 1) & 1);
            mbar_expect(full + 8 * s, S::kQBytes);
            tma_multicast(&qm,
                          smem_u32(ring + s * S::kQBytes +
                                   rank * (WP / kCluster) * 128),
                          full + 8 * s,
                          j < kf ? kq + j * kChunk : (j - kf) * kChunk,
                          (int)rank * (WP / kCluster), t);
          }
        __syncwarp();
      }
    }
    // no block leaves while a block of its cluster may still multicast to
    // it or arrive on its barriers
    cluster_sync();
    return;
  }

  // the consumers: warpgroup g owns Y_t's columns [n0, n0 + kN); lane l of
  // its warp v holds rows r0 = 16v + l/4 and r0 + 8, columns
  // n0 + 8j + 2q (+1), q = l % 4
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  Group<T, WP> c;
  c.lane = tid & 31;
  c.q = c.lane & 3;
  c.r0 = 16 * (warp & 3) + (c.lane >> 2);
  c.n0 = warp / 4 * S::kN;
  c.ring_b = smem_u32(ring) + c.n0 * 128;
  c.full = full;
  c.empty = empty;
  c.i = 0;
  const uint32_t x_a = smem_u32(xbuf);

  // No wgmma is in flight across the loop's back edge: the compiler
  // serialises every wgmma where the accumulators' live range crosses a
  // merge of control flow while a group is in flight.
  int first_f = c.i;
  mbar_wait(ffull, 0);
  c.template issue<true>(x_a + kc * kXChunkBytes, kf);   // fresh_0 @ Q_0
  c.wait_all();
  c.release(first_f, kf, fempty);
  for (int t = 0;; ++t) {
    const int first_c = c.i;
    // carry_t @ Q_t[:k_b]
    c.template issue<false>(x_a + (t & 1) * S::kXBytes, kc);
    c.wait_all();
    c.release(first_c, kc, 0);
    c.round();
    if (t + 1 == tiles) break;
    // while no product is in flight (the accumulators free for the
    // stores' registers): the carry of tile t + 1, then Y_t's output
    // columns, then fresh_{t+1}'s products
    const int b = (t + 1) & 1;
    c.write_carry(xbuf + b * S::kXBytes, n_b, w);
    fence_async();
    c.store_out(out, t, n_b, U, row0, M, vec);
    first_f = c.i;
    mbar_wait(ffull + 8 * b, ((t + 1) >> 1) & 1);
    c.template issue<true>(x_a + b * S::kXBytes + kc * kXChunkBytes, kf);
    consumers_sync();   // the carry of tile t + 1 in place
    c.wait_all();       // and its fresh products done
    c.release(first_f, kf, fempty + 8 * b);
  }
  c.store_out(out, tiles - 1, n_b, U, row0, M, vec);
  cluster_sync();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched through the runtime so the
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

// a 3D map of T with 128-byte swizzled boxes, zeros past its extents
template <typename T>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base,
            const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
            const cuuint32_t (&box)[3]) {
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map,
             std::is_same_v<T, __half> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int WP>
int launch(const T* fresh, const T* qt, const T* init, T* out, int tiles,
           int n_b, int k_b, int M, int ldq, cudaStream_t stream) {
  using S = Shape<WP>;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t w = (cuuint64_t)(n_b + k_b);
  const cuuint64_t qs[2] = {(cuuint64_t)ldq * 2, w * ldq * 2};
  const cuuint32_t qbox[3] = {kChunk, WP / kCluster, 1};
  CUtensorMap qm, fm;
  memset(&fm, 0, sizeof fm);
  if (!encode<T>(enc, &qm, qt, {(cuuint64_t)ldq, w, (cuuint64_t)tiles}, qs,
                 qbox))
    return (int)cudaErrorInvalidValue;
  const bool vec = n_b % kVec == 0 && (size_t)fresh % 16 == 0 &&
                   (size_t)out % 16 == 0;
  if (vec &&
      !encode<T>(enc, &fm, fresh,
                 {(cuuint64_t)n_b, (cuuint64_t)tiles, (cuuint64_t)M},
                 {(cuuint64_t)n_b * 2, (cuuint64_t)tiles * n_b * 2},
                 {kChunk, 1, kRows}))
    return (int)cudaErrorInvalidValue;
  auto kernel = rotseq_mxu_half_kernel<T, WP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (M + kRows - 1) / kRows;
  blocks = (blocks + kCluster - 1) / kCluster * kCluster;
  kernel<<<blocks, S::kThreads, S::kSmem, stream>>>(
      qm, fm, fresh, init, out, tiles, n_b, k_b, M, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int rotseq_mxu_half(const T* fresh, const T* qt, const T* init, T* out,
                    int tiles, int n_b, int k_b, int M, int ldq,
                    void* stream) {
  const int w = n_b + k_b;
  const int kq = (k_b + kVec - 1) / kVec * kVec;
  if (n_b < 1 || k_b < 1 || tiles < 1 || M < 1 || w > 256 ||
      ldq < kq + n_b || ldq % kVec != 0 || (size_t)qt % 16 != 0)
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
// synchronise and allocates nothing.  qt[t][j] holds Q_t[:k_b, j] in its
// columns [0, k_b) and Q_t[k_b:, j] in [kq, kq + n_b), kq = k_b rounded
// up to kVec (TMA reads from 16-byte aligned coordinates), zeros between
// and past: with k_b and w multiples of kVec, the factor launch's Q_t^T
// as it is.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// width past 256, an ldq that is not a multiple of kVec at least
// kq + n_b, or a qt that is not 16-byte aligned.
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
