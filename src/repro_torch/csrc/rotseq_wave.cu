// Wavefront application of a rotation sequence as a band pipeline across
// warps (float32, sm_90a).
//
// Replaces: src/repro/kernels/rotseq/kernel.py::rotseq_wave_pallas (body
// _wave_kernel), the paper's SS3 register-reuse kernel with SS4 packing and
// SS5 blocking.
//
// What it computes, on the packed operand AT (n, M) (columns of A as rows
// here): the blocked sweep of rot_sequence_blocked at k_b = KB.  The K
// waves walk in bands of KB; a band applies its waves to every row of A
// before the next band starts, each band's carry kept on chip.  Within a
// band, step t applies plane j = t - 2i of band wave i; the KB planes of a
// step touch disjoint column pairs and every plane's predecessors ran at
// earlier steps, so each plane sees the values it sees in the sequential
// order.  All of one application is one launch.
//
// What bounds it on an H100: 6 flops a plane, 6*M*(n-1)*K in all (67
// TFLOP/s of float32: 0.238 ms at M = n = 3840, K = 180); the bytes (AT in
// and out, the panels) take less.  Issued instructions bound it in
// practice: a plane is at least 8 (one broadcast float4 load from shared
// memory, 5 rounded products, 2 rounded sums), more with each chunk's
// share of staging, hand-offs and window moves.
//
// The design.  Rows alone cannot fill the card (M = 3840 rows are 120
// warps for its 528 schedulers), a window in shared memory costs a load
// and a store a plane, and a launch a band repacks the operands on the
// host each time.  So:
//
// 1. The register window (as in rotseq_batched.cu).  One lane owns one
//    row.  A warp walks one band in steps; step t touches columns
//    t-W+2 .. t+1, W = 2*KB, held in registers.  Steps run in chunks of
//    CS = min(W, 128/KB) steps (128 planes), aligned to multiples of CS,
//    with the chunk body unrolled: at the start of chunk tc, column c
//    sits in slot (c - tc) mod W, so every slot index is a compile-time
//    constant, and the window rotates by CS slots at the end of a chunk.
//    Step t takes column t+1 in and finishes column t-W+2.  The c/s/g of
//    a chunk are read from the wave-major panels (K, n-1) and staged into
//    shared memory with cp.async one chunk ahead, one broadcast float4
//    {c, s, g, -} a plane; no sheared copy is built.
//
// 2. The band pipeline.  A block is one group of 32 rows, run by NW
//    warps.  In pass q warp w applies band q*NW + w.  Warp w finishes
//    column c at its step c+W-2 and hands it to warp w+1 through a ring of
//    R columns in shared memory, ring[w+1][c mod R][lane]; warp w+1 takes
//    column c in at its step c-1.  Warp 0 takes its columns from memory
//    (AT in the first pass, `out` after), staged into ring[0] a chunk
//    ahead with cp.async; the pass's last warp stores to `out`.  All warps
//    move in lockstep, one __syncthreads a chunk: at iteration s, warp w
//    runs its chunk s - L*w.  The lag L = ceil((W-1)/CS) + 1 chunks is the
//    least that puts a column's hand-off at an earlier iteration than its
//    take-in (W-1 steps lie between them); R = 32 columns is enough that
//    no slot is written again before it is read.  A pass ends with a
//    block barrier; the next pass reads the row group's columns back from
//    `out` in place (warp 0 reads column c many iterations before the
//    pass's last warp writes it, and rows belong to one block only).
//    Warps past the last band of a pass only keep the barriers.
//    tests/test_torch_wave.py walks this schedule on the CPU, ring tags
//    and all, and holds it to the plain version bit for bit.
//
// Planes outside the grid, chosen so that the result equals the blocked
// plain version bit for bit (signed zeros included):
//   * waves past K in the last band, and planes j >= n-1 or -i <= j < 0,
//     are the identity c = 1, s = 0, g = -1 (as pack_sheared pads them),
//     on columns outside 0 .. n-1 that start each band at +0;
//   * planes j < -i do not exist in the blocked sweep (its tiles start at
//     u = j + i = 0); they run here at steps t < i on columns that are
//     still +0 and get c = 1, s = 0, g = +1, which maps (+0, +0) to
//     (+0, +0).
// Past the right edge the kernel's plane set differs from the blocked
// sweep's only in planes that no output column depends on.
//
// Plane form: exactly repro_torch.core.rotations.plane_update, each
// product and sum rounded on its own (__fmul_rn etc. are never contracted
// into an FMA).
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// waves a band and warps a block: repro_torch.kernels.limits WAVE_KB and
// WAVE_WARPS must equal kBand and kWarps.  A warp alone applies a plane
// only every ~13 ns, several times its ~8 instructions' issue time, so
// more warps a row group hide the latency: at the paper shape (12 bands) 12 warps ran the
// launch in 1.64 ms on an H100, against 2.52, 2.27 and 2.04 ms for 4, 6
// and 8; 16 ran no faster, and 256-plane chunk bodies ran slower
// (tools/wave_sweep.py).
constexpr int kBand = 16;
constexpr int kWarps = 12;
// planes in the unrolled body of one chunk
constexpr int kChunkPlanes = 128;
// columns in each warp's input ring
constexpr int kRing = 32;

// Grid: one block a group of 32 rows, NW warps.  `at`/`out` are (n, M),
// the panels (K, n-1) wave-major (K*(n-1) < 2^31).  One block an SM is
// enough (the row groups fill the card: 120 of 132 SMs at M = 3840), and
// with that bound ptxas keeps the window and the row pointers in
// registers.
template <int KB, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
rotseq_wave_kernel(const float* at, const float* __restrict__ cw,
                   const float* __restrict__ sw,
                   const float* __restrict__ gw, float* out, int n, int M,
                   int K) {
  constexpr int W = 2 * KB;                     // the register window
  constexpr int CS =                            // steps a chunk
      kChunkPlanes / KB < W ? kChunkPlanes / KB : W;
  constexpr int L = (W - 1 + CS - 1) / CS + 1;  // lag between warps, chunks
  constexpr int R = kRing;
  constexpr int Q = KB * CS / 32;               // panel elements a lane
  static_assert(W % CS == 0 && KB * CS % 32 == 0, "chunk shape");
  static_assert((R & (R - 1)) == 0, "ring size a power of two");
  // a hand-off slot is written again only after its take-in, and warp 0's
  // staged columns outlive their chunk
  static_assert((R + W - 1) / CS >= L + 1 && R >= 3 * CS, "ring size");
  // Dynamic shared memory (wave_smem_bytes): per warp, three chunks of
  // plane values in flight (chunk kw is read from slot kw % 3 while chunk
  // kw + 1 lands in the next; slot kw % 3 is written again only after the
  // barrier that opens chunk kw + 2), then per warp the ring of columns
  // it takes in.
  extern __shared__ float4 smem[];
  float4(*panel)[3][KB][CS] =                   // {c, s, g, -}
      reinterpret_cast<float4(*)[3][KB][CS]>(smem);
  float(*ring)[R][32] =
      reinterpret_cast<float(*)[R][32]>(smem + NW * 3 * KB * CS);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * 32 + lane;
  const bool live_row = row < M;
  const int J = n - 1;
  const int bands = (K + KB - 1) / KB;
  const int NC = (n + W - 2 + CS - 1) / CS;     // chunks a band
  const size_t ld = (size_t)M;                  // column stride of a row
  float(*rin)[32] = ring[w];
  float(*rout)[32] = ring[w + 1 < NW ? w + 1 : 0];
  float win[W];

  for (int q0 = 0; q0 < bands; q0 += NW) {      // passes
    const int last = min(NW, bands - q0) - 1;   // the pass's last warp
    const bool busy = w <= last;
    const bool to_out = w == last;
    const float* from = (q0 == 0 ? at : out) + row;
    float* dst = out + row;
    // what a lane's panel elements need besides the chunk start tc: plane
    // (j = tc + d, p), panel offset off + tc, identity from wave i on
    int d[Q], off[Q], wave[Q];
    bool pv[Q];
#pragma unroll
    for (int e4 = 0; e4 < Q; ++e4) {
      const int e = lane + 32 * e4;
      const int i = e / CS;
      const int p = (q0 + w) * KB + i;
      d[e4] = e % CS - 2 * i;
      wave[e4] = i;
      pv[e4] = p < K;
      off[e4] = pv[e4] ? p * J + d[e4] : 0;
    }
    const int S = NC + L * last;                // iterations of the pass
    for (int s = -1; s < S; ++s) {
      const int kw = s - L * w;                 // this warp's chunk
      const bool stage = busy && kw + 1 >= 0 && kw + 1 < NC;
      if (stage) {
        const int kn = kw + 1;
        const int tc = kn * CS;
        float4(*pb)[CS] = panel[w][kn % 3];
#pragma unroll
        for (int e4 = 0; e4 < Q; ++e4) {
          const int e = lane + 32 * e4;
          float4* dp = &pb[e / CS][e % CS];
          const int j = tc + d[e4];
          if (pv[e4] && j >= 0 && j < J) {
            __pipeline_memcpy_async(&dp->x, cw + off[e4] + tc, sizeof(float));
            __pipeline_memcpy_async(&dp->y, sw + off[e4] + tc, sizeof(float));
            __pipeline_memcpy_async(&dp->z, gw + off[e4] + tc, sizeof(float));
          } else {
            *dp = make_float4(1.f, 0.f, j < -wave[e4] ? 1.f : -1.f, 0.f);
          }
        }
        if (w == 0 && live_row) {
          // columns tc+1 .. tc+CS (and column 0 ahead of the first chunk)
          for (int col = kn == 0 ? 0 : tc + 1; col <= tc + CS && col < n;
               ++col) {
            __pipeline_memcpy_async(&rin[col & (R - 1)][lane],
                                    from + col * ld, sizeof(float));
          }
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      if (!busy || kw < 0 || kw >= NC) continue;

      const int tc = kw * CS;
      const float4(*pb)[CS] = panel[w][kw % 3];
      if (kw == 0) {
        // before step 0 the window holds columns -W+2 .. 0
#pragma unroll
        for (int q = 0; q < W - 1; ++q) win[(q + 2) % W] = 0.f;
        win[0] = rin[0][lane];
      }
      float* sp = dst + (long long)(tc - W + 2) * M;  // column t-W+2 out
#pragma unroll
      for (int u = 0; u < CS; ++u, sp += ld) {
        const int t = tc + u;
        const float v = rin[(t + 1) & (R - 1)][lane];
        win[(u + 1) % W] = t + 1 < n ? v : 0.f;  // column t+1
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          const float4 c = pb[i][u];            // plane (t - 2i, band wave i)
          float& x = win[(u - 2 * i + 2 * W) % W];
          float& y = win[(u - 2 * i + 1 + 2 * W) % W];
          const float xn = __fadd_rn(__fmul_rn(c.x, x), __fmul_rn(c.y, y));
          const float yn =
              __fmul_rn(c.z, __fsub_rn(__fmul_rn(c.y, x), __fmul_rn(c.x, y)));
          x = xn;
          y = yn;
        }
        const int co = t - W + 2;               // finished at this step
        const float f = win[(u + 2) % W];
        if (to_out) {
          if (live_row && co >= 0 && co < n) *sp = f;
        } else if (co >= 0) {
          rout[co & (R - 1)][lane] = f;
        }
      }
      if (CS < W) {                             // slots relative to tc + CS
        float next[W];
#pragma unroll
        for (int q = 0; q < W; ++q) next[q] = win[(q + CS) % W];
#pragma unroll
        for (int q = 0; q < W; ++q) win[q] = next[q];
      }
    }
    __syncthreads();  // the pass's stores land before the next pass reads
  }
}

}  // namespace

// C interface, loaded with ctypes.  Applies all K waves of the panels to
// the packed operand `at` (n, M) into `out` (n, M) in one launch on
// `stream`; does not synchronise and allocates nothing; returns
// cudaGetLastError().  The caller handles K == 0 and n < 2 (no planes).
extern "C" int rotseq_wave_f32(const float* at, const float* cw,
                               const float* sw, const float* gw, float* out,
                               int n, int M, int K, void* stream) {
  constexpr int CS = kChunkPlanes / kBand < 2 * kBand ? kChunkPlanes / kBand
                                                      : 2 * kBand;
  constexpr int smem =
      kWarps * (3 * kBand * CS * (int)sizeof(float4) +
                kRing * 32 * (int)sizeof(float));
  auto kernel = rotseq_wave_kernel<kBand, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + 31) / 32;
  kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      at, cw, sw, gw, out, n, M, K);
  return (int)cudaGetLastError();
}
