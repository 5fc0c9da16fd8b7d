// Wavefront application of a rotation sequence as a band pipeline across
// warps (float32, bfloat16 and float16, sm_90a).
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
//    CS = min(W, 128/KB) steps (128 planes at KB = 16), aligned to
//    multiples of CS,
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
//    no slot is written again before a barrier past its last read.  A
//    pass ends with a block barrier; the next pass reads the row group's
//    columns back from
//    `out` in place (warp 0 reads column c many iterations before the
//    pass's last warp writes it, and rows belong to one block only).
//    Warps past the last band of a pass only keep the barriers.
//    tests/test_torch_wave.py walks this schedule on the CPU, ring tags
//    and all, and holds it to the plain version bit for bit.
//
// 3. The small band.  At few waves (k_b = kSmallBand) the bands of a
//    pass would leave most warps of a row group idle, so they run as a
//    chain inside one warp instead, a (row, band) pair a lane, on every
//    SM: rotseq_wave_small_kernel below, walked on the CPU by the same
//    tests.
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
//
// Half precision (bfloat16, float16), as the reference's body takes them:
// the operand, its result and the rings are in the half type T, and c, s,
// g are rounded to T by the wrapper.  A plane computes each product and
// sum in float32 and rounds it to T before the next one uses it, which is
// what eager PyTorch does with half tensors, so the half instantiations
// equal the plain version bit for bit too.  Rounded one at a time, those
// 7 roundings set the pace (bfloat16's on F2F: 6.35 ms at the paper shape
// on an H100, against 1.65 in float32).  The half body takes the design
// half_store.cuh sets out for both band kernels: the register window is
// float32, every value in it T-exact (a column widened once as it comes
// in from its ring, narrowed once, exactly, as it is handed on or
// stored), and planes i and i+1 of a step are rounded together, every
// product, the sum, the difference and g's product as one native paired
// half op for the two (plane_pair_native: no conversion a plane in
// bfloat16, one in float16; 1.68 and 2.03 ms at the paper shape).  Its
// staging is off the plane path: cp.async moves 4 bytes at least, so a
// warp reads its next chunk's panel values into registers before the
// barrier and writes them to shared memory, as raw T bits, after its
// chunk's planes, and warp 0 stages its columns with cp.async in 16-byte
// pieces of eight rows when every column of the operand starts 16-byte
// aligned (by plain loads otherwise).  The rings stay in T: the shared
// memory is the same as before (kernels/limits.py::wave_smem_bytes).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "half_store.cuh"

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
// The small band (limits.WAVE_SMALL_KB), for few waves, is a kernel of its
// own, rotseq_wave_small_kernel below.  At k = 32 (an eigensolver's
// flush) kBand leaves 10 of a row group's 12 warps idle, and the band
// pipeline above run at bands of 4 paid a block barrier, staging and ring
// hand-offs every 32 planes on 32 of 132 SMs: 0.163 ms at k = 32,
// n = M = 1024 on an H100, 54 times its bound.
// On finite nonzero values the result does not depend on the band;
// signed zeros and inf or NaN can, through the pad planes of the last
// band (tests/test_torch_wave.py).
constexpr int kSmallBand = 4;
// the small band's warp: kSmallRows rows of A by kSmallBands bands, one
// (row, band) pair a lane (limits.WAVE_SMALL_ROWS, WAVE_SMALL_BANDS);
// kSmallWarps independent warps a block (limits.WAVE_SMALL_WARPS); plane
// values staged a chunk of kSmallChunk steps ahead
constexpr int kSmallRows = 4;
constexpr int kSmallBands = 8;
constexpr int kSmallWarps = 2;
constexpr int kSmallChunk = 16;
// planes in the unrolled body of one chunk
constexpr int kChunkPlanes = 128;
// columns in each warp's input ring
constexpr int kRing = 32;

// steps a chunk at bands of KB waves: kChunkPlanes planes, at most the
// register window's 2 KB steps
template <int KB>
__host__ __device__ constexpr int chunk_steps() {
  return kChunkPlanes / KB < 2 * KB ? kChunkPlanes / KB : 2 * KB;
}

// Grid: one block a group of 32 rows, NW warps.  `at`/`out` are (n, M),
// the panels (K, n-1) wave-major (K*(n-1) < 2^31).  One block an SM is
// enough (the row groups fill the card: 120 of 132 SMs at M = 3840), and
// with that bound ptxas keeps the window and the row pointers in
// registers.
template <int KB, int NW, typename T>
__global__ void __launch_bounds__(NW * 32, 1)
rotseq_wave_kernel(const T* at, const T* __restrict__ cw,
                   const T* __restrict__ sw,
                   const T* __restrict__ gw, T* out, int n, int M,
                   int K) {
  using St = Store<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int W = 2 * KB;                     // the register window
  constexpr int CS = chunk_steps<KB>();         // steps a chunk
  constexpr int L = (W - 1 + CS - 1) / CS + 1;  // lag between warps, chunks
  constexpr int R = kRing;
  constexpr int Q = KB * CS / 32;               // panel elements a lane
  constexpr int V = 16 / (int)sizeof(T);        // rows a 16-byte piece
  static_assert(W % CS == 0 && KB * CS % 32 == 0, "chunk shape");
  static_assert((R & (R - 1)) == 0, "ring size a power of two");
  static_assert(kF32 || KB % 2 == 0, "half planes rounded in pairs");
  // a hand-off slot is written again only after its take-in, and warp 0's
  // staged columns outlive their chunk: column c's slot takes column c + R
  // in a barrier after c's last read (column 0, read at chunk 0, as late as
  // columns CS + 1 .. 2 CS, needs the fourth chunk)
  static_assert((R + W - 1) / CS >= L + 1 && R >= 4 * CS, "ring size");
  // Dynamic shared memory (wave_smem_bytes): per warp, three chunks of
  // plane values in flight (chunk kw is read from slot kw % 3 while chunk
  // kw + 1 lands in the next; slot kw % 3 is written again only after the
  // barrier that opens chunk kw + 2), then per warp the ring of columns
  // it takes in.
  extern __shared__ float4 smem[];
  float4(*panel)[3][KB][CS] =                   // {c, s, g, -}
      reinterpret_cast<float4(*)[3][KB][CS]>(smem);
  T(*ring)[R][32] =
      reinterpret_cast<T(*)[R][32]>(smem + NW * 3 * KB * CS);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row = blockIdx.x * 32 + lane;
  const bool live_row = row < M;
  const int J = n - 1;
  const int bands = (K + KB - 1) / KB;
  const int NC = (n + W - 2 + CS - 1) / CS;     // chunks a band
  const size_t ld = (size_t)M;                  // column stride of a row
  T(*rin)[32] = ring[w];
  T(*rout)[32] = ring[w + 1 < NW ? w + 1 : 0];
  // half precision: warp 0's columns move by cp.async in 16-byte pieces
  // of V rows when every column of the operand starts 16-byte aligned
  const bool vec = !kF32 && M % V == 0 &&
                   ((size_t)at | (size_t)out) % 16 == 0;
  float win[W];                                 // T-exact values
  // half precision: the next chunk's panel values, between fetch and put
  T hv[Q][3];

  for (int q0 = 0; q0 < bands; q0 += NW) {      // passes
    const int last = min(NW, bands - q0) - 1;   // the pass's last warp
    const bool busy = w <= last;
    const bool to_out = w == last;
    const T* from = (q0 == 0 ? at : out) + row;
    T* dst = out + row;
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
    // half precision: write the panel values fetched for chunk kn to its
    // slot, as raw T bits (the identity outside the grid)
    auto put = [&](int kn) {
      if constexpr (!kF32) {
        const int tc = kn * CS;
        float4(*pb)[CS] = panel[w][kn % 3];
#pragma unroll
        for (int e4 = 0; e4 < Q; ++e4) {
          const int e = lane + 32 * e4;
          float4* dp = &pb[e / CS][e % CS];
          const int j = tc + d[e4];
          if (pv[e4] && j >= 0 && j < J) {
            const unsigned gb =
                *reinterpret_cast<const unsigned short*>(&hv[e4][2]);
            const unsigned cb =
                *reinterpret_cast<const unsigned short*>(&hv[e4][0]);
            const unsigned sb =
                *reinterpret_cast<const unsigned short*>(&hv[e4][1]);
            *dp = make_float4(__uint_as_float(cb), __uint_as_float(sb),
                              __uint_as_float(gb), 0.f);
          } else {
            const unsigned gb = (j < -wave[e4] ? 0u : 0x8000u) | St::kOne;
            *dp = make_float4(__uint_as_float(St::kOne), 0.f,
                              __uint_as_float(gb), 0.f);
          }
        }
      }
    };
    const int S = NC + L * last;                // iterations of the pass
    for (int s = -1; s < S; ++s) {
      const int kw = s - L * w;                 // this warp's chunk
      const bool stage = busy && kw + 1 >= 0 && kw + 1 < NC;
      if (stage) {
        const int kn = kw + 1;
        const int tc = kn * CS;
        if constexpr (kF32) {
          float4(*pb)[CS] = panel[w][kn % 3];
#pragma unroll
          for (int e4 = 0; e4 < Q; ++e4) {
            const int e = lane + 32 * e4;
            float4* dp = &pb[e / CS][e % CS];
            const int j = tc + d[e4];
            if (pv[e4] && j >= 0 && j < J) {
              __pipeline_memcpy_async(&dp->x, cw + off[e4] + tc,
                                      sizeof(float));
              __pipeline_memcpy_async(&dp->y, sw + off[e4] + tc,
                                      sizeof(float));
              __pipeline_memcpy_async(&dp->z, gw + off[e4] + tc,
                                      sizeof(float));
            } else {
              *dp = make_float4(1.f, 0.f, j < -wave[e4] ? 1.f : -1.f, 0.f);
            }
          }
        } else {                                // put writes them
#pragma unroll
          for (int e4 = 0; e4 < Q; ++e4) {
            const int j = tc + d[e4];
            if (pv[e4] && j >= 0 && j < J) {
              const int o = off[e4] + tc;
              hv[e4][0] = cw[o];
              hv[e4][1] = sw[o];
              hv[e4][2] = gw[o];
            }
          }
          if (w == 0 && vec) {
            // columns c0 .. c1 (c0 = 0 ahead of the first chunk), 32 / V
            // pieces each
            const int c0 = kn == 0 ? 0 : tc + 1;
            const int c1 = min(tc + CS, n - 1);
            const T* blk = from - lane;         // the block's first row
            for (int e = lane; e < (c1 - c0 + 1) * (32 / V); e += 32) {
              const int col = c0 + e / (32 / V);
              const int r = e % (32 / V) * V;
              if (row - lane + r < M) {
                __pipeline_memcpy_async(&rin[col & (R - 1)][r],
                                        blk + col * ld + r, 16);
              }
            }
          }
        }
        if (w == 0 && live_row && !vec) {
          // columns tc+1 .. tc+CS (and column 0 ahead of the first chunk)
          for (int col = kn == 0 ? 0 : tc + 1; col <= tc + CS && col < n;
               ++col) {
            if constexpr (kF32) {
              __pipeline_memcpy_async(&rin[col & (R - 1)][lane],
                                      from + col * ld, sizeof(float));
            } else {
              rin[col & (R - 1)][lane] = from[col * ld];
            }
          }
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      if (!busy || kw < 0 || kw >= NC) {
        if constexpr (!kF32) {
          if (stage) put(kw + 1);
        }
        continue;
      }

      const int tc = kw * CS;
      const float4(*pb)[CS] = panel[w][kw % 3];
      if (kw == 0) {
        // before step 0 the window holds columns -W+2 .. 0
#pragma unroll
        for (int q = 0; q < W - 1; ++q) win[(q + 2) % W] = 0.f;
        win[0] = St::w(rin[0][lane]);
      }
      T* sp = dst + (long long)(tc - W + 2) * M;  // column t-W+2 out
#pragma unroll
      for (int u = 0; u < CS; ++u, sp += ld) {
        const int t = tc + u;
        const T v = rin[(t + 1) & (R - 1)][lane];
        // take column t+1 in (float32 spells it without St::w: that
        // identity call alone changes the float32 instantiation's SASS)
        if constexpr (kF32) {
          win[(u + 1) % W] = t + 1 < n ? v : 0.f;
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            const float4 c = pb[i][u];          // plane (t - 2i, band wave i)
            float& x = win[(u - 2 * i + 2 * W) % W];
            float& y = win[(u - 2 * i + 1 + 2 * W) % W];
            const float xn = __fadd_rn(__fmul_rn(c.x, x), __fmul_rn(c.y, y));
            const float yn =
                __fmul_rn(c.z, __fsub_rn(__fmul_rn(c.y, x), __fmul_rn(c.x, y)));
            x = xn;
            y = yn;
          }
        } else {
          win[(u + 1) % W] = t + 1 < n ? St::w(v) : 0.f;
          // planes i and i+1 of the step touch disjoint columns: rounded
          // together, the products too as native paired ops
          // (half_store.cuh)
#pragma unroll
          for (int i = 0; i < KB; i += 2) {
            const float4 q0 = pb[i][u];         // plane (t - 2i, band wave i)
            const float4 q1 = pb[i + 1][u];     // plane (t - 2i - 2, ...)
            float& x0 = win[(u - 2 * i + 2 * W) % W];
            float& y0 = win[(u - 2 * i + 1 + 2 * W) % W];
            float& x1 = win[(u - 2 * i - 2 + 2 * W) % W];
            float& y1 = win[(u - 2 * i - 1 + 2 * W) % W];
            float2 xn, yn;
            plane_pair_native<T>(q0, q1, x0, y0, x1, y1, xn, yn);
            x0 = xn.x;
            y0 = yn.x;
            x1 = xn.y;
            y1 = yn.y;
          }
        }
        const int co = t - W + 2;               // finished at this step
        const float f = win[(u + 2) % W];
        if (to_out) {
          if (live_row && co >= 0 && co < n) *sp = St::n(f);
        } else if (co >= 0) {
          rout[co & (R - 1)][lane] = St::n(f);
        }
      }
      if constexpr (!kF32) {
        if (stage) put(kw + 1);
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

// raw bits of a staged plane value in a float (float32: the value)
template <typename T>
__device__ __forceinline__ float raw_bits(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __uint_as_float(*reinterpret_cast<const unsigned short*>(&v));
  }
}

// The small band: a band chain inside a warp.  Lane (r, b) = (lane / NB,
// lane % NB) applies the KB waves of band b of the pass to row r of the
// warp's R rows in a register window of W = 2 KB columns, the step
// rule of rotseq_wave_kernel: at its step t it takes column t+1 in,
// applies plane t - 2i of band wave i, and finishes column t - W + 2.
// Band b runs W steps behind band b - 1: at the warp's step s the lane's
// step is t = s - 1 - W b, so band b - 1 finishes column c at step
// c + W - 1 + W (b - 1) and band b takes it in at c + W b, the next
// step.  One __shfl_up_sync a step hands the finished column on, and one
// register (h) holds it for that step; column c sits in window slot
// c mod W in every lane (the lag is a multiple of W), so every slot index
// is a compile-time constant of the step's place in its chunk.  Band 0
// takes column s from a per-warp ring in shared memory (staged from
// memory, AT in the first pass and `out` after); the pass's last band
// stores the column it finishes.  A pass runs NB bands over the rows in
// S = n + W - 1 + W last steps; the next pass reads the rows back from
// `out` after a __syncwarp (no other warp touches them).
//
// Plane values: each lane needs its band's KB planes a step, NB * KB
// distinct planes a warp-step.  A chunk of CS = 2 W steps stages them one
// chunk ahead into a per-warp ring of two slots of {c, s, g, -}, laid
// [step][wave i][band b ^ 2i] (the XOR puts a staging store's eight
// lanes on eight banks; a step's reads of wave i stay 128 contiguous
// bytes): lane w loads wave w of the pass at the chunk's CS steps, CS
// consecutive planes of its panel row, into registers before the chunk
// runs and writes them to the slot after, a __syncwarp a chunk; a step
// reads its plane values one step ahead.  Where every plane of a chunk
// lies inside the grid the loads take no test; elsewhere the identity
// planes outside the grid are written as rotseq_wave_kernel stages them,
// so the result is the blocked plain version's bit for bit at this band,
// signed zeros included.  Steps where a lane is outside its band (before
// t = 0 or past column n-1's take-in) run in chunks of their own that
// mask the take-in: before its first step a lane's window holds +0 and
// takes +0 in, and its planes there are (1, 0, +1), which keep +0;
// column 0 comes in after the planes of step t = -1.
//
// Grid: kSmallWarps warps a block, R rows a warp, no block barrier: at
// M = 1024, 256 warps in 128 blocks, one a scheduler, on 128 SMs.
//
// At k = 32, n = M = 1024 in float32 a launch took 0.079 ms on an H100
// at 700 W (tools/wave_small_ab.py).  A warp alone on its scheduler sets
// the pace, so the staging that issues fewest instructions won: chunks
// of 8 steps 0.084 ms, and at 8 steps, 8 lanes a wave (fewer cache lines
// a load, more address arithmetic) 0.106 or cp.async into the slots
// 0.087; 32-step chunks loaded a panel row a load instruction, 4 steps a
// shared-memory read, 0.097.  With no plane values staged past the first
// chunks (a wrong result, timed as a bound) 0.051.
template <typename T>
__global__ void __launch_bounds__(kSmallWarps * 32)
rotseq_wave_small_kernel(const T* at, const T* __restrict__ cw,
                         const T* __restrict__ sw,
                         const T* __restrict__ gw, T* out, int n, int M,
                         int K) {
  using St = Store<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int KB = kSmallBand;
  constexpr int R = kSmallRows;
  constexpr int NB = kSmallBands;
  constexpr int W = 2 * KB;                     // window; lag between bands
  constexpr int CS = kSmallChunk;               // steps a chunk
  constexpr int WP = NB * KB;                   // waves a pass
  constexpr int QC = CS * R / 32;               // column elements a lane
  static_assert(R * NB == 32 && CS % W == 0, "a lane a (row, band) pair");
  static_assert(WP == 32 && CS * R % 32 == 0, "a lane a wave's staging");
  static_assert((NB & (NB - 1)) == 0 && 2 * (KB - 1) < NB,
                "the slots' swizzle");
  static_assert(kF32 || KB % 2 == 0, "half planes rounded in pairs");
  __shared__ float4 panel[kSmallWarps][2][CS][KB][NB];
  __shared__ alignas(16) unsigned char cols[kSmallWarps * 2 * CS * R *
                                            sizeof(T)];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int g = blockIdx.x * kSmallWarps + wid;  // the warp's row group
  if (g * R >= M) return;
  const int r = lane / NB;
  const int b = lane % NB;
  const int row = g * R + r;
  const bool live = row < M;
  // staging roles: a lane stages one wave of the pass, wave iw of band
  // bw, at every step of a chunk, into the slot's entry [step][iw][bw ^
  // 2 iw]; and column element e, step cu + e * 32 / R of row cr
  const int iw = lane % KB;
  const int bw = lane / KB;
  const int cu = lane / R;
  const int cr = lane % R;
  const int crow = g * R + cr;
  const bool clive = crow < M;
  const int J = n - 1;
  const int bands = (K + KB - 1) / KB;
  const size_t ld = (size_t)M;                  // column stride of a row
  float4(*pring)[CS][KB][NB] = panel[wid];
  T(*cring)[CS][R] = reinterpret_cast<T(*)[CS][R]>(cols) + 2 * wid;
  T hc[CS], hs[CS], hg[CS], hcol[QC];           // staged, a chunk ahead
  float win[W];                                 // T-exact values

  for (int q0 = 0; q0 < bands; q0 += NB) {      // passes
    const int last = min(NB, bands - q0) - 1;   // the pass's last band
    const bool to_out = live && b == last;
    const T* from = q0 == 0 ? at : out;
    const int S = n + W - 1 + W * last;         // steps of the pass
    const int NC = (S + CS - 1) / CS;
    const int p = q0 * KB + lane;               // the wave a lane stages
    const bool whole = q0 * KB + WP <= K;       // every wave of the pass
    const int base = p * J - 1 - 2 * lane;      // + s: its plane at step s
    // load chunk kn's plane values and band 0's columns into registers;
    // every plane of the chunk inside the grid: no test a plane
    auto fetch = [&](int kn) {
      const int s0 = kn * CS;
      if (whole && s0 >= 2 * WP - 1 && s0 + CS <= n) {
#pragma unroll
        for (int u = 0; u < CS; ++u) {
          hc[u] = cw[base + s0 + u];
          hs[u] = sw[base + s0 + u];
          hg[u] = gw[base + s0 + u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < CS; ++u) {
          const int j = s0 + u - 1 - 2 * lane;
          if (p < K && j >= 0 && j < J) {
            hc[u] = cw[base + s0 + u];
            hs[u] = sw[base + s0 + u];
            hg[u] = gw[base + s0 + u];
          } else {
            hc[u] = St::n(1.f);
            hs[u] = St::n(0.f);
            hg[u] = St::n(j < -iw ? 1.f : -1.f);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        const int col = s0 + cu + e * (32 / R);
        hcol[e] = clive && col < n ? from[col * ld + crow] : St::n(0.f);
      }
    };
    // write them to chunk kn's slot
    auto put = [&](int kn) {
      float4(*pb)[KB][NB] = pring[kn & 1];
#pragma unroll
      for (int u = 0; u < CS; ++u) {
        pb[u][iw][bw ^ (2 * iw)] =
            make_float4(raw_bits(hc[u]), raw_bits(hs[u]), raw_bits(hg[u]),
                        0.f);
      }
#pragma unroll
      for (int e = 0; e < QC; ++e) {
        cring[kn & 1][cu + e * (32 / R)][cr] = hcol[e];
      }
    };
#pragma unroll
    for (int q = 0; q < W; ++q) win[q] = 0.f;
    float h = 0.f;                              // the column handed on
    fetch(0);
    put(0);
    for (int k = 0; k < NC; ++k) {
      if (k + 1 < NC) fetch(k + 1);
      __syncwarp();
      const int s0 = k * CS;
      const float4(*pb)[KB][NB] = pring[k & 1];
      const T(*cb)[R] = cring[k & 1];
      // column s0 - W + 1 - W b, finished at the chunk's first step
      T* sp = out + (long long)(s0 - 1 - W * b - (W - 2)) * M + row;
      // a step's plane values and column are read a step ahead
      float4 pc[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) pc[i] = pb[0][i][b ^ (2 * i)];
      T cc = cb[0][r];
      // edge: some lane is outside its band at a step of the chunk
      auto chunk = [&](auto edge) {
        constexpr bool kEdge = decltype(edge)::value;
#pragma unroll
        for (int u = 0; u < CS; ++u, sp += ld) {
          float4 pn[KB];
          T cn = cc;
          if (u + 1 < CS) {
#pragma unroll
            for (int i = 0; i < KB; ++i) pn[i] = pb[u + 1][i][b ^ (2 * i)];
            cn = cb[u + 1][r];
          }
          const int t = s0 + u - 1 - W * b;     // the lane's step
          float v = b == 0 ? St::w(cc) : h;     // column t + 1
          const bool first = kEdge && t == -1;
          if (kEdge && (t + 1 < 0 || t + 1 >= n)) v = 0.f;
          if (!first) win[u % W] = v;
          if constexpr (kF32) {
#pragma unroll
            for (int i = 0; i < KB; ++i) {
              const float4 pl = pc[i];          // plane t - 2i, wave i
              float& x = win[(u - 1 - 2 * i + 2 * W) % W];
              float& y = win[(u - 2 * i + 2 * W) % W];
              const float xn =
                  __fadd_rn(__fmul_rn(pl.x, x), __fmul_rn(pl.y, y));
              const float yn = __fmul_rn(
                  pl.z, __fsub_rn(__fmul_rn(pl.y, x), __fmul_rn(pl.x, y)));
              x = xn;
              y = yn;
            }
          } else {
            // planes i and i+1 of the step touch disjoint columns:
            // rounded together (half_store.cuh)
#pragma unroll
            for (int i = 0; i < KB; i += 2) {
              float& x0 = win[(u - 1 - 2 * i + 2 * W) % W];
              float& y0 = win[(u - 2 * i + 2 * W) % W];
              float& x1 = win[(u - 3 - 2 * i + 2 * W) % W];
              float& y1 = win[(u - 2 - 2 * i + 2 * W) % W];
              float2 xn, yn;
              plane_pair_native<T>(pc[i], pc[i + 1], x0, y0, x1, y1, xn,
                                   yn);
              x0 = xn.x;
              y0 = yn.x;
              x1 = xn.y;
              y1 = yn.y;
            }
          }
          if (first) win[u % W] = v;            // column 0, after the planes
          const float f = win[(u + 1) % W];     // column t - W + 2
          h = __shfl_up_sync(0xffffffffu, f, 1, NB);
          const int co = t - (W - 2);
          if (to_out && co >= 0 && co < n) *sp = St::n(f);
          if (u + 1 < CS) {
#pragma unroll
            for (int i = 0; i < KB; ++i) pc[i] = pn[i];
            cc = cn;
          }
        }
      };
      if (s0 > W * (NB - 1) && s0 + CS <= n) {
        chunk(std::false_type());
      } else {
        chunk(std::true_type());
      }
      if (k + 1 < NC) put(k + 1);
    }
    __syncwarp();  // the pass's stores land before the next pass reads
  }
}

}  // namespace

// C interface, loaded with ctypes.  Applies all K waves of the panels to
// the packed operand `at` (n, M) into `out` (n, M) in one launch on
// `stream`, in bands of `kb` waves (kBand, or kSmallBand on the small
// band's kernel); does not
// synchronise and allocates nothing; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a band that is not compiled.  The caller
// handles K == 0 and n < 2 (no planes).  One entry a storage type: every
// operand in that type.
template <int KB, typename T>
int launch_band(const T* at, const T* cw, const T* sw, const T* gw, T* out,
                int n, int M, int K, void* stream) {
  constexpr int CS = chunk_steps<KB>();
  constexpr int smem =
      kWarps * (3 * KB * CS * (int)sizeof(float4) +
                kRing * 32 * (int)sizeof(T));
  auto kernel = rotseq_wave_kernel<KB, kWarps, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + 31) / 32;
  kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      at, cw, sw, gw, out, n, M, K);
  return (int)cudaGetLastError();
}

// the small band: kSmallRows rows a warp, kSmallWarps warps a block,
// static shared memory (limits.wave_smem_bytes at WAVE_SMALL_KB)
template <typename T>
int launch_small(const T* at, const T* cw, const T* sw, const T* gw, T* out,
                 int n, int M, int K, void* stream) {
  const int groups = (M + kSmallRows - 1) / kSmallRows;
  const int blocks = (groups + kSmallWarps - 1) / kSmallWarps;
  rotseq_wave_small_kernel<T><<<blocks, kSmallWarps * 32, 0,
                                (cudaStream_t)stream>>>(at, cw, sw, gw, out,
                                                        n, M, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wave(const T* at, const T* cw, const T* sw, const T* gw, T* out,
                int n, int M, int K, int kb, void* stream) {
  if (kb == kBand)
    return launch_band<kBand>(at, cw, sw, gw, out, n, M, K, stream);
  if (kb == kSmallBand)
    return launch_small(at, cw, sw, gw, out, n, M, K, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rotseq_wave_f32(const float* at, const float* cw,
                               const float* sw, const float* gw, float* out,
                               int n, int M, int K, int kb, void* stream) {
  return launch_wave(at, cw, sw, gw, out, n, M, K, kb, stream);
}

extern "C" int rotseq_wave_bf16(const __nv_bfloat16* at,
                                const __nv_bfloat16* cw,
                                const __nv_bfloat16* sw,
                                const __nv_bfloat16* gw, __nv_bfloat16* out,
                                int n, int M, int K, int kb, void* stream) {
  return launch_wave(at, cw, sw, gw, out, n, M, K, kb, stream);
}

extern "C" int rotseq_wave_f16(const __half* at, const __half* cw,
                               const __half* sw, const __half* gw,
                               __half* out, int n, int M, int K, int kb,
                               void* stream) {
  return launch_wave(at, cw, sw, gw, out, n, M, K, kb, stream);
}
