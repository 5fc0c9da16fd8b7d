// Fused multi-request application of rotation sequences (float32, sm_90a).
//
// Replaces: src/repro/kernels/rotseq_batched/kernel.py::rotseq_batched_pallas
// (body _batched_kernel), the serving path's one launch per bucket.
//
// What it computes: for every request ib and every row of its packed
// target AT[ib] (columns of A as rows here, shape (n, M)), all K waves in
// order.  Wave p applies only the planes j = start .. start + count - 1 of
// its live window (starts/counts[is, p], is = ib for per-request panels, 0
// for one shared sequence); planes outside the window (pad_to tails, the
// dead triangles of a seq.T staircase) leave the row untouched.  Each
// block also writes the number of planes its request applies (the sum of
// its counts) as the skip witness.
//
// What bounds it on an H100: 6 flops a live plane and row, 6*M*live in
// all, at 67 TFLOP/s of float32: 0.070 ms at the serving bucket (16
// requests of 1024 x 1024, 33-64 waves); the bytes (targets in and out
// once, the panels once) take less.  Issued instructions bound it in
// practice: a plane is at least 9 (one broadcast float4 load from shared
// memory, 5 rounded products, 2 rounded sums, a compare; the select rides
// on the last product and sum as a predicate), more with the chunk's
// share of staging, loads, stores and window moves.  The bucket's 16384
// rows are one warp a scheduler on 132 SMs, so its time is one warp's
// instruction stream: ~68k plane slots for a request of 64 waves, about
// 0.5 ms at one instruction a cycle.
//
// What the design does about it (the paper's SS3 register-reuse kernel,
// per row, inside one launch): the first version held a row's n columns in
// shared memory and ran each wave as one dependent chain, a shared load
// and three panel loads a plane, one warp an SM at n = 1024; latency set
// its pace (~47 ns a plane).  Here a thread walks bands of KB waves in
// steps that apply KB independent planes at once (KB chains for the
// scheduler to interleave), the 2*KB columns a step reaches sit in
// registers, and the row streams through memory (mostly L2) once a band,
// so the width n has no cap and blocks of 64 threads spread one request
// over many SMs.  The c/s/g values are indexed from the wave-major panels
// (no sheared copy is made: 16 staircases of 1086 waves would need
// ~290 MB, and the packing pass its own launches), staged a chunk ahead
// into shared memory with their live flag, which the staging computes
// from starts/counts; the sheared float4 packing was not built.  A step
// reads each plane's {c, s, g, live} as one broadcast float4.  The
// block's incoming columns are staged the same way, in 16-byte pieces of
// four rows when M % 4 == 0.  Bands of 16 waves: against bands of 8 they
// halve the row's trips through memory, and chunks of 8 steps keep the
// unrolled body at 128 planes (longer bodies ran slower in trials on the
// card, as if instruction fetch could not keep up).  Blocks of 64
// threads: against 32 they ran faster at m = 1024.
//
// The schedule, for one thread and its row (columns 0 .. n-1):
//
//   waves walk in bands of KB consecutive waves p = b0 + i, i < KB;
//   within a band, step t applies plane j = t - 2i of every band wave i.
//
// The KB planes of one step touch disjoint column pairs, and plane (j, p)
// needs only (j-1, p), (j, p-1) and (j+1, p-1), which ran at earlier
// steps or in an earlier band, so every plane sees the values it sees in
// the sequential order and the result equals that order bit for bit.
//
// Step t touches columns t-W+2 .. t+1, W = 2*KB: a window of W floats held
// in registers.  Steps run in chunks of CS = min(W, 128/KB) steps (at most
// 128 planes), aligned to multiples of CS, and the chunk body is unrolled:
// at the start of chunk tc, column c sits in slot (c - tc) mod W, so every
// slot index in the body is a compile-time constant (a dynamic index would
// put the window in local memory), and the window rotates by CS slots at
// the end of a chunk when CS < W.  Step t takes column t+1 in and stores
// the finished column t-W+2.  The columns a chunk takes in and its planes'
// {c, s, g, live} are copied into shared memory with cp.async one chunk
// ahead, so no load waits on a step.
//
// Liveness: a plane outside its wave's hull is computed and dropped by a
// select (never multiplied through), so NaN, inf and -0.0 outside the
// hulls keep their bits.  A band runs only the steps and columns its hulls
// reach: [tlo, thi) is the union of [starts+2i, starts+counts+2i), rounded
// out to whole chunks, and only columns clo .. chi (the hulls' columns)
// are loaded and stored.
//
// Plane form: exactly repro_torch.core.rotations.plane_update, each
// product and sum rounded on its own (__fmul_rn etc. are never contracted
// into an FMA), so the kernel equals its plain PyTorch version bit for bit.
#include <climits>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

// waves a band, and threads (rows) a block: repro_torch.kernels.limits.
// BATCHED_M_BLK must equal kThreads
constexpr int kBand = 16;
constexpr int kThreads = 64;
// planes in the unrolled body of one chunk
constexpr int kChunkPlanes = 128;

// Stages the {c, s, g, live} of one chunk of CS steps into shared memory:
// buf[i][u] is plane (tc + u - 2i, b0 + i).  Thread tid copies elements
// e = tid + q*NT, q < Q; what an element needs besides the chunk start tc
// (its hull, shifted to steps, and its panel offset) is set once a band,
// so staging a chunk reads no index memory.  Only live planes are copied;
// a dead one gets live = 0 and keeps stale values, which the select never
// takes.  The copies join the chunk's cp.async group.
template <int KB, int NT, int CS>
struct Stager {
  static constexpr int Q = (KB * CS + NT - 1) / NT;
  int lo[Q];   // element live for chunk starts tc in [lo, hi)
  int hi[Q];
  int off[Q];  // panel offset of its plane, less tc

  __device__ __forceinline__ void band(const int* st, const int* ct, int b0,
                                       int K, int J, int tid) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = tid + q * NT;
      const int i = e / CS;
      const int u = e % CS;
      const int p = b0 + i;
      lo[q] = 0;
      hi[q] = 0;
      off[q] = 0;
      if (e < KB * CS && p < K) {
        lo[q] = __ldg(st + p) + 2 * i - u;
        hi[q] = lo[q] + __ldg(ct + p);
        off[q] = p * J + u - 2 * i;
      }
    }
  }

  __device__ __forceinline__ void stage(float4 (*buf)[CS], const float* c,
                                        const float* s, const float* g,
                                        int tc, int tid) const {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int e = tid + q * NT;
      if (e < KB * CS) {
        float4* d = &buf[e / CS][e % CS];
        const bool live = tc >= lo[q] && tc < hi[q];
        if (live) {
          const int o = off[q] + tc;
          __pipeline_memcpy_async(&d->x, c + o, sizeof(float));
          __pipeline_memcpy_async(&d->y, s + o, sizeof(float));
          __pipeline_memcpy_async(&d->z, g + o, sizeof(float));
        }
        d->w = live ? 1.f : 0.f;
      }
    }
  }
};

// Grid (b, R): block (ib, rb) owns rows rb*NT .. rb*NT+NT-1 of request ib,
// one row a thread.  `at`/`out` are (b, n, M), the panels (bs, K, J)
// wave-major (K*J < 2^31), starts/counts (bs, K).  With vec (M % 4 == 0,
// both targets 16-byte aligned) the block stages its rows' columns in
// 16-byte pieces of four rows.  Writes the sum of the request's counts to
// planes[ib, rb].  One block an SM is enough (the rows, not the blocks,
// fill the card): with that bound ptxas keeps the window and the row
// pointers in registers instead of recomputing them.
template <int KB, int NT>
__global__ void __launch_bounds__(NT, 1)
rotseq_batched_kernel(const float* at, const float* __restrict__ cw,
                      const float* __restrict__ sw,
                      const float* __restrict__ gw,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts, float* out,
                      int* __restrict__ planes, int n, int M, int K,
                      int per_request, bool vec) {
  constexpr int W = 2 * KB;                     // the register window
  constexpr int CS =                            // steps a chunk
      kChunkPlanes / KB < W ? kChunkPlanes / KB : W;
  constexpr int P = CS * NT / 4;                // 16-byte pieces of a tile
  static_assert(W % CS == 0 && P % NT == 0, "chunk shape");
  // Three chunks in flight: chunk kc is read from slot kc % 3 while chunk
  // kc + 1 lands in the next; slot kc % 3 is written again only after the
  // barrier that opens chunk kc + 2, so one barrier a chunk suffices.
  __shared__ float4 panel[3][KB][CS];              // {c, s, g, live}
  __shared__ __align__(16) float rows[3][CS][NT];  // columns tc+1 .. tc+CS
  const int tid = threadIdx.x;
  const int ib = blockIdx.x;
  const int rb = blockIdx.y;
  const int nrows = min(NT, M - rb * NT);       // rows of this block
  const bool active = tid < nrows;
  const int J = n - 1;
  const size_t is = per_request ? (size_t)ib : 0;
  const float* c = cw + is * K * J;
  const float* s = sw + is * K * J;
  const float* g = gw + is * K * J;
  const int* st = starts + is * K;
  const int* ct = counts + is * K;
  const size_t ld = (size_t)M;                  // column stride of a row
  const size_t base = (size_t)ib * n * M + (size_t)rb * NT + tid;
  float* dst = out + base;                      // this thread's row
  const float* src = at + base;
  bool first = true;                            // AT until a band has run
  int total = 0;
  int kc = 0;                                   // chunks staged so far
  float win[W];
  Stager<KB, NT, CS> stager;

  for (int b0 = 0; b0 < K; b0 += KB) {
    int tlo = INT_MAX, thi = 0, clo = INT_MAX, chi = -1;
    for (int i = 0; i < KB && b0 + i < K; ++i) {
      const int lo = __ldg(st + b0 + i);
      const int cnt = __ldg(ct + b0 + i);
      total += cnt;
      if (cnt > 0) {
        tlo = min(tlo, lo + 2 * i);
        thi = max(thi, lo + cnt + 2 * i);
        clo = min(clo, lo);
        chi = max(chi, lo + cnt);
      }
    }
    if (chi < 0) continue;                      // no live plane in the band
    if (first && active) {
      // the first band reads AT and writes out: carry over the columns it
      // does not touch, sixteen loads in flight at a time
      for (int c0 = 0; c0 < n; c0 += 16) {
        float v[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int col = c0 + q;
          const bool copy = col < n && (col < clo || col > chi);
          v[q] = copy ? src[col * ld] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int col = c0 + q;
          if (col < n && (col < clo || col > chi)) dst[col * ld] = v[q];
        }
      }
    }
    // the band's input: AT for the first band, then out, where the
    // previous band's stores (by every thread of the block) must land
    // before this band's loads, which the block shares
    const float* from = first ? src : dst;
    const float* from_blk = from - tid;         // the block's first row
    first = false;
    __syncthreads();
    const int t0 = (tlo / CS) * CS;
    const int t1 = ((thi + CS - 1) / CS) * CS;

    // stage the chunk of steps tc .. tc+CS-1: its planes, and the block's
    // columns tc+1 .. tc+CS that its steps take in (columns outside
    // clo .. chi keep stale values: no live plane reads them and none is
    // stored)
    auto stage = [&](int tc) {
      const int slot = kc % 3;
      if (vec) {
#pragma unroll
        for (int q = 0; q < P / NT; ++q) {
          const int e = tid + q * NT;
          const int u = e / (NT / 4);
          const int r = e % (NT / 4) * 4;
          const int col = tc + 1 + u;
          if (r < nrows && col >= clo && col <= chi) {
            __pipeline_memcpy_async(&rows[slot][u][r],
                                    from_blk + (long long)col * M + r, 16);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < CS; ++u) {
          const int col = tc + 1 + u;
          if (active && col >= clo && col <= chi) {
            __pipeline_memcpy_async(&rows[slot][u][tid],
                                    from + (long long)col * M, sizeof(float));
          }
        }
      }
      stager.stage(panel[slot], c, s, g, tc, tid);
      __pipeline_commit();
      ++kc;
    };
    stager.band(st, ct, b0, K, J, tid);
    stage(t0);
    // the window before step t0 holds columns t0-W+2 .. t0
#pragma unroll
    for (int q = 0; q < W - 1; ++q) {
      const int col = t0 - W + 2 + q;
      const bool in = active && col >= clo && col <= chi;
      win[(q + 2) % W] = in ? from[col * ld] : 0.f;
    }
    for (int tc = t0; tc < t1; tc += CS) {
      const int slot = (kc - 1) % 3;            // this chunk's
      if (tc + CS < t1) {
        stage(tc + CS);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
      const float4(*pb)[CS] = panel[slot];
      const float(*rw)[NT] = rows[slot];
      float* sp = dst + (long long)(tc - W + 2) * M;  // column t-W+2 out
#pragma unroll
      for (int u = 0; u < CS; ++u, sp += ld) {
        const int t = tc + u;
        win[(u + 1) % W] = rw[u][tid];          // column t+1
#pragma unroll
        for (int i = 0; i < KB; ++i) {
          const float4 q = pb[i][u];            // plane (t - 2i, b0 + i)
          float& x = win[(u - 2 * i + 2 * W) % W];
          float& y = win[(u - 2 * i + 1 + 2 * W) % W];
          const float xn = __fadd_rn(__fmul_rn(q.x, x), __fmul_rn(q.y, y));
          const float yn =
              __fmul_rn(q.z, __fsub_rn(__fmul_rn(q.y, x), __fmul_rn(q.x, y)));
          const bool live = q.w != 0.f;
          x = live ? xn : x;
          y = live ? yn : y;
        }
        if (active && t - W + 2 >= clo && t - W + 2 <= chi) {
          *sp = win[(u + 2) % W];               // finished at this step
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
    // columns t1-W+2 .. t1 are still in the window
#pragma unroll
    for (int q = 0; q < W - 1; ++q) {
      const int col = t1 - W + 2 + q;
      if (active && col >= clo && col <= chi) dst[col * ld] = win[(q + 2) % W];
    }
  }
  if (first && active) {
    for (int col = 0; col < n; ++col) dst[col * ld] = src[col * ld];
  }
  if (tid == 0) planes[(size_t)ib * gridDim.y + rb] = total;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError(), or
// cudaErrorInvalidValue when `threads` is not the block size the kernel
// is compiled for (the caller sizes `planes` by it).
extern "C" int rotseq_batched_f32(const float* at, const float* cw,
                                  const float* sw, const float* gw,
                                  const int* starts, const int* counts,
                                  float* out, int* planes, int b, int n, int M,
                                  int K, int per_request, int threads,
                                  void* stream) {
  if (threads != kThreads) return (int)cudaErrorInvalidValue;
  // rows move in 16-byte pieces when every column of the targets starts
  // 16-byte aligned
  const bool vec = M % 4 == 0 && (size_t)at % 16 == 0 && (size_t)out % 16 == 0;
  const dim3 grid(b, (M + kThreads - 1) / kThreads);
  rotseq_batched_kernel<kBand, kThreads>
      <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
          at, cw, sw, gw, starts, counts, out, planes, n, M, K, per_request,
          vec);
  return (int)cudaGetLastError();
}
