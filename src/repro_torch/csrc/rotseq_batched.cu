// Fused multi-request application of rotation sequences (float32, sm_90a).
//
// Replaces: src/repro/kernels/rotseq_batched/kernel.py::rotseq_batched_pallas
// (body _batched_kernel), the serving path's one launch per bucket.
//
// What it computes: for every request ib and every row of its packed
// target AT[ib] (columns of A as rows here, shape (n, M)), all K waves in
// order.  Wave p applies only the planes j = start .. start + count - 1 of
// its live window (starts/counts[is, p], is = ib for per-request panels, 0
// for one shared sequence), in ascending j: plane j+1 reads column j+1
// after plane j wrote it.  Planes outside the window (pad_to tails, the
// dead triangles of a seq.T staircase) are skipped, never multiplied
// through.  Each block also writes the number of planes it applied
// (sum of its request's counts) as the skip witness.
//
// What bounds it on an H100: 6 flops a live plane and row, 6*M*live per
// request at 67 TFLOP/s of float32; the bytes (every target in and out
// once, the c/s/g panels once) take less time at the serving bucket.  But
// the plane loop is one dependent chain per row (x of plane j+1 is y of
// plane j), and a block holds one row a thread with the row's whole n
// columns in shared memory, so at n = 1024 a block is one warp (128 KB)
// and an SM runs one block: this first version is latency-bound, far from
// the flop bound.  Making it fast (several rows a thread, panels staged
// in shared memory, more warps an SM) is later work.
//
// Design: grid (b, R), one thread per row.  Rows are independent under
// rotations applied from the right, so blocks share nothing and nothing
// carries from one block to another.  The slab lives in shared memory laid
// out [column][thread]: neighbouring threads touch neighbouring words (no
// bank conflicts) and the target is read and written coalesced.  Within a
// wave the updated y of plane j is the x of plane j+1, so it stays in a
// register: one shared load and one store a plane.  c/s/g are the same for
// every thread of a block, broadcast loads through the read-only path from
// wave-major panels (a wave's planes are contiguous).  No barrier is
// needed: a thread touches only its own column of the slab.  Offsets into
// the targets are 64-bit (b*n*M passes 2^31 at large buckets).
//
// Plane form: exactly repro_torch.core.rotations.plane_update, each
// product and sum rounded on its own (__fmul_rn etc. are never contracted
// into an FMA), so the kernel equals its plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void rotseq_batched_kernel(const float* __restrict__ at,
                                      const float* __restrict__ cw,
                                      const float* __restrict__ sw,
                                      const float* __restrict__ gw,
                                      const int* __restrict__ starts,
                                      const int* __restrict__ counts,
                                      float* __restrict__ out,
                                      int* __restrict__ planes,
                                      int n, int M, int K, int per_request) {
  extern __shared__ float slab[];  // [n][nt]
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int ib = blockIdx.x;
  const int rb = blockIdx.y;
  const int row = rb * nt + tid;
  const bool active = row < M;
  const int J = n - 1;
  const size_t is = per_request ? (size_t)ib : 0;
  const float* c = cw + is * K * J;
  const float* s = sw + is * K * J;
  const float* g = gw + is * K * J;
  const int* st = starts + is * K;
  const int* ct = counts + is * K;
  const size_t base = (size_t)ib * n * M + row;

  if (active) {
    for (int r = 0; r < n; ++r) slab[r * nt + tid] = at[base + (size_t)r * M];
  }
  int total = 0;
  for (int p = 0; p < K; ++p) {
    const int start = __ldg(st + p);
    const int count = __ldg(ct + p);
    total += count;
    if (!active || count == 0) continue;
    const size_t off = (size_t)p * J;
    float x = slab[start * nt + tid];
    for (int jj = 0; jj < count; ++jj) {
      const int j = start + jj;
      const float cv = __ldg(c + off + j);
      const float sv = __ldg(s + off + j);
      const float gv = __ldg(g + off + j);
      const float y = slab[(j + 1) * nt + tid];
      const float xn = __fadd_rn(__fmul_rn(cv, x), __fmul_rn(sv, y));
      const float yn = __fmul_rn(gv, __fsub_rn(__fmul_rn(sv, x), __fmul_rn(cv, y)));
      slab[j * nt + tid] = xn;
      x = yn;
    }
    slab[(start + count) * nt + tid] = x;
  }
  if (active) {
    for (int r = 0; r < n; ++r) out[base + (size_t)r * M] = slab[r * nt + tid];
  }
  if (tid == 0) planes[(size_t)ib * gridDim.y + rb] = total;
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
extern "C" int rotseq_batched_f32(const float* at, const float* cw,
                                  const float* sw, const float* gw,
                                  const int* starts, const int* counts,
                                  float* out, int* planes, int b, int n, int M,
                                  int K, int per_request, int threads,
                                  void* stream) {
  const size_t smem = (size_t)n * threads * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rotseq_batched_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b, (M + threads - 1) / threads);
  rotseq_batched_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      at, cw, sw, gw, starts, counts, out, planes, n, M, K, per_request);
  return (int)cudaGetLastError();
}
