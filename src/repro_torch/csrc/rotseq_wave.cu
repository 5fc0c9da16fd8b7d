// Wavefront application of one band of plane rotations (float32, sm_90a).
//
// Replaces: src/repro/kernels/rotseq/kernel.py::rotseq_wave_pallas (body
// _wave_kernel), the paper's SS3 register-reuse kernel with SS4 packing and
// SS5 blocking.
//
// What it computes, on the packed operand (columns of A are rows here):
// for each row block of A it walks the T diagonal tiles of the band in
// order.  Tile t forms X = [carry (k_b rows); fresh_t (n_b rows)], applies
// k_b waves of n_b planes (wave p acts on local pair k_b-1-p+jj with the
// sheared values Ct/St/Gt[t, jj, p]), emits X[0:n_b] and keeps X[n_b:] as
// the next carry.
//
// What bounds it on an H100: 6 flops a plane, 6*m*(n-1)*k in all (67
// TFLOP/s of float32); the bytes (A in and out, the c/s/g panel) are a
// tenth of that time.  The carry is a sequential dependency over tiles,
// and on Hopper nothing carries from one block to the next, so one block
// loops over all T tiles and blocks split only the rows of A (rows are
// independent under rotations applied from the right).  At m = 3840 that
// is 30 blocks of 128 threads on 132 SMs: row-only parallelism is what
// holds this first version back.
//
// Design: one thread per row of A.  A thread's k_b + n_b window lives in
// shared memory laid out [w][threads] (a dynamic pair index into a register
// array would spill); neighbouring threads touch neighbouring words, so
// there are no bank conflicts, and fresh/out rows are read and written
// coalesced.  Within a wave the updated y of pair jl is the x of pair
// jl + 1, so it stays in a register.  Each tile's c/s/g are staged in
// shared memory and read by every thread at one address (a broadcast).
//
// Plane form: exactly repro_torch.core.rotations.plane_update, each
// product and sum rounded on its own (__fmul_rn etc. are never contracted
// into an FMA), so the kernel equals its plain PyTorch version bit for bit.
#include <cuda_runtime.h>

namespace {

__global__ void rotseq_wave_kernel(const float* __restrict__ fresh,
                                   const float* __restrict__ ct,
                                   const float* __restrict__ st,
                                   const float* __restrict__ gt,
                                   const float* __restrict__ init,
                                   float* __restrict__ out,
                                   int T, int n_b, int k_b, int M) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  const int w = k_b + n_b;
  const int tile = n_b * k_b;
  float* win = smem;                 // [w][nt]
  float* cs = win + w * nt;          // [n_b][k_b] each for c, s, g
  float* ss = cs + tile;
  float* gs = ss + tile;

  const int col = blockIdx.x * nt + tid;
  const bool active = col < M;

  if (active) {
    for (int r = 0; r < k_b; ++r) win[r * nt + tid] = init[(size_t)r * M + col];
  }
  for (int t = 0; t < T; ++t) {
    __syncthreads();  // previous tile's c/s/g reads are done
    const size_t off = (size_t)t * tile;
    for (int i = tid; i < tile; i += nt) {
      cs[i] = ct[off + i];
      ss[i] = st[off + i];
      gs[i] = gt[off + i];
    }
    if (active) {
      const float* src = fresh + (size_t)t * n_b * M + col;
      for (int r = 0; r < n_b; ++r) win[(k_b + r) * nt + tid] = src[(size_t)r * M];
    }
    __syncthreads();
    if (active) {
      for (int p = 0; p < k_b; ++p) {
        const int j0 = k_b - 1 - p;
        float x = win[j0 * nt + tid];
        for (int jj = 0; jj < n_b; ++jj) {
          const int jl = j0 + jj;
          const float c = cs[jj * k_b + p];
          const float s = ss[jj * k_b + p];
          const float g = gs[jj * k_b + p];
          const float y = win[(jl + 1) * nt + tid];
          const float xn = __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y));
          const float yn = __fmul_rn(g, __fsub_rn(__fmul_rn(s, x), __fmul_rn(c, y)));
          win[jl * nt + tid] = xn;
          x = yn;
        }
        win[(j0 + n_b) * nt + tid] = x;
      }
      float* dst = out + (size_t)t * n_b * M + col;
      for (int r = 0; r < n_b; ++r) dst[(size_t)r * M] = win[r * nt + tid];
      // the last k_b rows become the next carry; each thread moves only
      // its own column, so no barrier is needed
      for (int r = 0; r < k_b; ++r) win[r * nt + tid] = win[(n_b + r) * nt + tid];
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
extern "C" int rotseq_wave_f32(const float* fresh, const float* ct,
                               const float* st, const float* gt,
                               const float* init, float* out, int T, int n_b,
                               int k_b, int M, int threads, void* stream) {
  const size_t smem =
      ((size_t)(k_b + n_b) * threads + 3 * (size_t)n_b * k_b) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rotseq_wave_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + threads - 1) / threads;
  rotseq_wave_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      fresh, ct, st, gt, init, out, T, n_b, k_b, M);
  return (int)cudaGetLastError();
}
