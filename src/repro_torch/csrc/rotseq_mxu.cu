// Accumulated (rs_gemm) application of one band of plane rotations:
// IEEE float32 products on the CUDA cores (no TF32), sm_90a.
//
// Replaces: src/repro/kernels/rotseq_mxu/kernel.py::rotseq_mxu_pallas (body
// _mxu_kernel).
//
// What it computes, natural layout: for each block of rows of A it walks
// the T tiles of the band in order, Y_t = [carry | fresh_t] (rows, w) @ Q_t
// (w, w) with w = k_b + n_b; Y_t[:, :n_b] is emitted and Y_t[:, n_b:] is
// the next carry, which never leaves the SM.  The tile factors Q_t are
// built outside the kernel (repro_torch.core.accumulate).
//
// What bounds it on an H100: 2*m*w*w flops a tile, about 3.1e10 at the
// paper's shape (n_b = k_b = 128, m = n = 3840, k = 180), against 67
// TFLOP/s of float32 on the CUDA cores; A in and out is a few percent of
// that time.  This first version is a plain shared-memory tiled FMA
// product; wgmma and TMA are later work.
//
// Design: like the wavefront kernel, blocks split only the rows of A and
// loop over the tiles, because the carry is sequential.  At n_b = k_b =
// 128 one Q_t is 256 KB, more than a block's 227 KB of shared memory, so
// Q_t streams through shared memory in slabs of 32 rows, and a block
// holds only 32 rows of A.  256 threads: lane tx owns columns tx + 32*jc,
// row group ty owns rows ty + 8*i; the sums live in registers, which is
// what removes the carry hazard: the new carry is written over X only
// after the barrier that ends the last read of X.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;       // columns: tx + 32 * jc
constexpr int kGroups = 8;       // rows: ty + 8 * i
constexpr int kMaxCols = 8;      // w <= 256
constexpr int kMaxRows = 4;      // rows a thread sums
constexpr int kRows = kGroups * kMaxRows;  // rows of A per block
constexpr int kSlab = 32;        // rows of Q_t per shared-memory slab

__global__ void __launch_bounds__(kLanes * kGroups)
rotseq_mxu_kernel(const float* __restrict__ fresh, const float* __restrict__ q,
                  const float* __restrict__ init, float* __restrict__ out,
                  int T, int n_b, int k_b, int M) {
  extern __shared__ float smem[];
  const int w = n_b + k_b;
  const int U = T * n_b;
  float* X = smem;                 // [kRows][w]
  float* Qs = X + kRows * w;       // [kSlab][w]
  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  const int nth = kLanes * kGroups;
  const int row0 = blockIdx.x * kRows;

  for (int idx = tid; idx < kRows * k_b; idx += nth) {
    const int r = idx / k_b, c = idx % k_b;
    const int row = row0 + r;
    X[r * w + c] = row < M ? init[(size_t)row * k_b + c] : 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    for (int idx = tid; idx < kRows * n_b; idx += nth) {
      const int r = idx / n_b, c = idx % n_b;
      const int row = row0 + r;
      X[r * w + k_b + c] =
          row < M ? fresh[(size_t)row * U + (size_t)t * n_b + c] : 0.0f;
    }
    float acc[kMaxRows][kMaxCols];
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i)
#pragma unroll
      for (int jc = 0; jc < kMaxCols; ++jc) acc[i][jc] = 0.0f;

    const float* qt = q + (size_t)t * w * w;
    for (int k0 = 0; k0 < w; k0 += kSlab) {
      const int ks = min(kSlab, w - k0);
      __syncthreads();  // X is loaded; the previous slab is consumed
      for (int idx = tid; idx < ks * w; idx += nth) Qs[idx] = qt[(size_t)k0 * w + idx];
      __syncthreads();
      for (int kk = 0; kk < ks; ++kk) {
        float qv[kMaxCols];
#pragma unroll
        for (int jc = 0; jc < kMaxCols; ++jc) {
          const int c = tx + kLanes * jc;
          qv[jc] = c < w ? Qs[kk * w + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kMaxRows; ++i) {
          const float xv = X[(ty + kGroups * i) * w + k0 + kk];
#pragma unroll
          for (int jc = 0; jc < kMaxCols; ++jc) acc[i][jc] = fmaf(xv, qv[jc], acc[i][jc]);
        }
      }
    }
    __syncthreads();  // every read of X for this tile is done
#pragma unroll
    for (int i = 0; i < kMaxRows; ++i) {
      const int r = ty + kGroups * i;
      const int row = row0 + r;
#pragma unroll
      for (int jc = 0; jc < kMaxCols; ++jc) {
        const int c = tx + kLanes * jc;
        if (c >= w) continue;
        if (c < n_b) {
          if (row < M) out[(size_t)row * U + (size_t)t * n_b + c] = acc[i][jc];
        } else {
          X[r * w + (c - n_b)] = acc[i][jc];
        }
      }
    }
  }
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
// Requires n_b + k_b <= 256.
extern "C" int rotseq_mxu_f32(const float* fresh, const float* q,
                              const float* init, float* out, int T, int n_b,
                              int k_b, int M, void* stream) {
  const int w = n_b + k_b;
  if (n_b < 1 || w > kLanes * kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kRows + kSlab) * w * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rotseq_mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (M + kRows - 1) / kRows;
  rotseq_mxu_kernel<<<blocks, kLanes * kGroups, smem, (cudaStream_t)stream>>>(
      fresh, q, init, out, T, n_b, k_b, M);
  return (int)cudaGetLastError();
}
