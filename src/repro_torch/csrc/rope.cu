// Fused half-split rotary position embedding on q and k (float32 and
// bfloat16, sm_90a).
//
// Replaces: src/repro/kernels/rope/kernel.py::rope_pallas (body
// _rope_kernel), mapped over the batch by repro.kernels.rope.ops.apply_rope.
//
// What it computes: for q (B, S, Hq, D) and k (B, S, Hk, D), contiguous,
// and tables cos, sin (S, D/2), every head vector's pair (x1, x2) =
// (x[i], x[i + D/2]) becomes [x1*c - x2*s, x1*s + x2*c] with c, s the
// tables at (position, i).  Outputs are new tensors of the inputs' shapes.
//
// What bounds it on an H100: bytes.  It reads q and k once and writes them
// once, and reads the tables once: 2*B*S*(Hq+Hk)*D*elt + 2*S*(D/2)*elt
// bytes for 6 flops a pair.  At decode (B = 8, S = 1, Hq = 9, Hk = 3,
// D = 64, bf16) that is ~25 KB, ~7 ns at 3.35 TB/s, so a launch's few
// microseconds of overhead set its time there; prefill is bandwidth-bound.
//
// Design: one thread per (b, s, i) with i < D/2, one launch for the whole
// batch.  The thread loads (c, s) once and rotates pair i of all Hq heads
// of q and all Hk heads of k: the tables are read once for both operands,
// the point of the TPU kernel.  Neighbouring threads take neighbouring i,
// so each head's halves are read and written coalesced.  The ragged edge
// is masked, so any S works (the TPU kernel asserts S % blk == 0).
//
// Rounding: as PyTorch's eager ops round, each product and each sum on
// its own (__fmul_rn / __fsub_rn / __fadd_rn are never contracted, and the
// build passes --fmad=false); for bfloat16 each product and each sum is
// rounded to bfloat16 (__float2bfloat16_rn) before the next operation, as
// an eager bf16 multiply and subtract do.  So the kernel equals its plain
// PyTorch version bit for bit in both dtypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct F32 {
  using T = float;
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
};

struct BF16 {
  using T = __nv_bfloat16;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // an eager bf16 op computes in float and rounds its result to bf16
  __device__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

template <class E>
__device__ __forceinline__ void rotate_pair(const typename E::T* x,
                                            typename E::T* o, int half,
                                            float c, float s) {
  const float x1 = E::load(x);
  const float x2 = E::load(x + half);
  const float a = E::round(__fmul_rn(x1, c));
  const float b = E::round(__fmul_rn(x2, s));
  const float d = E::round(__fmul_rn(x1, s));
  const float e = E::round(__fmul_rn(x2, c));
  E::store(o, __fsub_rn(a, b));
  E::store(o + half, __fadd_rn(d, e));
}

template <class E>
__global__ void rope_kernel(const typename E::T* __restrict__ q,
                            const typename E::T* __restrict__ k,
                            const typename E::T* __restrict__ cos_t,
                            const typename E::T* __restrict__ sin_t,
                            typename E::T* __restrict__ qo,
                            typename E::T* __restrict__ ko, long long pairs,
                            int S, int Hq, int Hk, int D) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int half = D / 2;
  const int i = (int)(t % half);
  const long long bs = t / half;  // b * S + s
  const int pos = (int)(bs % S);
  const float c = E::load(cos_t + (size_t)pos * half + i);
  const float s = E::load(sin_t + (size_t)pos * half + i);
  const size_t q0 = (size_t)bs * Hq * D + i;
  for (int h = 0; h < Hq; ++h) {
    rotate_pair<E>(q + q0 + (size_t)h * D, qo + q0 + (size_t)h * D, half, c,
                   s);
  }
  const size_t k0 = (size_t)bs * Hk * D + i;
  for (int h = 0; h < Hk; ++h) {
    rotate_pair<E>(k + k0 + (size_t)h * D, ko + k0 + (size_t)h * D, half, c,
                   s);
  }
}

constexpr int kThreads = 256;

template <class E>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t,
           void* qo, void* ko, int B, int S, int Hq, int Hk, int D,
           void* stream) {
  using T = typename E::T;
  const long long pairs = (long long)B * S * (D / 2);
  if (pairs == 0) return 0;
  const long long blocks = (pairs + kThreads - 1) / kThreads;
  rope_kernel<E><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)cos_t, (const T*)sin_t, (T*)qo,
      (T*)ko, pairs, S, Hq, Hk, D);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
extern "C" int rope_f32(const void* q, const void* k, const void* cos_t,
                        const void* sin_t, void* qo, void* ko, int B, int S,
                        int Hq, int Hk, int D, void* stream) {
  return launch<F32>(q, k, cos_t, sin_t, qo, ko, B, S, Hq, Hk, D, stream);
}

extern "C" int rope_bf16(const void* q, const void* k, const void* cos_t,
                         const void* sin_t, void* qo, void* ko, int B, int S,
                         int Hq, int Hk, int D, void* stream) {
  return launch<BF16>(q, k, cos_t, sin_t, qo, ko, B, S, Hq, Hk, D, stream);
}
