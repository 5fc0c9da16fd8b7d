// Fused half-split rotary position embedding on q and k (float32 and
// bfloat16, sm_90a).
//
// Replaces: src/repro/kernels/rope/kernel.py::rope_pallas (body
// _rope_kernel), mapped over the batch by repro.kernels.rope.ops.apply_rope.
//
// What it computes: for q (B, S, Hq, D) and k (B, S, Hk, D), contiguous,
// and tables cos, sin (S, D/2), every head vector's pair (x1, x2) =
// (x[i], x[i + D/2]) becomes [x1*c - x2*s, x1*s + x2*c] with c, s the
// tables at (position, i).  Outputs are new tensors of the inputs' shapes;
// the inputs are not modified.  With `inverse` set the rotation is undone:
// s is read negated (an exact sign flip), so the pair becomes
// [x1*c + x2*s, x2*c - x1*s], the transpose of the forward rotation, which
// is its gradient: the backward of RoPE is this kernel on (dq, dk).
//
// What bounds it on an H100: bytes.  It reads q and k once and writes them
// once, and reads the tables once: 2*B*S*(Hq+Hk)*D*elt + 2*S*(D/2)*elt
// bytes for 6 flops a pair.  At decode (B = 8, S = 1, Hq = 9, Hk = 3,
// D = 64, bf16) that is ~25 KB, ~7 ns at 3.35 TB/s, so the cost of a
// launch and of one trip to memory sets its time there; a prefill
// (B = 8, S = 2048) moves 50 MB, ~15 us.
//
// Design.  A work item is (row r = b*S + s, head h of the Hq + Hk heads of
// q then k, chunk j): a chunk is kVec = 16 / elt consecutive pairs (4 in
// float32, 8 in bfloat16).  The item's thread loads x1 and x2 of its chunk
// as one 16-byte vector each, and the 16 bytes of cos and sin at its
// row's position (shared by the (Hq + Hk)*B chunks of a position, so they
// stay in L1/L2), rotates, and stores two 16-byte vectors.  Items are
// numbered chunk fastest, then head, then row, so a warp covers whole
// heads contiguously: at D = 64 in bfloat16, 4 threads x 16 bytes make one
// 64-byte half, and every 32-byte sector read is used in full.
//
// Two launch shapes, by the number of items (tools/rope_sweep.py times
// the others on the card).  A narrow launch (at most kNarrowItems items,
// as at decode: 384) gives each item its own thread in blocks of
// kNarrowThreads, so its one trip to memory is spread over as many SMs as
// there are warps; its time falls with the SMs it reaches.  A wide launch
// (a prefill) gives each thread kItems items in blocks of kThreads, all
// loaded before any is rotated, so enough bytes are in flight to fill HBM
// (at D = 64 in bfloat16 a warp's 16-byte loads touch half lines, and one
// item a thread left a quarter of the bandwidth unused).  Blocks stride
// over the items when kBlocksPerSM caps the grid (0: the grid covers
// every item once, which measured faster).
//
// The vector path needs (D/2)*elt to be a multiple of 16 and the six
// pointers 16-byte aligned (rope_vector_path, mirrored by the wrapper's
// vector_path).  Anything else (D = 10, a view that starts one element
// into its buffer) takes the scalar path: an item is one pair (r, h, i),
// in the same order, loaded and stored an element at a time.
//
// Rounding: as PyTorch's eager ops round, each product and each sum on
// its own (__fmul_rn / __fsub_rn / __fadd_rn are never contracted, and the
// build passes --fmad=false); for bfloat16 each product is rounded to
// bfloat16 before the subtraction or addition, as an eager bf16 multiply
// is, and the sum is rounded to bfloat16 when it is stored.  So both paths
// equal the plain PyTorch version bit for bit in both dtypes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;         // threads a block of a wide launch
constexpr int kItems = 2;             // items a thread of a wide launch
constexpr int kBlocksPerSM = 0;       // wide grid's cap; 0: every item
constexpr int kNarrowThreads = 32;    // threads a block of a narrow launch
constexpr int kNarrowItems = 16384;   // most items of a narrow launch

struct F32 {
  using T = float;
  static constexpr int kVec = 4;  // pairs a 16-byte chunk
  __device__ static float load(const float* p) { return *p; }
  __device__ static float round(float v) { return v; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void unpack(const uint4& v, float (&f)[4]) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

struct BF16 {
  using T = __nv_bfloat16;
  static constexpr int kVec = 8;
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
  // a 32-bit word holds two bf16, the lower-addressed in its low half; a
  // bf16 is the high half of the float it stands for
  __device__ static void unpack2(uint32_t w, float& a, float& b) {
    a = __uint_as_float(w << 16);
    b = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static uint32_t pack2(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  __device__ static void unpack(const uint4& v, float (&f)[8]) {
    unpack2(v.x, f[0], f[1]);
    unpack2(v.y, f[2], f[3]);
    unpack2(v.z, f[4], f[5]);
    unpack2(v.w, f[6], f[7]);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// the pair (x1, x2) rotated by (c, s), rounded as the eager ops round
template <class E>
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       float& o1, float& o2) {
  const float a = E::round(__fmul_rn(x1, c));
  const float b = E::round(__fmul_rn(x2, s));
  const float d = E::round(__fmul_rn(x1, s));
  const float e = E::round(__fmul_rn(x2, c));
  o1 = __fsub_rn(a, b);
  o2 = __fadd_rn(d, e);
}

// Where item t's first element lies: its operand (q or k), the element
// offset of x1 in it, and the element offset of c in the tables.  `per`
// is the items of a head half (chunks, or pairs on the scalar path), `n`
// the elements an item covers (kVec, or 1).
template <class Idx>
__device__ __forceinline__ void locate(Idx t, Idx per, Idx n, Idx heads,
                                       Idx Hq, Idx Hk, Idx S, Idx half,
                                       bool& is_q, size_t& x, size_t& tab) {
  const Idx j = t % per;
  const Idx u = t / per;
  const Idx h = u % heads;
  const Idx r = u / heads;
  const Idx pos = r % S;
  is_q = h < Hq;
  const size_t head = is_q ? (size_t)r * Hq + h : (size_t)r * Hk + (h - Hq);
  x = head * (2 * (size_t)half) + (size_t)j * n;
  tab = (size_t)pos * half + (size_t)j * n;
}

template <class E, int kPer>
__global__ void __launch_bounds__(kThreads)
    rope_vec_kernel(const typename E::T* __restrict__ q,
                    const typename E::T* __restrict__ k,
                    const typename E::T* __restrict__ cos_t,
                    const typename E::T* __restrict__ sin_t,
                    typename E::T* __restrict__ qo,
                    typename E::T* __restrict__ ko, uint32_t items,
                    uint32_t chunks, uint32_t heads, uint32_t Hq, uint32_t Hk,
                    uint32_t S, uint32_t half, bool inverse) {
  using T = typename E::T;
  constexpr int V = E::kVec;
  const unsigned long long block = (unsigned long long)blockDim.x * kPer;
  for (unsigned long long base = blockIdx.x * block + threadIdx.x;
       base < items; base += gridDim.x * block) {
    uint4 x1[kPer], x2[kPer], cv[kPer], sv[kPer];
    T* out[kPer];
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      const unsigned long long t = base + (unsigned long long)it * blockDim.x;
      out[it] = nullptr;
      if (t >= items) continue;
      bool is_q;
      size_t xo, to;
      locate<uint32_t>((uint32_t)t, chunks, V, heads, Hq, Hk, S, half, is_q,
                       xo, to);
      const T* x = (is_q ? q : k) + xo;
      out[it] = (is_q ? qo : ko) + xo;
      x1[it] = *reinterpret_cast<const uint4*>(x);
      x2[it] = *reinterpret_cast<const uint4*>(x + half);
      cv[it] = *reinterpret_cast<const uint4*>(cos_t + to);
      sv[it] = *reinterpret_cast<const uint4*>(sin_t + to);
    }
#pragma unroll
    for (int it = 0; it < kPer; ++it) {
      if (out[it] == nullptr) continue;
      float a[V], b[V], c[V], s[V], o1[V], o2[V];
      E::unpack(x1[it], a);
      E::unpack(x2[it], b);
      E::unpack(cv[it], c);
      E::unpack(sv[it], s);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        rotate<E>(a[e], b[e], c[e], inverse ? -s[e] : s[e], o1[e], o2[e]);
      }
      *reinterpret_cast<uint4*>(out[it]) = E::pack(o1);
      *reinterpret_cast<uint4*>(out[it] + half) = E::pack(o2);
    }
  }
}

template <class E>
__global__ void __launch_bounds__(kThreads)
    rope_scalar_kernel(const typename E::T* __restrict__ q,
                       const typename E::T* __restrict__ k,
                       const typename E::T* __restrict__ cos_t,
                       const typename E::T* __restrict__ sin_t,
                       typename E::T* __restrict__ qo,
                       typename E::T* __restrict__ ko,
                       unsigned long long items, unsigned long long heads,
                       unsigned long long Hq, unsigned long long Hk,
                       unsigned long long S, unsigned long long half,
                       bool inverse) {
  using T = typename E::T;
  const unsigned long long stride = (unsigned long long)gridDim.x * kThreads;
  for (unsigned long long t =
           (unsigned long long)blockIdx.x * kThreads + threadIdx.x;
       t < items; t += stride) {
    bool is_q;
    size_t xo, to;
    locate<unsigned long long>(t, half, 1, heads, Hq, Hk, S, half, is_q, xo,
                               to);
    const T* x = (is_q ? q : k) + xo;
    T* o = (is_q ? qo : ko) + xo;
    float o1, o2;
    const float sn = E::load(sin_t + to);
    rotate<E>(E::load(x), E::load(x + half), E::load(cos_t + to),
              inverse ? -sn : sn, o1, o2);
    E::store(o, o1);
    E::store(o + half, o2);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

bool vector_path(const void* q, const void* k, const void* cos_t,
                 const void* sin_t, const void* qo, const void* ko, int D,
                 int elt) {
  return ((D / 2) * elt) % 16 == 0 && aligned16(q) && aligned16(k) &&
         aligned16(cos_t) && aligned16(sin_t) && aligned16(qo) &&
         aligned16(ko);
}

// blocks for `items` items of `per_block` a pass, capped at kBlocksPerSM
// an SM when `capped` and that is set
unsigned grid_for(unsigned long long items, unsigned long long per_block,
                  bool capped) {
  unsigned long long blocks = (items + per_block - 1) / per_block;
  if (capped && kBlocksPerSM > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const unsigned long long cap = (unsigned long long)sms * kBlocksPerSM;
    if (cap > 0 && blocks > cap) blocks = cap;
  }
  return blocks > 0x7fffffffULL ? 0x7fffffffu : (unsigned)blocks;
}

template <class E>
int launch(const void* q, const void* k, const void* cos_t, const void* sin_t,
           void* qo, void* ko, int B, int S, int Hq, int Hk, int D,
           int inverse, void* stream) {
  using T = typename E::T;
  const unsigned long long half = D / 2;
  const unsigned long long heads = (unsigned long long)Hq + Hk;
  const unsigned long long pairs = (unsigned long long)B * S * heads * half;
  if (pairs == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vector_path(q, k, cos_t, sin_t, qo, ko, D, sizeof(T))) {
    const unsigned long long items = pairs / E::kVec;
    // an item is 32 bytes of q or k: 2^32 of them would be 128 GB
    if (items > 0xffffffffULL) return (int)cudaErrorInvalidValue;
    const uint32_t args[] = {(uint32_t)items, (uint32_t)(half / E::kVec),
                             (uint32_t)heads, (uint32_t)Hq, (uint32_t)Hk,
                             (uint32_t)S, (uint32_t)half};
    if (items <= (unsigned long long)kNarrowItems) {
      rope_vec_kernel<E, 1>
          <<<grid_for(items, kNarrowThreads, false), kNarrowThreads, 0, st>>>(
              (const T*)q, (const T*)k, (const T*)cos_t, (const T*)sin_t,
              (T*)qo, (T*)ko, args[0], args[1], args[2], args[3], args[4],
              args[5], args[6], inverse != 0);
    } else {
      rope_vec_kernel<E, kItems>
          <<<grid_for(items, kThreads * kItems, true), kThreads, 0, st>>>(
              (const T*)q, (const T*)k, (const T*)cos_t, (const T*)sin_t,
              (T*)qo, (T*)ko, args[0], args[1], args[2], args[3], args[4],
              args[5], args[6], inverse != 0);
    }
  } else {
    rope_scalar_kernel<E><<<grid_for(pairs, kThreads, true), kThreads, 0,
                            st>>>(
        (const T*)q, (const T*)k, (const T*)cos_t, (const T*)sin_t, (T*)qo,
        (T*)ko, pairs, heads, (unsigned long long)Hq, (unsigned long long)Hk,
        (unsigned long long)S, half, inverse != 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Launches on `stream`, does not
// synchronise and allocates nothing; returns cudaGetLastError().
// `inverse` != 0 rotates by -s (the backward).
extern "C" int rope_f32(const void* q, const void* k, const void* cos_t,
                        const void* sin_t, void* qo, void* ko, int B, int S,
                        int Hq, int Hk, int D, int inverse, void* stream) {
  return launch<F32>(q, k, cos_t, sin_t, qo, ko, B, S, Hq, Hk, D, inverse,
                     stream);
}

extern "C" int rope_bf16(const void* q, const void* k, const void* cos_t,
                         const void* sin_t, void* qo, void* ko, int B, int S,
                         int Hq, int Hk, int D, int inverse, void* stream) {
  return launch<BF16>(q, k, cos_t, sin_t, qo, ko, B, S, Hq, Hk, D, inverse,
                      stream);
}

// 1 if rope_f32 / rope_bf16 (elt = 4 / 2) take the vector path for these
// pointers and head_dim, 0 if the scalar one: the rule the wrapper's
// vector_path mirrors, exported so the card can check the two agree.
extern "C" int rope_vector_path(const void* q, const void* k,
                                const void* cos_t, const void* sin_t,
                                const void* qo, const void* ko, int D,
                                int elt) {
  return vector_path(q, k, cos_t, sin_t, qo, ko, D, elt) ? 1 : 0;
}
