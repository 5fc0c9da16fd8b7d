// RA303 fixture: a plane update a fused multiply-add or a wrong pairing breaks.
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_batched.cu
constexpr int kBand = 16;
constexpr int kThreads = 64;

__device__ void good(float4 q, float& x, float& y) {
  const float xn = __fadd_rn(__fmul_rn(q.x, x), __fmul_rn(q.y, y));
  const float yn =
      __fmul_rn(q.z, __fsub_rn(__fmul_rn(q.y, x), __fmul_rn(q.x, y)));
  x = xn;
  y = yn;
}

__device__ void fused(float c, float s, float& x, float& y) {
  x = fmaf(c, x, __fmul_rn(s, y));  // expect: RA303
  y = __fma_rn(s, x, -c);  // expect: RA303
}

__device__ void swapped(float c, float s, float g, float& x, float& y) {
  const float xn = __fadd_rn(__fmul_rn(c, x), __fmul_rn(s, y));  // expect: RA303
  const float yn = __fmul_rn(g, __fsub_rn(__fmul_rn(c, y), __fmul_rn(s, x)));  // expect: RA303
  x = xn;
  y = yn;
}

__device__ float unsigned_row(float c, float s, float x, float y) {
  return __fsub_rn(__fmul_rn(s, x), __fmul_rn(c, y));  // expect: RA303
}

// a comment naming fmaf(a, b, c) is not code
/* nor is __fadd_rn(__fmul_rn(a, b), __fmul_rn(d, e)) in a block comment */
