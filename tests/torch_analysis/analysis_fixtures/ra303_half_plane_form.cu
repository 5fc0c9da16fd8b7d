// RA303 fixture: the half plane form, each product and sum rounded to the
// half type; an unrounded product, difference or result breaks it.
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_wave.cu
constexpr int kBand = 16;
constexpr int kWarps = 12;

template <typename T>
__device__ void good(float4 c, T& x, T& y) {
  const float xf = St::f(x);
  const float yf = St::f(y);
  x = St::h(__fadd_rn(St::r(__fmul_rn(c.x, xf)), St::r(__fmul_rn(c.y, yf))));
  y = St::h(__fmul_rn(c.z, St::r(__fsub_rn(St::r(__fmul_rn(c.y, xf)),
                                           St::r(__fmul_rn(c.x, yf))))));
}

template <typename T>
__device__ void one_product_unrounded(float a, float b, float g, T& x,
                                      T& y, float u, float v) {
  // the sum is not a plane, so the difference loses its partner
  x = St::h(__fadd_rn(St::r(__fmul_rn(a, u)), __fmul_rn(b, v)));  // expect: RA303
  y = St::h(__fmul_rn(g, St::r(__fsub_rn(St::r(__fmul_rn(b, u)),  // expect: RA303
                                         St::r(__fmul_rn(a, v))))));
}

template <typename T>
__device__ void results_unrounded(float c, float s, float g, float& x,
                                  float& y, float xf, float yf) {
  x = __fadd_rn(St::r(__fmul_rn(c, xf)), St::r(__fmul_rn(s, yf)));  // expect: RA303
  y = __fmul_rn(g, St::r(__fsub_rn(St::r(__fmul_rn(s, xf)), St::r(__fmul_rn(c, yf)))));  // expect: RA303
}

template <typename T>
__device__ void difference_unrounded(float c, float s, float g, T& x, T& y,
                                     float xf, float yf) {
  x = St::h(__fadd_rn(St::r(__fmul_rn(c, xf)), St::r(__fmul_rn(s, yf))));
  y = St::h(__fmul_rn(g, __fsub_rn(St::r(__fmul_rn(s, xf)), St::r(__fmul_rn(c, yf)))));  // expect: RA303
}
