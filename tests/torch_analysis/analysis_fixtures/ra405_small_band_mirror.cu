// RA405 fixture: the wavefront kernel's small band compiled at another value than limits says.
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_wave.cu
constexpr int kBand = 16;
constexpr int kSmallBand = 8;  // expect: RA405
constexpr int kWarps = 12;
constexpr int kSmallRows = 4;
constexpr int kSmallBands = 8;
constexpr int kSmallWarps = 2;

__device__ void plane(float4 c, float& x, float& y) {
  const float xn = __fadd_rn(__fmul_rn(c.x, x), __fmul_rn(c.y, y));
  const float yn =
      __fmul_rn(c.z, __fsub_rn(__fmul_rn(c.y, x), __fmul_rn(c.x, y)));
  x = xn;
  y = yn;
}
