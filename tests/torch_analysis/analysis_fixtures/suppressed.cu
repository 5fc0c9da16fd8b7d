// A CUDA source with its findings silenced: must produce no violation.
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_wave.cu
constexpr int kBand = 16;
constexpr int kSmallBand = 4;
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

__device__ float scale(float a, float b, float c) {
  return fmaf(a, b, c);  // repro-torch-lint: disable=RA303
}

__device__ float scale_next(float a, float b, float c) {
  // repro-torch-lint: disable-next=RA3
  return __fmaf_rn(a, b, c);
}
