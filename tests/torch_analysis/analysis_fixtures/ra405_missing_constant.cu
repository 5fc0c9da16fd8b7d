// RA405 fixture: the GEMM kernel no longer declares kRows.  // expect: RA405
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_mxu.cu
constexpr int kSlab = 32;
