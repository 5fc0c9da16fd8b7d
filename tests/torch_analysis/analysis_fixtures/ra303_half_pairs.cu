// RA303 fixture: the half plane form in pairs: the products of two planes
// rounded to the half type by one St::p2 each, the sum, the difference and
// g's product by one native paired op each; dropping one rounding breaks
// it.
// repro-torch-lint: fixture-as=src/repro_torch/csrc/rotseq_batched.cu
constexpr int kBand = 16;
constexpr int kThreads = 64;

template <typename T>
__device__ void good(float4 q0, float4 q1, float& x0, float& y0, float& x1,
                     float& y1) {
  const P2 cx = St::p2(__fmul_rn(q0.x, x0), __fmul_rn(q1.x, x1));
  const P2 sy = St::p2(__fmul_rn(q0.y, y0), __fmul_rn(q1.y, y1));
  const P2 sx = St::p2(__fmul_rn(q0.y, x0), __fmul_rn(q1.y, x1));
  const P2 cy = St::p2(__fmul_rn(q0.x, y0), __fmul_rn(q1.x, y1));
  const P2 g = St::bits(q0.z, q1.z);
  const P2 xs = __hadd2(cx, sy);
  const P2 d = __hsub2(sx, cy);
  const P2 ys = __hmul2(g, d);
}

template <typename T>
__device__ void difference_unrounded(float4 qd0, float4 qd1, float& xd0,
                                     float& yd0, float& xd1, float& yd1) {
  const P2 cx = St::p2(__fmul_rn(qd0.x, xd0), __fmul_rn(qd1.x, xd1));
  const P2 sy = St::p2(__fmul_rn(qd0.y, yd0), __fmul_rn(qd1.y, yd1));
  const P2 sx = St::p2(__fmul_rn(qd0.y, xd0), __fmul_rn(qd1.y, xd1));
  const P2 cy = St::p2(__fmul_rn(qd0.x, yd0), __fmul_rn(qd1.x, yd1));
  const P2 g = St::bits(qd0.z, qd1.z);
  // the sums lose their partners, the g-products round unlike
  const P2 xs = __hadd2(cx, sy);  // expect: RA303
  const float2 d = make_float2(__fsub_rn(sx.x, cy.x), __fsub_rn(sx.y, cy.y));
  const P2 ys = __hmul2(g, d);  // expect: RA303
}

template <typename T>
__device__ void result_unrounded(float4 qr0, float4 qr1, float& xr0,
                                 float& yr0, float& xr1, float& yr1) {
  const P2 cx = St::p2(__fmul_rn(qr0.x, xr0), __fmul_rn(qr1.x, xr1));
  const P2 sy = St::p2(__fmul_rn(qr0.y, yr0), __fmul_rn(qr1.y, yr1));
  const P2 sx = St::p2(__fmul_rn(qr0.y, xr0), __fmul_rn(qr1.y, xr1));
  const P2 cy = St::p2(__fmul_rn(qr0.x, yr0), __fmul_rn(qr1.x, yr1));
  const P2 g = St::bits(qr0.z, qr1.z);
  const P2 xs = __hadd2(cx, sy);
  const P2 d = __hsub2(sx, cy);
  yr0 = __fmul_rn(g.x, d.x);  // expect: RA303
  yr1 = __fmul_rn(g.y, d.y);  // expect: RA303
}

template <typename T>
__device__ void product_unrounded(float4 qp0, float4 qp1, float& xp0,
                                  float& yp0, float& xp1, float& yp1) {
  const float2 cx = make_float2(__fmul_rn(qp0.x, xp0), __fmul_rn(qp1.x, xp1));
  const P2 sy = St::p2(__fmul_rn(qp0.y, yp0), __fmul_rn(qp1.y, yp1));
  const P2 sx = St::p2(__fmul_rn(qp0.y, xp0), __fmul_rn(qp1.y, xp1));
  const P2 cy = St::p2(__fmul_rn(qp0.x, yp0), __fmul_rn(qp1.x, yp1));
  const P2 g = St::bits(qp0.z, qp1.z);
  // the sum mixes a rounded and an unrounded product
  const P2 xs = __hadd2(cx, sy);  // expect: RA303
  const P2 d = __hsub2(sx, cy);
  const P2 ys = __hmul2(g, d);  // expect: RA303
}
