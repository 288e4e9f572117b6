// The per-edge Gauss-Newton terms of the rows front end for Hopper (sm_90a).
//
//   edge_terms_kernel <- no Pallas kernel: on the TPU, XLA fused
//                   cuba_tpu/solver/edgerows.py:132 term_rows (the rotation,
//                   the projection Jacobians, the IRLS weight and the
//                   weighted products) into the code around it.  In the port
//                   the same torch code (solver/edgerows.py term_rows_plain)
//                   ran as ~90 elementwise launches, stacks and cats and
//                   cuBLAS's batched GEMMs over E products of 6x2 by 2x6
//                   (k = 2 or 3 deep), each through device memory.
//
// For each lane e of one edge type (mdim 2 mono, 3 stereo):
//   R = R(q) from g12[0:4]; the Jacobians JP [mdim, 6], JL [mdim, 3] from
//   X, Y (Xc[0:2]), inv_z, fu, fv (g12[7:9]) and bf (g12[11], stereo), term
//   for term as solver/edgerows.py jac_rows; x = omega |err|^2 and w = omega
//   rho'(x) for none, Huber or Tukey (ops/robust.py weight); then, with
//   wJ = w J,
//   v42 = [Hpp (i*6+j) = sum_k wJP[k,i] JP[k,j]; bp (i) = sum_k wJP[k,i] err[k]]
//   v12 = [Hll (a*3+b) = sum_k wJL[k,a] JL[k,b]; bl (a) = sum_k wJL[k,a] err[k]]
//   v18 = [Hpl (i*3+b) = sum_k wJP[k,i] JL[k,b]]
// each sum from k = 0 by fma in k order, in the working type.  Hpp and Hll
// are formed for i <= j only (21 and 6 products) and stored at both mirror
// positions, so each table is exactly symmetric.  Padding lanes (omega 0,
// err 0, finite gathered zeros) come out 0.
//
// Bound by device-memory bytes: a lane reads 12 values (q 4, fu fv 2, err 2,
// X Y 2, inv_z, omega; stereo 14: err 3 and bf) and writes 72, 336 bytes in
// fp32 (344 stereo, twice that in fp64), for ~240-380 flops: ~1 flop a byte
// against a ridge of ~20.  So the design moves each byte once and keeps
// everything between the inputs and the three tables in registers: one
// thread a lane, 256 a block, every input row loaded and every output row
// stored by a warp as one contiguous 128-byte run (the tables are [D, E], E
// fastest); nothing staged, no shared memory.  The robust kind and mdim are
// template parameters, chosen per launch by the wrapper from the edge
// type's kernel and err's rows.  No fast-math: sqrt and division are the
// correctly rounded ones, and nvcc contracts only a * b + c into FMAs.
//
// Element types: a template on T, built for float (entry cuba_edge_terms)
// and double (cuba_edge_terms_f64, the same parameters with double* for
// float*).  Index arithmetic is int32 (the wrapper checks 42 E).  The kernel
// allocates nothing; the entry point launches on the caller's stream and
// returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInt32Max = 0x7fffffff;

// ops/robust.py's kernel types
constexpr int kNone = 0;
constexpr int kHuber = 1;
constexpr int kTukey = 2;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
// one rounding each, never merged into an FMA: the plain version's
// elementwise torch operations, operation for operation
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// rho'(x), the IRLS weight, as robust.weight computes it on the card:
// torch's delta / sqrt(t) is reciprocal(sqrt(t)) * delta, and its x / d2
// (a CPU scalar) x * (1 / d2), with 1 / d2 rounded in T
template <int KIND, typename T>
__device__ __forceinline__ T irls_weight(T x, T delta, T d2, T inv_d2) {
  if (KIND == kHuber) {
    const T safe = x < d2 ? d2 : x;
    return x <= d2 ? T(1) : mul(T(1) / sqrt(safe), delta);
  }
  if (KIND == kTukey) {
    const T t = sub(T(1), mul(x, inv_d2));
    return x <= d2 ? mul(t, t) : T(0);
  }
  return T(1);
}

// the N x N symmetric table sum_k a[k][i] b[k][j] into out's rows i*N+j
// (column stride E): formed for i <= j, stored at (i, j) and (j, i)
template <int MDIM, int N, typename T>
__device__ __forceinline__ void store_sym(const T (&a)[MDIM][N], const T (&b)[MDIM][N],
                                          T* __restrict__ out, int E) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j) {
      T h = mul(a[0][i], b[0][j]);
#pragma unroll
      for (int k = 1; k < MDIM; ++k) h = fma_rn(a[k][i], b[k][j], h);
      out[(i * N + j) * E] = h;
      if (j != i) out[(j * N + i) * E] = h;
    }
  }
}

// the N-vector sum_k a[k][i] v[k] into out's rows i (column stride E)
template <int MDIM, int N, typename T>
__device__ __forceinline__ void store_vec(const T (&a)[MDIM][N], const T (&v)[MDIM],
                                          T* __restrict__ out, int E) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T h = mul(a[0][i], v[0]);
#pragma unroll
    for (int k = 1; k < MDIM; ++k) h = fma_rn(a[k][i], v[k], h);
    out[i * E] = h;
  }
}

template <int MDIM, int KIND, typename T>
__global__ void __launch_bounds__(kThreads)
    edge_terms_kernel(const T* __restrict__ g12, const T* __restrict__ err,
                      const T* __restrict__ xc, const T* __restrict__ inv_z,
                      const T* __restrict__ omega, T delta, T d2, T inv_d2,
                      T* __restrict__ v42, T* __restrict__ v12, T* __restrict__ v18, int E) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= E) return;
  const T qx = g12[e], qy = g12[E + e], qz = g12[2 * E + e], qw = g12[3 * E + e];
  const T fu = g12[7 * E + e], fv = g12[8 * E + e];
  const T X = xc[e], Y = xc[E + e];
  const T iz = inv_z[e];
  const T om = omega[e];
  T ek[MDIM];
#pragma unroll
  for (int k = 0; k < MDIM; ++k) ek[k] = err[k * E + e];

  // edgerows.rotmat_rows
  const T tx = mul(T(2), qx), ty = mul(T(2), qy), tz = mul(T(2), qz);
  const T twx = mul(tx, qw), twy = mul(ty, qw), twz = mul(tz, qw);
  const T txx = mul(tx, qx), txy = mul(ty, qx), txz = mul(tz, qx);
  const T tyy = mul(ty, qy), tyz = mul(tz, qy), tzz = mul(tz, qz);
  const T R[3][3] = {{sub(T(1), add(tyy, tzz)), sub(txy, twz), add(txz, twy)},
                     {add(txy, twz), sub(T(1), add(txx, tzz)), sub(tyz, twx)},
                     {sub(txz, twy), add(tyz, twx), sub(T(1), add(txx, tyy))}};

  // edgerows.jac_rows
  T JP[MDIM][6], JL[MDIM][3];
  if constexpr (MDIM == 2) {
    const T x = mul(iz, X), y = mul(iz, Y);
    const T fu_iz = mul(fu, iz), fv_iz = mul(fv, iz);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      JL[0][c] = mul(-fu_iz, sub(R[0][c], mul(x, R[2][c])));
      JL[1][c] = mul(-fv_iz, sub(R[1][c], mul(y, R[2][c])));
    }
    const T jp[2][6] = {{mul(mul(fu, x), y), mul(-fu, add(T(1), mul(x, x))), mul(fu, y), -fu_iz,
                         T(0), mul(fu_iz, x)},
                        {mul(fv, add(T(1), mul(y, y))), mul(mul(-fv, x), y), mul(-fv, x), T(0),
                         -fv_iz, mul(fv_iz, y)}};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int i = 0; i < 6; ++i) JP[k][i] = jp[k][i];
    }
  } else {
    const T izz = mul(iz, iz);
    const T bf = g12[11 * E + e];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      JL[0][c] = add(mul(mul(-fu, R[0][c]), iz), mul(mul(mul(fu, X), R[2][c]), izz));
      JL[1][c] = add(mul(mul(-fv, R[1][c]), iz), mul(mul(mul(fv, Y), R[2][c]), izz));
      JL[2][c] = sub(JL[0][c], mul(mul(bf, R[2][c]), izz));
    }
    const T xy_izz = mul(mul(X, Y), izz);
    const T jp0[6] = {mul(xy_izz, fu), mul(-add(T(1), mul(mul(X, X), izz)), fu),
                      mul(mul(Y, iz), fu), mul(-iz, fu), T(0), mul(mul(X, izz), fu)};
    const T jp1[6] = {mul(add(T(1), mul(mul(Y, Y), izz)), fv), mul(-xy_izz, fv),
                      mul(mul(-X, iz), fv), T(0), mul(-iz, fv), mul(mul(Y, izz), fv)};
    const T jp2[6] = {sub(jp0[0], mul(mul(bf, Y), izz)), add(jp0[1], mul(mul(bf, X), izz)),
                      jp0[2], jp0[3], T(0), sub(jp0[5], mul(bf, izz))};
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      JP[0][i] = jp0[i];
      JP[1][i] = jp1[i];
      JP[2][i] = jp2[i];
    }
  }

  // w = omega rho'(omega |err|^2), |err|^2 summed in k order
  T s = mul(ek[0], ek[0]);
#pragma unroll
  for (int k = 1; k < MDIM; ++k) s = add(s, mul(ek[k], ek[k]));
  const T w = mul(om, irls_weight<KIND>(mul(om, s), delta, d2, inv_d2));
  T wJP[MDIM][6], wJL[MDIM][3];
#pragma unroll
  for (int k = 0; k < MDIM; ++k) {
#pragma unroll
    for (int i = 0; i < 6; ++i) wJP[k][i] = mul(w, JP[k][i]);
#pragma unroll
    for (int a = 0; a < 3; ++a) wJL[k][a] = mul(w, JL[k][a]);
  }

  v42 += e;
  v12 += e;
  v18 += e;
  store_sym<MDIM, 6>(wJP, JP, v42, E);
  store_vec<MDIM, 6>(wJP, ek, v42 + 36 * E, E);
  store_sym<MDIM, 3>(wJL, JL, v12, E);
  store_vec<MDIM, 3>(wJL, ek, v12 + 9 * E, E);
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T h = mul(wJP[0][i], JL[0][b]);
#pragma unroll
      for (int k = 1; k < MDIM; ++k) h = fma_rn(wJP[k][i], JL[k][b], h);
      v18[(i * 3 + b) * E] = h;
    }
  }
}

template <int MDIM, int KIND, typename T>
void launch(const T* g12, const T* err, const T* xc, const T* inv_z, const T* omega,
            const T (&robust)[3], T* v42, T* v12, T* v18, int E, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((E + kThreads - 1) / kThreads);
  edge_terms_kernel<MDIM, KIND, T><<<blocks, kThreads, 0, stream>>>(
      g12, err, xc, inv_z, omega, robust[0], robust[1], robust[2], v42, v12, v18, E);
}

template <typename T>
int edge_terms(const T* g12, const T* err, const T* xc, const T* inv_z, const T* omega,
               int64_t mdim, int64_t kind, double delta, T* v42, T* v12, T* v18, int64_t E,
               void* stream) {
  if (E < 0 || 42 * E > kInt32Max || (mdim != 2 && mdim != 3) || kind < kNone ||
      kind > kTukey) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E == 0) return static_cast<int>(cudaGetLastError());
  // delta, d2 = delta * delta (formed in double) and 1 / d2, each in T, as
  // torch takes a Python float against a T tensor
  const T d2 = static_cast<T>(delta * delta);
  const T robust[3] = {static_cast<T>(delta), d2, T(1) / d2};
  const int n = static_cast<int>(E);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mdim * 3 + kind) {
    case 6: launch<2, kNone, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st); break;
    case 7: launch<2, kHuber, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st); break;
    case 8: launch<2, kTukey, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st); break;
    case 9: launch<3, kNone, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st); break;
    case 10: launch<3, kHuber, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st); break;
    default: launch<3, kTukey, T>(g12, err, xc, inv_z, omega, robust, v42, v12, v18, n, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g12 [12, E] (q 0-3, t 4-6, fu fv cu cv bf 7-11), err [mdim, E], xc [3, E],
// inv_z [E], omega [E]; v42 [42, E], v12 [12, E], v18 [18, E]; all
// contiguous, 42 E within int32; mdim 2 or 3; kind 0 none, 1 Huber, 2 Tukey
// with parameter delta.
int cuba_edge_terms(const float* g12, const float* err, const float* xc, const float* inv_z,
                    const float* omega, int64_t mdim, int64_t kind, double delta, float* v42,
                    float* v12, float* v18, int64_t E, void* stream) {
  return edge_terms(g12, err, xc, inv_z, omega, mdim, kind, delta, v42, v12, v18, E, stream);
}

int cuba_edge_terms_f64(const double* g12, const double* err, const double* xc,
                        const double* inv_z, const double* omega, int64_t mdim, int64_t kind,
                        double delta, double* v42, double* v12, double* v18, int64_t E,
                        void* stream) {
  return edge_terms(g12, err, xc, inv_z, omega, mdim, kind, delta, v42, v12, v18, E, stream);
}

}  // extern "C"
