// The Schur factors of the rows front end for Hopper (sm_90a).
//
//   hll_inverse_kernel <- no Pallas kernel: on the TPU, XLA fused
//   slot_factors_kernel   cuba_tpu/solver/mxu.py prepare_factors_mxu (the
//                         damped fp64 3x3 inverse, the per-slot W = Hpl
//                         Hll^-1 and W bl) into the code around it.  In the
//                         port the same torch code (solver/rows.py
//                         hll_inverse_plain, slot_factors_plain) ran as a
//                         clone, ~30 fp64 elementwise launches, a stack, a
//                         cast and a cat, then cuBLAS's batched gemmSN_NN
//                         (6x3 by 3x3 over the slots, batch on the last
//                         axis) and gemvx for W bl, with their permuted
//                         copies, each through device memory.
//
// hll_inverse_kernel, for each landmark l of HllT [12, L] (Hll row-major
// a*3+b, then bl):
//   the damped diagonal a_ii = Hll_ii + lam, rounded in the working type T
//   (lam is a 0-d device tensor, read through its pointer: no host read);
//   then in double, term for term as solver/rows.py _sym3x3_inv_rows (the
//   reference's Sym3x3Inv), one rounding an operation:
//     det = a00 a11 a22 + a01 a12 a02 + a02 a01 a12
//           - a00 a12 a12 - a02 a11 a02 - a01 a01 a22,
//     b_ij = (1 / det) * cofactor_ij,
//   each b rounded once to T.  It writes out [12, L] = [Hll^-1 (9 rows,
//   symmetric); bl (3 rows, copied)], the table the slot gather reads.
//   Near-singular landmarks make an fp32 determinant cancel, so the inverse
//   of an fp32 system is still taken in double.
//
// slot_factors_kernel, for each slot s of HplT [18, H] (Hpl row-major i*3+k)
// and the gathered g12 [12, H] ([Hll^-1 (k*3+m); bl (m)] of the slot's
// landmark):
//   W[i*3+m] = sum_k Hpl[i*3+k] Hinv[k*3+m]   (i < 6, m < 3),
//   wbl[i]   = sum_m W[i*3+m] bl[m],
// each sum from k (m) = 0 by fma, in T; wbl from W as stored.  Padding
// slots (Hpl 0, gathered zeros) come out 0.
//
// Bound by device-memory bytes.  hll_inverse: a landmark reads the 6
// distinct entries of its symmetric Hll and bl (9 values; the 3 mirrored
// rows are never read) and writes 12, 84 bytes in fp32 for ~50 fp64 flops;
// slot_factors: a slot reads 30 values and writes 24, 216 bytes in fp32
// for 120 flops, ~0.6 flop a byte against a ridge of ~20 (both twice the
// bytes in fp64).  So each kernel moves each byte once and keeps
// everything between its inputs and outputs in registers: one thread a
// landmark or a slot, 256 a block, every row loaded and stored by a warp as
// one contiguous 128-byte run (the tables are [D, N], N fastest); nothing
// staged, no shared memory, nothing between W and W bl in device memory.
// Every operation of the inverse is an explicit __d*_rn, so nvcc fuses
// none into an FMA and the result is the plain version's bit for bit; the
// products of slot_factors are FMAs.
//
// Element types: templates on T, built for float (entries cuba_hll_inverse,
// cuba_slot_factors) and double (cuba_hll_inverse_f64,
// cuba_slot_factors_f64: the same parameters with double* for float*).
// Index arithmetic is int32 (the wrapper checks 18 H and 12 L).  The
// kernels allocate nothing; each entry point launches on the caller's
// stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kInt32Max = 0x7fffffff;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// the damped inverse of one landmark's Hll, in double, term for term as
// _sym3x3_inv_rows; the row-major inverse into b[9]
__device__ __forceinline__ void sym3x3_inv(double a00, double a01, double a02, double a11,
                                           double a12, double a22, double (&b)[9]) {
  double det = __dmul_rn(__dmul_rn(a00, a11), a22);
  det = __dadd_rn(det, __dmul_rn(__dmul_rn(a01, a12), a02));
  det = __dadd_rn(det, __dmul_rn(__dmul_rn(a02, a01), a12));
  det = __dsub_rn(det, __dmul_rn(__dmul_rn(a00, a12), a12));
  det = __dsub_rn(det, __dmul_rn(__dmul_rn(a02, a11), a02));
  det = __dsub_rn(det, __dmul_rn(__dmul_rn(a01, a01), a22));
  const double inv_det = __drcp_rn(det);
  const double b00 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a11, a22), __dmul_rn(a12, a12)));
  const double b01 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a02, a12), __dmul_rn(a01, a22)));
  const double b11 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a00, a22), __dmul_rn(a02, a02)));
  const double b02 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a01, a12), __dmul_rn(a02, a11)));
  const double b12 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a02, a01), __dmul_rn(a00, a12)));
  const double b22 = __dmul_rn(inv_det, __dsub_rn(__dmul_rn(a00, a11), __dmul_rn(a01, a01)));
  b[0] = b00; b[1] = b01; b[2] = b02;
  b[3] = b01; b[4] = b11; b[5] = b12;
  b[6] = b02; b[7] = b12; b[8] = b22;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hll_inverse_kernel(const T* __restrict__ hll, const T* __restrict__ lam,
                       T* __restrict__ out, int L) {
  const int l = blockIdx.x * kThreads + threadIdx.x;
  if (l >= L) return;
  const T lm = *lam;
  // the damping in T, as the plain version's hll_d[0::4] += lam
  const double a00 = static_cast<double>(add_rn(hll[l], lm));
  const double a01 = static_cast<double>(hll[L + l]);
  const double a02 = static_cast<double>(hll[2 * L + l]);
  const double a11 = static_cast<double>(add_rn(hll[4 * L + l], lm));
  const double a12 = static_cast<double>(hll[5 * L + l]);
  const double a22 = static_cast<double>(add_rn(hll[8 * L + l], lm));
  const T bl0 = hll[9 * L + l], bl1 = hll[10 * L + l], bl2 = hll[11 * L + l];
  double b[9];
  sym3x3_inv(a00, a01, a02, a11, a12, a22, b);
  out += l;
#pragma unroll
  for (int r = 0; r < 9; ++r) out[r * L] = static_cast<T>(b[r]);
  out[9 * L] = bl0;
  out[10 * L] = bl1;
  out[11 * L] = bl2;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    slot_factors_kernel(const T* __restrict__ hpl, const T* __restrict__ g12,
                        T* __restrict__ w, T* __restrict__ wbl, int H) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= H) return;
  T inv[9], bl[3], p[18];
#pragma unroll
  for (int r = 0; r < 9; ++r) inv[r] = g12[r * H + s];
#pragma unroll
  for (int m = 0; m < 3; ++m) bl[m] = g12[(9 + m) * H + s];
#pragma unroll
  for (int r = 0; r < 18; ++r) p[r] = hpl[r * H + s];
  w += s;
  wbl += s;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T wi[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      T h = p[i * 3] * inv[m];
      h = fma_rn(p[i * 3 + 1], inv[3 + m], h);
      h = fma_rn(p[i * 3 + 2], inv[6 + m], h);
      wi[m] = h;
      w[(i * 3 + m) * H] = h;
    }
    T v = wi[0] * bl[0];
    v = fma_rn(wi[1], bl[1], v);
    v = fma_rn(wi[2], bl[2], v);
    wbl[i * H] = v;
  }
}

template <typename T>
int hll_inverse(const T* hll, const T* lam, T* out, int64_t L, void* stream) {
  if (L < 0 || 12 * L > kInt32Max) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return static_cast<int>(cudaGetLastError());
  const int n = static_cast<int>(L);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  hll_inverse_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hll, lam, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int slot_factors(const T* hpl, const T* g12, T* w, T* wbl, int64_t H, void* stream) {
  if (H < 0 || 18 * H > kInt32Max) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0) return static_cast<int>(cudaGetLastError());
  const int n = static_cast<int>(H);
  const unsigned int blocks = static_cast<unsigned int>((n + kThreads - 1) / kThreads);
  slot_factors_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hpl, g12, w, wbl, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// hll [12, L] (Hll row-major, then bl), lam a 0-d device value; out [12, L]
// ([Hll^-1; bl]); all contiguous, 12 L within int32.
int cuba_hll_inverse(const float* hll, const float* lam, float* out, int64_t L, void* stream) {
  return hll_inverse(hll, lam, out, L, stream);
}

int cuba_hll_inverse_f64(const double* hll, const double* lam, double* out, int64_t L,
                         void* stream) {
  return hll_inverse(hll, lam, out, L, stream);
}

// hpl [18, H] (Hpl row-major i*3+k), g12 [12, H] ([Hll^-1; bl] gathered to
// the slots); w [18, H] (row i*3+m), wbl [6, H]; all contiguous, 18 H
// within int32.
int cuba_slot_factors(const float* hpl, const float* g12, float* w, float* wbl, int64_t H,
                      void* stream) {
  return slot_factors(hpl, g12, w, wbl, H, stream);
}

int cuba_slot_factors_f64(const double* hpl, const double* g12, double* w, double* wbl,
                          int64_t H, void* stream) {
  return slot_factors(hpl, g12, w, wbl, H, stream);
}

}  // extern "C"
