// Blocked triangular solves and the refinement matvec of the dense reduced
// solve, for Hopper (sm_90a).
//
// These replace the four Pallas kernels of cuba_tpu/solver/trisolve.py:
//
//   extract_diag_blocks <- _extract_diag_blocks (trisolve.py:74)
//                   out[k] = L[kB:(k+1)B, kB:(k+1)B], [K, B, B]
//   solve_lower     <- solve_lower (trisolve.py:120)   y = L^-1 b
//   solve_upper     <- solve_upper (trisolve.py:159)   x = L^-T y
//   matvec          <- matvec (trisolve.py:200)        y = A x
//
// The TPU kernels walk K = n/B stripes (B = 256) as a sequential grid with
// the running update d resident in VMEM; step k of the forward sweep is
// y_k = invd[k] (b_k + d_k), then d -= L[:, stripe k] y_k.  On the GPU the
// grid is not sequential and blocks cannot carry d from one step to the
// next, so each step is two launches on the caller's stream, with d in
// device memory (the stream orders them):
//   1. the diagonal step: y_k = invd[k] (b_k + d_k), a 256x256 product;
//   2. the update: d_r -= L[r, stripe k] . y_k for the rows r >= (k+1)B
//      only.  The TPU kernel also updates the diagonal block's own rows
//      after reading them (harmless in a sequential grid); here those rows
//      are never written after step 1 of their stripe has read them.
// The backward sweep is the same over ROW stripes of L (no transpose is
// formed): x_k = invd[k]^T (y_k + d_k), then d_c -= L[stripe k, c] . x_k
// for the columns c < kB.  2K launches per solve, all from one host call.
//
// Two reduction shapes serve every product, each summing in one fixed
// order (no atomics: every run gives the same bits):
//  * rowdot: out[r] (=, or -=) sum_c M[r, c] v[c]; one warp per row, lane l
//    summing columns l, l+32, ... in order (coalesced 128-byte reads of the
//    row), then a butterfly of shuffles (every lane ends with the same sum).
//    The forward sweep's steps and the matvec.
//  * coldot: out[c] (=, or -=) sum_a M[a, c] v[a]; a block of 8 warps
//    covers 32 columns, lane on the column (coalesced reads along a row of
//    M), warp w summing rows w, w+8, ... in order; the 8 partial sums are
//    added in warp order through shared memory.  The backward sweep's steps.
//
// Precision: every product is exact fp32 (FMA).  The TPU kernels ran the
// stripe updates at the MXU's default bf16-pass precision and left the
// error to iterative refinement; the port does not lower precision.
//
// All four are bound by device-memory bytes, one FMA per element of L or A
// read: a sweep reads the lower triangle of L once (n^2/2 * 4 bytes, 4.7 MB
// at n = 1536, 143 MB at n = 8448), the matvec all of A.  At small n the
// 2K launches of a sweep, not the bytes, set its time.
//
// Kernels allocate nothing.  Each entry point launches on the caller's
// stream and returns the first cudaGetLastError() that is not cudaSuccess,
// so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void extract_diag_kernel(const float* __restrict__ L, int64_t n, int64_t B,
                                    int64_t K, float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= K * B * B) return;
  const int64_t k = idx / (B * B);
  const int64_t rem = idx - k * B * B;
  const int64_t a = rem / B;
  const int64_t b = rem - a * B;
  out[idx] = L[(k * B + a) * n + k * B + b];
}

// out[r] = s or out[r] - s, s = sum_{c < ncols} M[r * ld + c] * (v1[c] + v2[c])
// (v2 may be null); one warp per row.
__global__ void rowdot_kernel(const float* __restrict__ M, int64_t ld, int64_t nrows,
                              int64_t ncols, const float* __restrict__ v1,
                              const float* __restrict__ v2, float* __restrict__ out,
                              int subtract) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (r >= nrows) return;  // r is the same in every lane of a warp
  const float* row = M + r * ld;
  float acc = 0.0f;
  if (v2 != nullptr) {
    for (int64_t c = lane; c < ncols; c += 32) acc = fmaf(row[c], v1[c] + v2[c], acc);
  } else {
    for (int64_t c = lane; c < ncols; c += 32) acc = fmaf(row[c], v1[c], acc);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[r] = subtract ? out[r] - acc : acc;
}

// out[c] = s or out[c] - s, s = sum_{a < nrows} M[a * ld + c] * (v1[a] + v2[a])
// (v2 may be null); a block of kWarps warps per 32 columns.
__global__ void coldot_kernel(const float* __restrict__ M, int64_t ld, int64_t nrows,
                              int64_t ncols, const float* __restrict__ v1,
                              const float* __restrict__ v2, float* __restrict__ out,
                              int subtract) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool valid = c < ncols;
  float acc = 0.0f;
  if (valid) {
    for (int64_t a = warp; a < nrows; a += kWarps) {
      const float va = v2 != nullptr ? v1[a] + v2[a] : v1[a];
      acc = fmaf(M[a * ld + c], va, acc);
    }
  }
  part[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && valid) {
    float s = part[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += part[w][lane];
    out[c] = subtract ? out[c] - s : s;
  }
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

int rowdot(const float* M, int64_t ld, int64_t nrows, int64_t ncols, const float* v1,
           const float* v2, float* out, int subtract, cudaStream_t stream) {
  rowdot_kernel<<<blocks_for(nrows * 32), kThreads, 0, stream>>>(M, ld, nrows, ncols, v1,
                                                                   v2, out, subtract);
  return static_cast<int>(cudaGetLastError());
}

int coldot(const float* M, int64_t ld, int64_t nrows, int64_t ncols, const float* v1,
           const float* v2, float* out, int subtract, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((ncols + 31) / 32);
  coldot_kernel<<<blocks, kThreads, 0, stream>>>(M, ld, nrows, ncols, v1, v2, out,
                                                 subtract);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// L [n, n]; out [n/B, B, B].
int cuba_extract_diag_blocks(const float* L, int64_t n, int64_t B, float* out,
                             void* stream) {
  const int64_t K = n / B;
  if (K > 0) {
    extract_diag_kernel<<<blocks_for(K * B * B), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(L, n, B, K, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// L [n, n] lower triangular, invd [K, B, B] the inverted diagonal blocks,
// b [n]; y [n] out; d [n] the running update, zero on entry.
int cuba_solve_lower(const float* L, const float* invd, const float* b, float* y, float* d,
                     int64_t n, int64_t B, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t K = n / B;
  for (int64_t k = 0; k < K; ++k) {
    const int64_t lo = k * B, hi = lo + B;
    int err = rowdot(invd + k * B * B, B, B, B, b + lo, d + lo, y + lo, 0, s);
    if (err == 0 && hi < n) err = rowdot(L + hi * n + lo, n, n - hi, B, y + lo, nullptr,
                                         d + hi, 1, s);
    if (err != 0) return err;
  }
  return 0;
}

// L, invd as for cuba_solve_lower; y [n]; x [n] out; d [n] zero on entry.
int cuba_solve_upper(const float* L, const float* invd, const float* y, float* x, float* d,
                     int64_t n, int64_t B, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t K = n / B;
  for (int64_t k = K - 1; k >= 0; --k) {
    const int64_t lo = k * B;
    int err = coldot(invd + k * B * B, B, B, B, y + lo, d + lo, x + lo, 0, s);
    if (err == 0 && lo > 0) err = coldot(L + lo * n, n, B, lo, x + lo, nullptr, d, 1, s);
    if (err != 0) return err;
  }
  return 0;
}

// A [n, n], x [n]; y [n] out.
int cuba_matvec(const float* A, const float* x, float* y, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return rowdot(A, n, n, n, x, nullptr, y, 0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
