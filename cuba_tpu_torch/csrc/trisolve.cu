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
// Two reduction shapes serve the sweeps, each summing in one fixed order
// (no atomics: every run gives the same bits):
//  * rowdot: out[r] (=, or -=) sum_c M[r, c] v[c]; one warp per row, lane l
//    summing columns l, l+32, ... in order (coalesced 128-byte reads of the
//    row), then a butterfly of shuffles (every lane ends with the same sum).
//    The forward sweep's steps.
//  * coldot: out[c] (=, or -=) sum_a M[a, c] v[a]; a block of 8 warps
//    covers 32 columns, lane on the column (coalesced reads along a row of
//    M), warp w summing rows w, w+8, ... in order; the 8 partial sums are
//    added in warp order through shared memory.  The backward sweep's steps.
//
// The matvec has a kernel of its own (matvec_kernel): one warp per row
// would leave 1,536 warps at n = 1536, too few loads in flight to hide the
// latency, and one dependent FMA chain per lane.  It splits each row into
// S contiguous slices of 4-column quads, one warp per slice (S from n, so
// that small n still fills the card), loads a quad as one float4 where n
// % 4 == 0 and A, x are 16-byte aligned (four scalar loads otherwise, in
// the same order), and keeps kAccs = 4 accumulators per lane with 4 quads'
// loads issued before their FMAs.  trisolve.matvec_walk is its order in
// NumPy.
//
// The diagonal copy (extract_diag_kernel) has no division: blockIdx.y is
// the block k, blockIdx.x a group of rows, and each thread copies kLoads =
// 2 float4 of one column quad, both loads issued before the first store
// (grid [32, K]: 192 blocks at kitti07's K = 6, one or more per SM).
//
// Precision: every product is exact fp32 (FMA).  The TPU kernels ran the
// stripe updates at the MXU's default bf16-pass precision and left the
// error to iterative refinement; the port does not lower precision.
//
// All four are bound by device-memory bytes, one FMA per element of L or A
// read: a sweep reads the lower triangle of L once (n^2/2 * 4 bytes, 4.7 MB
// at n = 1536, 143 MB at n = 8448), the matvec all of A, the copy the K
// diagonal blocks twice (read and write).  At small n the 2K launches of a
// sweep, not the bytes, set its time.
//
// Kernels allocate nothing.  Each entry point launches on the caller's
// stream and returns the first cudaGetLastError() that is not cudaSuccess,
// so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 256;                 // the diagonal blocks' width
constexpr int kQuads = kBlock / 4;          // float4 per row of a block
constexpr int kPass = kThreads / kQuads;    // rows a block copies per load
constexpr int kLoads = 2;                   // float4 a thread of the copy moves
constexpr int kAccs = 4;                    // accumulators a lane of the matvec

// out[k] = L[kB:(k+1)B, kB:(k+1)B] for B = 256, in float4 (n4 = n / 4).
// Block (x, k) copies rows x*kPass*kLoads + t/kQuads + i*kPass, i < kLoads,
// of block k, thread t the column quad t % kQuads; all indices int32 (n*n <
// 2^31).
__global__ void extract_diag_kernel(const float4* __restrict__ L, int n4,
                                    float4* __restrict__ out) {
  const int c = threadIdx.x % kQuads;
  const int r = blockIdx.y * kBlock + blockIdx.x * (kPass * kLoads) + threadIdx.x / kQuads;
  const float4* src = L + r * n4 + blockIdx.y * kQuads + c;
  float4* dst = out + r * kQuads + c;
  float4 v[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) v[i] = __ldg(src + i * kPass * n4);
#pragma unroll
  for (int i = 0; i < kLoads; ++i) dst[i * kPass * kQuads] = v[i];
}

// quad j of a row of n floats: one float4 load (kVec), or up to four scalar
// loads with the columns past n read as 0
template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ p, int j, int n) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(p) + j);
  } else {
    const int c = 4 * j;
    return make_float4(__ldg(p + c), c + 1 < n ? __ldg(p + c + 1) : 0.0f,
                       c + 2 < n ? __ldg(p + c + 2) : 0.0f, c + 3 < n ? __ldg(p + c + 3) : 0.0f);
  }
}

// y[r] = sum_c A[r, c] x[c], A [n, n] row-major; q = ceil(n/4) quads a row,
// w = ceil(q/S) quads a slice.  Warp `warp` of a block takes slice warp % S
// of row blockIdx.x * (kWarps/S) + warp / S.  Lane l of slice s walks quads
// s*w + l + 32t (t = 0, 1, ...) below min(q, (s+1)*w) into accumulator t %
// kAccs, the quad's four terms by fmaf in column order (a partial last quad
// padded with zero terms); the lane's partial is acc[0] + acc[1] + ... in
// index order, the lanes' a xor butterfly (offsets 16 ... 1), the row's the
// S slice partials added in slice order.
template <int S, bool kVec>
__global__ void matvec_kernel(const float* __restrict__ A, const float* __restrict__ x,
                              float* __restrict__ y, int n, int q, int w) {
  constexpr int kRows = kWarps / S;
  __shared__ float part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kRows + warp / S;
  float p = 0.0f;
  if (r < n) {  // r is the same in every lane of a warp
    const float* row = A + r * n;
    const int lo = (warp % S) * w;
    const int hi = min(q, lo + w);
    float acc[kAccs];
#pragma unroll
    for (int u = 0; u < kAccs; ++u) acc[u] = 0.0f;
    for (int j = lo + lane; j < hi; j += 32 * kAccs) {
      float4 a[kAccs], v[kAccs];
#pragma unroll
      for (int u = 0; u < kAccs; ++u) {
        if (j + 32 * u < hi) {
          a[u] = load_quad<kVec>(row, j + 32 * u, n);
          v[u] = load_quad<kVec>(x, j + 32 * u, n);
        }
      }
#pragma unroll
      for (int u = 0; u < kAccs; ++u) {
        if (j + 32 * u < hi) {
          acc[u] = fmaf(a[u].x, v[u].x, acc[u]);
          acc[u] = fmaf(a[u].y, v[u].y, acc[u]);
          acc[u] = fmaf(a[u].z, v[u].z, acc[u]);
          acc[u] = fmaf(a[u].w, v[u].w, acc[u]);
        }
      }
    }
    p = acc[0];
#pragma unroll
    for (int u = 1; u < kAccs; ++u) p += acc[u];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
  if constexpr (S == 1) {
    if (lane == 0 && r < n) y[r] = p;
  } else {
    if (lane == 0) part[warp] = p;
    __syncthreads();
    const int rr = blockIdx.x * kRows + threadIdx.x;
    if (threadIdx.x < kRows && rr < n) {
      float t = part[threadIdx.x * S];
#pragma unroll
      for (int s = 1; s < S; ++s) t += part[threadIdx.x * S + s];
      y[rr] = t;
    }
  }
}

template <int S>
int launch_matvec(const float* A, const float* x, float* y, int n, bool vec,
                  cudaStream_t stream) {
  const int q = (n + 3) / 4;
  const int w = (q + S - 1) / S;
  const unsigned int blocks = static_cast<unsigned int>((n + kWarps / S - 1) / (kWarps / S));
  if (vec) {
    matvec_kernel<S, true><<<blocks, kThreads, 0, stream>>>(A, x, y, n, q, w);
  } else {
    matvec_kernel<S, false><<<blocks, kThreads, 0, stream>>>(A, x, y, n, q, w);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

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

// L [n, n], n a multiple of 256, L and out 16-byte aligned; out [n/256,
// 256, 256].
int cuba_extract_diag_blocks(const float* L, int64_t n, float* out, void* stream) {
  if (n % kBlock != 0 || !aligned16(L) || !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = static_cast<int>(n / kBlock);
  if (K == 0) return static_cast<int>(cudaGetLastError());
  extract_diag_kernel<<<dim3(kBlock / (kPass * kLoads), K), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(L), static_cast<int>(n / 4), reinterpret_cast<float4*>(out));
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

// A [n, n], x [n]; y [n] out; `slices` S of 1, 2, 4 or 8; `vec` the float4
// loads (n % 4 == 0, A and x 16-byte aligned).
int cuba_matvec(const float* A, const float* x, float* y, int64_t n, int slices, int vec,
                void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (vec && (n % 4 != 0 || !aligned16(A) || !aligned16(x))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = static_cast<int>(n);
  switch (slices) {
    case 1: return launch_matvec<1>(A, x, y, m, vec != 0, s);
    case 2: return launch_matvec<2>(A, x, y, m, vec != 0, s);
    case 4: return launch_matvec<4>(A, x, y, m, vec != 0, s);
    case 8: return launch_matvec<8>(A, x, y, m, vec != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
