// Index-driven gathers, segment sums and the v2 Schur formation for Hopper
// (sm_90a).
//
// These six kernels replace the ten one-hot-matmul Pallas kernels of
// cuba_tpu/ops/segmm.py:
//
//   gather_cols  <- resident_gather (segmm.py:1257), windowed_gather
//                   (segmm.py:1215), tiled_gather (segmm.py:487)
//                   out[d, n] = src[d, ids[n]], 0 where ids[n] < 0 or >= S
//   segsum_csr   <- accum_segsum (segmm.py:105), accum_segsum_windowed
//                   (segmm.py:205), tiled_segsum (segmm.py:425)
//                   out[d, s] = sum over ids[n] == s of vals[d, n]
//   schur_fused  <- schur_fused (segmm.py:798)
//                   out[a*6+b, lane] = sum over the lane's triplets t of
//                   sum_m W[3a+m, slot_i(t)] * G[3b+m, slot_j(t)]
//   compact_to_band <- compact_to_band (segmm.py:1093)
//                   tile (k, e) of [M*384, 768] = A[k, k+e] of the damped
//                   Schur complement, diag - (upper + mirrored blocks)
//   compact_to_dense <- compact_to_dense (segmm.py:964)
//                   element (6p+i, 6q+j) of [6PB, 6PB] = the same, dense
//   band_transpose <- band_transpose (segmm.py:903)
//                   out[6p+i, 6q+j] = m4[i*6+j, p, q], 0 on the 64x128-block
//                   tiles that occ marks empty
//
// On the TPU the one-hot matrix exists because XLA's gather/scatter ran at
// 5-10 GB/s while the MXU was idle; the windows and tiles of the Pallas
// kernels only keep that one-hot factor inside VMEM.  On Hopper an indexed
// load is cheap, so both kernels index directly and ignore the TPU plans.
//
// Both kernels do one or two flops per element loaded: they are bound by
// device-memory bytes, not by arithmetic.  Their index arithmetic is int32
// (the wrappers check that every [D, N] and [D, num_out] table fits).
//  * gather_cols: one thread per output column, looping over the D rows:
//    the id is loaded once, and each row's store is coalesced across the
//    warp.  The source reads are gathered, from sources small enough to
//    stay in L2 ([12, poses], [3, landmarks]); the ids the slice feeds are
//    locally sorted (landmark-major edge order), so neighbouring threads
//    mostly hit the same or adjacent source columns.
//  * segsum_csr: one group of G lanes (G = 1, 2, ..., 32, chosen once per
//    CSR by the host from its mean segment length) per output segment, for
//    a chunk of up to 4 rows held in registers (the host picks the chunk:
//    few accumulators keep enough threads resident to hide the walk's
//    latency, which 12 did not); the row chunks run on blockIdx.y, consecutive
//    segments on blockIdx.x, so groups that run together read neighbouring
//    columns of the same rows and share the sectors that one segment's
//    scattered columns waste.  offs[s], offs[s+1] are loaded once per
//    group and chunk; lane k walks the segment's entries start+k,
//    start+k+G, ... of the fixed CSR order the host built once per
//    structure (a stable sort of the valid ids), loading order[j] once for
//    all the chunk's rows; the G partial sums are combined by a fixed
//    __shfl_xor_sync butterfly.  No atomics: the summation order alone
//    fixes the bits, the same on every run (segsum_walk in ops/segmm.py is
//    this order in NumPy).  Long segments (a pose's 100-500 edges) get 32
//    lanes of independent loads, where one serial chain per (row, segment)
//    left the card latency-bound.  Short and empty ones (an Hpl slot's 0-1
//    edges) get G = 1, an empty segment reading only offs and writing its
//    zeros, coalesced across neighbouring segments.  Where nearly all
//    segments are empty and the others long enough to take a wider group
//    (the v1 combines: 2 M blocks, 1 in 100 occupied, ~10 entries each,
//    285 MB of output) the host also lists the occupied ones: the output
//    is zeroed in 16-byte stores, and only the listed segments are summed.
//
//  * schur_fused: one thread per output lane (chunk c, lane l), summing the
//    lane's triplets in the fixed order of a per-lane CSR the host built
//    once per structure (ascending triplet position), with the 36 sums in
//    registers.  No atomics: deterministic.  The TPU kernel builds one-hot
//    matrices because the TPU gathers and scatters slowly; here the W and
//    G columns are read by index.  Bound by those reads (2 x 18 floats per
//    triplet, from a 2*SB-slot window per chunk that stays in L1/L2) and
//    their latency; the 36 stores per lane coalesce across lanes.
//  * compact_to_band: every 6x6 output block has at most one source (an
//    upper block, a mirrored one, and/or the damped diagonal), so this is a
//    placement, not a sum.  One thread per output element reads the host's
//    [PB, 128] slot table (upper slot, or mirror slot with bit 30 set) and
//    writes every element, zeros included, with coalesced stores.  Bound by
//    the writes (M*384*768*4 bytes, 26 MB at M = 22).
//  * compact_to_dense: the same placement over the whole [6PB, 6PB] matrix,
//    from a host [PB, PB] slot table; one thread per element, every element
//    written (zeros included) with coalesced stores, the six threads of one
//    6-wide block row sharing a table entry.  The TPU kernel skipped empty
//    64x128-block tiles to save MXU passes; here an empty tile costs its
//    stores, which any dense output pays.  Bound by the writes: 36*PB^2*4
//    bytes, 9.4 MB at kitti07 scale (PB = 256), 285 MB at PB = 1408.
//  * band_transpose: the v1 formation's lane interleave, a pure copy (no
//    rounding: bit-equal to its plain version).  The TPU kernel spelled it
//    as one-hot MXU products with a bf16x3 split because XLA's transpose ran
//    at ~10 GB/s there; here it is a tile transpose through shared memory.
//    A block takes one pose row p and 32 pose columns q (one occupancy tile
//    holds them all): it loads the 36 planes' 32-float runs m4[ij, p, q0:q0+32]
//    with coalesced 128-byte reads, and each of its 192 threads writes one
//    output column of the six rows 6p..6p+5, so the stores coalesce too.
//    The shared rows are padded to 38 floats, which spreads the six-strided
//    reads over the banks.  A block on an empty tile writes its zeros and
//    reads nothing.  Bound by the bytes: 36*PB^2*4 written plus the occupied
//    tiles' share of m4 read, 285 + up to 285 MB at PB = 1408.  (The first
//    version, one thread per output element reading m4 directly, ran at a
//    third of this bound on the card; PERF.md keeps its time.)
//
// Kernels allocate nothing.  Each entry point launches on the caller's
// stream and returns cudaGetLastError() so the Python wrapper can raise on
// a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int32_t kInt32Max = 0x7fffffff;

__global__ void gather_cols_kernel(const float* __restrict__ src,
                                   const int32_t* __restrict__ ids,
                                   float* __restrict__ out, int D, int S, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int id = ids[n];
  float* dst = out + n;
  if (id >= 0 && id < S) {
    const float* col = src + id;
#pragma unroll 4
    for (int d = 0; d < D; ++d) dst[d * N] = col[d * S];
  } else {
#pragma unroll 4
    for (int d = 0; d < D; ++d) dst[d * N] = 0.0f;
  }
}

// rows (accumulators) per segsum_csr lane, at most: few registers, so many
// threads resident to hide the latency of the walk
constexpr int kRowChunk = 4;

__device__ __forceinline__ void add_column(float (&acc)[kRowChunk], const float* rows,
                                           int col, int N, int nr) {
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    if (r < nr) acc[r] += rows[r * N + col];
  }
}

// Group g of G lanes sums segment live[g] (segment g where live is null)
// for the row chunk blockIdx.y.
template <int G>
__global__ void segsum_csr_kernel(const float* __restrict__ vals,
                                  const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ offs,
                                  const int32_t* __restrict__ live, int count,
                                  float* __restrict__ out, int D, int N, int num_out,
                                  int rows_per_chunk) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t / G;
  const int lane = t & (G - 1);
  const int d0 = blockIdx.y * rows_per_chunk;
  const int nr = min(rows_per_chunk, D - d0);  // uniform across the block
  // a group past the last segment walks nothing but still joins the
  // butterfly: every lane of the warp takes part in each shuffle
  const bool on = g < count;
  int s = 0, j = 0, end = 0;
  if (on) {
    s = live != nullptr ? live[g] : g;
    j = offs[s] + lane;
    end = offs[s + 1];
  }
  const float* rows = vals + d0 * N;
  float acc[kRowChunk];
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) acc[r] = 0.0f;
  if (G == 1) {  // segments of a few entries: unrolling costs more than it hides
#pragma unroll 1
    for (; j < end; ++j) add_column(acc, rows, order[j], N, nr);
  } else {
    // unrolled, the loads of several entries are in flight at once; each
    // accumulator still adds its terms in entry order
#pragma unroll 4
    for (; j < end; j += G) add_column(acc, rows, order[j], N, nr);
  }
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
#pragma unroll
    for (int r = 0; r < kRowChunk; ++r) {
      if (r < nr) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
  }
  // after the butterfly every lane holds the same sums (a + b == b + a);
  // lane r % G stores row r
  if (!on) return;
  float* dst = out + d0 * num_out + s;
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    if (r < nr && (r & (G - 1)) == lane) dst[r * num_out] = acc[r];
  }
}

// out[0:n] = 0 in 16-byte stores (out from the caching allocator: aligned).
__global__ void segsum_zero_kernel(float* __restrict__ out, int n) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i + 4 <= n) {
    *reinterpret_cast<float4*>(out + i) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  } else {
    for (int k = i; k < n; ++k) out[k] = 0.0f;
  }
}

template <int G>
void launch_segsum(const float* vals, const int32_t* order, const int32_t* offs,
                   const int32_t* live, int num_live, float* out, int D, int N, int num_out,
                   int rows, cudaStream_t stream) {
  const int count = live != nullptr ? num_live : num_out;
  if (live != nullptr) {
    const int n = D * num_out;
    segsum_zero_kernel<<<(n / 4 + kThreads) / kThreads, kThreads, 0, stream>>>(out, n);
  }
  if (count == 0) return;
  const dim3 grid(static_cast<unsigned int>((static_cast<int64_t>(count) * G + kThreads - 1) /
                                            kThreads),
                  static_cast<unsigned int>((D + rows - 1) / rows));
  segsum_csr_kernel<G><<<grid, kThreads, 0, stream>>>(vals, order, offs, live, count, out, D,
                                                       N, num_out, rows);
}

__global__ void schur_fused_kernel(const float* __restrict__ W,
                                   const float* __restrict__ G, int64_t S,
                                   const int32_t* __restrict__ sb,
                                   const int32_t* __restrict__ li,
                                   const int32_t* __restrict__ lj,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offs,
                                   int64_t slot_block, int64_t kwin, int64_t lanes,
                                   float* __restrict__ out) {
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t base = static_cast<int64_t>(sb[lane / kwin]) * slot_block;
  float acc[36];
#pragma unroll
  for (int r = 0; r < 36; ++r) acc[r] = 0.0f;
  const int32_t end = offs[lane + 1];
  for (int32_t q = offs[lane]; q < end; ++q) {
    const int32_t t = order[q];
    const int64_t i = base + li[t];
    const int64_t j = base + lj[t];
    if (li[t] < 0 || lj[t] < 0 || i >= S || j >= S) continue;
    float w[18], g[18];
#pragma unroll
    for (int r = 0; r < 18; ++r) {
      w[r] = W[r * S + i];
      g[r] = G[r * S + j];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        acc[a * 6 + b] += w[3 * a] * g[3 * b] + w[3 * a + 1] * g[3 * b + 1] +
                          w[3 * a + 2] * g[3 * b + 2];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 36; ++r) out[r * lanes + lane] = acc[r];
}

constexpr int kBandTile = 64;            // pose blocks per CR block
constexpr int kBandRows = 6 * kBandTile;  // 384 scalars
constexpr int32_t kMirror = 1 << 30;

__global__ void compact_to_band_kernel(const float* __restrict__ gT, int64_t MWg,
                                       const int32_t* __restrict__ table,
                                       const float* __restrict__ dbT, int64_t PB,
                                       const int32_t* __restrict__ occ, int64_t M,
                                       float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t width = 2 * kBandRows;
  if (idx >= M * kBandRows * width) return;
  const int64_t row = idx / width;
  const int col = static_cast<int>(idx - row * width);
  const int64_t k = row / kBandRows;
  const int rl = static_cast<int>(row - k * kBandRows);
  const int pr = rl / 6, i = rl - 6 * (rl / 6);
  const int e = col / kBandRows;
  const int cl = col - e * kBandRows;
  const int lq = e * kBandTile + cl / 6, j = cl - 6 * (cl / 6);
  const int64_t p = k * kBandTile + pr;
  float v = 0.0f;
  if (occ[2 * k + e] > 0) {
    const int32_t ent = table[p * (2 * kBandTile) + lq];
    if (ent >= 0) {
      const int64_t slot = ent & (kMirror - 1);
      const int r = (ent & kMirror) ? j * 6 + i : i * 6 + j;
      v = -gT[r * MWg + slot];
    }
    if (lq == pr) v += dbT[(i * 6 + j) * PB + p];
  }
  out[idx] = v;
}

constexpr int kDenseTileP = 64;   // occupancy tile rows, pose blocks
constexpr int kDenseTileQ = 128;  // occupancy tile cols, pose blocks

__global__ void compact_to_dense_kernel(const float* __restrict__ gT, int64_t MWg,
                                        const int32_t* __restrict__ table,
                                        const float* __restrict__ dbT, int64_t PB,
                                        const int32_t* __restrict__ occ,
                                        float* __restrict__ out) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n = 6 * PB;
  if (idx >= n * n) return;
  const int64_t row = idx / n;
  const int64_t col = idx - row * n;
  const int64_t p = row / 6, q = col / 6;
  const int i = static_cast<int>(row - 6 * p), j = static_cast<int>(col - 6 * q);
  float v = 0.0f;
  if (occ[(p / kDenseTileP) * (PB / kDenseTileQ) + q / kDenseTileQ] > 0) {
    const int32_t ent = table[p * PB + q];
    if (ent >= 0) {
      const int64_t slot = ent & (kMirror - 1);
      const int r = (ent & kMirror) ? j * 6 + i : i * 6 + j;
      v = -gT[r * MWg + slot];
    }
    if (p == q) v += dbT[(i * 6 + j) * PB + p];
  }
  out[idx] = v;
}

constexpr int kTpQ = 32;             // pose columns per band_transpose block
constexpr int kTpCols = 6 * kTpQ;    // its 192 output columns, one per thread
constexpr int kTpStride = kTpQ + 6;  // shared row stride: 38 floats

__global__ void band_transpose_kernel(const float* __restrict__ m4,
                                      const int32_t* __restrict__ occ, int64_t PB,
                                      float* __restrict__ out) {
  __shared__ float tile[36 * kTpStride];
  const int64_t p = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kTpQ;
  const int64_t n = 6 * PB;
  const int t = threadIdx.x;
  float* dst = out + 6 * p * n + 6 * q0 + t;
  // the block's 32 columns share one 64x128-block occupancy tile: the branch
  // is uniform across the block
  if (occ[(p / kDenseTileP) * (PB / kDenseTileQ) + q0 / kDenseTileQ] <= 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dst[i * n] = 0.0f;
    return;
  }
  for (int k = t; k < 36 * kTpQ; k += kTpCols) {
    const int ij = k / kTpQ, qq = k - (k / kTpQ) * kTpQ;
    tile[ij * kTpStride + qq] = m4[(static_cast<int64_t>(ij) * PB + p) * PB + q0 + qq];
  }
  __syncthreads();
  const int qq = t / 6, j = t - 6 * (t / 6);
#pragma unroll
  for (int i = 0; i < 6; ++i) dst[i * n] = tile[(i * 6 + j) * kTpStride + qq];
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// src [D, S], ids [N] int32, out [D, N]; all contiguous fp32/int32, with
// D*S and D*N within int32.
int cuba_gather_cols(const float* src, const int32_t* ids, float* out,
                     int64_t D, int64_t S, int64_t N, void* stream) {
  if (D * S > kInt32Max || D * N > kInt32Max) return static_cast<int>(cudaErrorInvalidValue);
  if (D * N > 0) {
    gather_cols_kernel<<<blocks_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, ids, out, static_cast<int>(D), static_cast<int>(S), static_cast<int>(N));
  }
  return static_cast<int>(cudaGetLastError());
}

// vals [D, N], order [offs[num_out]] int32 (column of vals per CSR entry),
// offs [num_out + 1] int32, out [D, num_out]; group G in {1, 2, 4, 8, 16,
// 32} lanes per segment, rows (1 to 4) rows per chunk; D*N, D*num_out and
// num_out*G within int32.  live (or null) lists the num_live non-empty
// segments: then out is zeroed first and only those are summed.  Neither
// the row chunking nor live changes any output's summation order, only how
// the work is spread.
int cuba_segsum_csr(const float* vals, const int32_t* order, const int32_t* offs,
                    const int32_t* live, int64_t num_live, float* out, int64_t D, int64_t N,
                    int64_t num_out, int64_t group, int64_t rows, void* stream) {
  if (D * N > kInt32Max || D * num_out > kInt32Max || num_out * group > kInt32Max - kThreads ||
      rows < 1 || rows > kRowChunk || (D + rows - 1) / rows > 65535 || num_live > num_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D * num_out > 0) {
    const int d = static_cast<int>(D), n = static_cast<int>(N), m = static_cast<int>(num_out);
    const int r = static_cast<int>(rows), c = static_cast<int>(num_live);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (group) {
      case 1: launch_segsum<1>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 2: launch_segsum<2>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 4: launch_segsum<4>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 8: launch_segsum<8>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 16: launch_segsum<16>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 32: launch_segsum<32>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// W, G [18, S]; sb [C]; li, lj [C*chunk]; order/offs: the per-lane CSR of
// triplet positions (offs [C*kwin + 1]); out [36, C*kwin].
int cuba_schur_fused(const float* W, const float* G, int64_t S, const int32_t* sb,
                     const int32_t* li, const int32_t* lj, const int32_t* order,
                     const int32_t* offs, int64_t slot_block, int64_t kwin, int64_t C,
                     float* out, void* stream) {
  const int64_t lanes = C * kwin;
  if (lanes > 0) {
    schur_fused_kernel<<<blocks_for(lanes), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        W, G, S, sb, li, lj, order, offs, slot_block, kwin, lanes, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// gT [36, MWg]; table [PB, 128]; dbT [36, PB]; occ [2M]; out [M*384, 768].
int cuba_compact_to_band(const float* gT, int64_t MWg, const int32_t* table,
                         const float* dbT, int64_t PB, const int32_t* occ, int64_t M,
                         float* out, void* stream) {
  const int64_t n = M * kBandRows * 2 * kBandRows;
  if (n > 0) {
    compact_to_band_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        gT, MWg, table, dbT, PB, occ, M, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// gT [36, MWg]; table [PB, PB]; dbT [36, PB]; occ [PB/64 * PB/128];
// out [6PB, 6PB].
int cuba_compact_to_dense(const float* gT, int64_t MWg, const int32_t* table,
                          const float* dbT, int64_t PB, const int32_t* occ, float* out,
                          void* stream) {
  const int64_t n = 36 * PB * PB;
  if (n > 0) {
    compact_to_dense_kernel<<<blocks_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        gT, MWg, table, dbT, PB, occ, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// m4 [36, PB, PB]; occ [PB/64 * PB/128]; out [6PB, 6PB]; PB a multiple of 128.
int cuba_band_transpose(const float* m4, const int32_t* occ, int64_t PB, float* out,
                        void* stream) {
  if (PB > 0) {
    const dim3 grid(static_cast<unsigned int>(PB), static_cast<unsigned int>(PB / kTpQ));
    band_transpose_kernel<<<grid, kTpCols, 0, static_cast<cudaStream_t>(stream)>>>(
        m4, occ, PB, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
