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
//    fixes the bits, the same on every run (segsum_walk in ops/walks.py is
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
//  * schur_fused: one block of 256 threads per chunk.  Every read of chunk
//    c falls in the 512-slot windows W[:, sb[c]*SB : +512] and G[...] (the
//    TPU kernel's W0|W1, G0|G1): the block stages both in shared memory,
//    slot-major (a slot's 18 values contiguous, padded to 20 floats, so
//    that a thread reads them as float4), from 16-byte loads, rows
//    fastest across threads; with them three tables the host built once
//    per structure (schur_lane_csr): the chunk's (li, lj) pairs in the order of the
//    per-lane CSR (ascending triplet position), the lanes' offsets into it,
//    and the lane order (each group of 128 lanes longest first, so a warp
//    takes lanes of about one length).  After that no triplet reads device
//    memory.  Every output (lane, a*6+b) is its lane's triplets in CSR
//    order, from 0, each triplet's three products added by three FMAs in m
//    order (schur_fused_walk in ops/walks.py).  Six threads share a lane,
//    one block row a each (six sums).  The sums go through a [36, 132]
//    shared tile and out as float4 rows.  Shared memory (107 KB at kwin
//    256) and 128 registers a thread allow two blocks an SM.  The first
//    design, a thread per lane reading W and G by index from device
//    memory, ran at 4.4x the bound; row-major windows (six 4-byte shared
//    loads per three FMAs), pairs read through order, li and lj (three
//    dependent loads), a thread a lane (36 sums), 2 or 3 block rows a
//    thread, 512 threads a block (64 registers), two threads a 32-byte
//    sector in the staging (16 bytes spilled), and persistent blocks that
//    load the next chunk's windows into registers during the sums (208
//    bytes spilled) were each no faster (tools/probe_schur.py; PERF.md).  Bound by the bytes: the columns of
//    W and G the triplets read, the pair table, lane offsets and lane
//    order, and the [36, C*kwin] output; the windows of neighbouring
//    chunks overlap, and the L2 serves the overlap.
//  * compact_to_band: every 6x6 output block has at most one source (an
//    upper block, a mirrored one, and/or the damped diagonal), so this is a
//    placement, not a sum.  One block per (pose row p, tile column e) writes
//    that row's six output rows of the tile, zeros included, as float4
//    stores: it reads occ once (an unoccupied tile stores only zeros), its
//    64 entries of the host's [PB, 128] slot table (upper slot, or mirror
//    slot with bit 30 set) once, and places the blocks into a [6, 384]
//    shared strip with threads over (i*6 + j, q), q fastest, so that the
//    reads of a row's consecutive upper slots coalesce.  int32 index
//    arithmetic, no division by a runtime value.  (The first design, a
//    thread per element with four 64-bit divisions, its own table and occ
//    loads and 4-byte stores, moved 0.86 TB/s.)  Bound by the writes
//    (M*384*768*4 bytes, 26 MB at M = 22).
//  * compact_to_dense: the same placement over the whole [6PB, 6PB] matrix,
//    from a host [PB, PB] slot table, by the same two helpers
//    (place_blocks, store_strip): one block per (pose row p, column tile e
//    of 128 pose blocks, the occupancy tile's width), grid [PB, PB/128].
//    It reads occ once (an empty 64x128-block tile stores only its zeros:
//    the TPU kernel skipped such tiles to save MXU passes, here any dense
//    output pays their stores), table[p, 128e : 128e+128] once, fills a
//    [6, 768] shared strip and stores float4 rows.  (The first design, a
//    thread per element with four 64-bit divisions, its own table and occ
//    loads and 4-byte stores, ran at a quarter of its bound; PERF.md keeps
//    its time.)  Bound by the writes: 36*PB^2*4 bytes, 9.4 MB at kitti07
//    scale (PB = 256), 285 MB at PB = 1408.
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

// ---- schur_fused: one block per chunk, its windows staged in shared memory

constexpr int kScWin = 512;     // 2 * slot_block: the slots a chunk reads from W and G
constexpr int kScSlot = 20;     // floats of a staged slot: its 18 values, padded to 5 float4
constexpr int kScThreads = 256;
constexpr int kScLoads = 36 * (kScWin / 4) / kScThreads;  // float4 of the windows a thread
constexpr int kScPass = 128;    // lanes of one pass (a group of the lane order; kwin % 128 == 0)
constexpr int kScTileStride = kScPass + 4;

// Dynamic shared memory of one block: the W and G windows slot-major
// [2][512][kScSlot], the chunk's (li, lj) pairs in CSR order [chunk], its
// lane offsets [kwin + 1] and lane order [kwin] (padded to 4 ints), and the
// output tile [36][kScTileStride] (segmm.schur_fused_launch computes the
// same bytes).
size_t schur_smem_bytes(int64_t chunk, int64_t kwin) {
  const int64_t ints = (chunk + 2 * kwin + 1 + 3) / 4 * 4;
  return static_cast<size_t>(4 * (2 * kScWin * kScSlot + ints + 36 * kScTileStride));
}

// Block c stages W[:, base : base + 512] and G[:, ...] (base = sb[c] *
// slot_block) slot-major from 16-byte loads, window rows fastest across
// the block's threads (a warp's 32 loads are 16 bytes of 32 rows; the
// other half of each 32-byte sector is the load 36 threads on), and the
// chunk's pairs (pairs[q] = li | lj << 16 of CSR entry q, -1 for a dropped
// triplet), its lane offsets relative to its first CSR entry, and its lane
// order.  Then, a pass for each group of 128 lanes: six threads share a
// lane, each summing the six outputs (a, b) of its block row a over the
// lane's triplets in CSR order, from 0; the sums go through the shared
// tile so that the stores to out are float4 rows.
__global__ void __launch_bounds__(kScThreads, 2)
schur_fused_kernel(const float* __restrict__ W, const float* __restrict__ G, int64_t S,
                   const int32_t* __restrict__ sb, const int32_t* __restrict__ pairs,
                   const int32_t* __restrict__ offs, const int32_t* __restrict__ lane_order,
                   int slot_block, int chunk, int kwin, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* wwin = smem;                     // [512][kScSlot]
  float* gwin = smem + kScWin * kScSlot;  // [512][kScSlot]
  int32_t* pair = reinterpret_cast<int32_t*>(smem + 2 * kScWin * kScSlot);
  int32_t* loff = pair + chunk;
  int32_t* lord = loff + kwin + 1;
  float* tile = smem + 2 * kScWin * kScSlot + (chunk + 2 * kwin + 1 + 3) / 4 * 4;
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t lanes = static_cast<int64_t>(gridDim.x) * kwin;
  const int64_t base = static_cast<int64_t>(sb[c]) * slot_block;
  // every load of the prologue is issued before any store to shared memory
  float4 buf[kScLoads];
#pragma unroll
  for (int u = 0; u < kScLoads; ++u) {
    const int v = t + u * kScThreads, r = v % 36, q4 = v / 36;
    const float* src = (r < 18 ? W + r * S : G + (r - 18) * S) + base + 4 * q4;
    buf[u] = __ldg(reinterpret_cast<const float4*>(src));
  }
  const int64_t lane0 = static_cast<int64_t>(c) * kwin;
  const int q0 = offs[lane0];
  const int n = offs[lane0 + kwin] - q0;  // at most chunk: the chunk's own triplets
  for (int k = t; k < n; k += kScThreads) pair[k] = pairs[q0 + k];
  for (int l = t; l <= kwin; l += kScThreads) loff[l] = offs[lane0 + l] - q0;
  for (int l = t; l < kwin; l += kScThreads) lord[l] = lane_order[lane0 + l];
#pragma unroll
  for (int u = 0; u < kScLoads; ++u) {
    const int v = t + u * kScThreads, r = v % 36, q4 = v / 36;
    float* dst = (r < 18 ? wwin + r : gwin + (r - 18)) + 4 * q4 * kScSlot;
    dst[0] = buf[u].x;
    dst[kScSlot] = buf[u].y;
    dst[2 * kScSlot] = buf[u].z;
    dst[3 * kScSlot] = buf[u].w;
  }
  __syncthreads();

  for (int p0 = 0; p0 < kwin; p0 += kScPass) {
    __syncthreads();  // the previous pass's tile is stored
    for (int item = t; item < 6 * kScPass; item += kScThreads) {
      const int k = item / 6, a = item - 6 * k;
      const int l = lord[p0 + k];  // a lane of this pass's 128
      float s[6];
#pragma unroll
      for (int b = 0; b < 6; ++b) s[b] = 0.0f;
      const int end = loff[l + 1];
#pragma unroll 2
      for (int q = loff[l]; q < end; ++q) {
        const int pr = pair[q];
        if (pr >= 0) {
          const float* w = wwin + (pr & 0xffff) * kScSlot + 3 * a;
          const float4* g4 = reinterpret_cast<const float4*>(gwin + (pr >> 16) * kScSlot);
          const float w0 = w[0], w1 = w[1], w2 = w[2];
          float g[kScSlot];
#pragma unroll
          for (int j = 0; j < kScSlot / 4; ++j) {
            const float4 f = g4[j];
            g[4 * j] = f.x;
            g[4 * j + 1] = f.y;
            g[4 * j + 2] = f.z;
            g[4 * j + 3] = f.w;
          }
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            float x = __fmaf_rn(w0, g[3 * b], s[b]);
            x = __fmaf_rn(w1, g[3 * b + 1], x);
            s[b] = __fmaf_rn(w2, g[3 * b + 2], x);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) tile[(a * 6 + b) * kScTileStride + l - p0] = s[b];
    }
    __syncthreads();
    for (int v = t; v < 36 * (kScPass / 4); v += kScThreads) {
      const int r = v / (kScPass / 4), c4 = v - r * (kScPass / 4);
      *reinterpret_cast<float4*>(out + r * lanes + lane0 + p0 + 4 * c4) =
          *reinterpret_cast<const float4*>(tile + r * kScTileStride + 4 * c4);
    }
  }
}

// ---- compact_to_band and compact_to_dense: one block per (pose row, tile column)

constexpr int32_t kMirror = 1 << 30;
constexpr int kCbThreads = 192;  // threads a block of either placement
constexpr int kBandTile = 64;    // pose blocks per CR block
constexpr int kBandRows = 6 * kBandTile;  // 384 scalars
constexpr int kDenseTileP = 64;   // occupancy tile rows, pose blocks
constexpr int kDenseTileQ = 128;  // occupancy tile cols, pose blocks: a dense block's columns

// Pose row p's Q blocks of one tile column into a [6, 6Q] shared strip:
// threads over (r = i*6 + j, q), q fastest, place -gT[r or its transpose,
// slot] from the row's table entries ent[q] (slot, bit 30 for a mirror; <
// 0 none), plus the damped diagonal dbT[r, p] where q == diag_q.
template <int Q>
__device__ __forceinline__ void place_blocks(const float* __restrict__ gT, int MWg,
                                             const int32_t* ent, const float* __restrict__ dbT,
                                             int PB, int p, int diag_q, float* strip) {
  for (int v = threadIdx.x; v < 36 * Q; v += kCbThreads) {
    const int r = v / Q, q = v - r * Q;
    const int i = r / 6, j = r - 6 * i;
    const int en = ent[q];
    float val = 0.0f;
    if (en >= 0) val = -gT[((en & kMirror) ? j * 6 + i : r) * MWg + (en & (kMirror - 1))];
    if (q == diag_q) val += dbT[r * PB + p];
    strip[i * 6 * Q + 6 * q + j] = val;
  }
}

// The strip's six rows of 6Q floats (zeros where strip is null) to dst,
// row i at dst + i * stride4, as float4.
template <int Q>
__device__ __forceinline__ void store_strip(float4* dst, int stride4, const float4* strip) {
  constexpr int kRowQuads = 6 * Q / 4;
  for (int v = threadIdx.x; v < 6 * kRowQuads; v += kCbThreads) {
    const int i = v / kRowQuads;
    dst[i * stride4 + v - i * kRowQuads] =
        strip != nullptr ? strip[v] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Block (p, e) writes rows 6p .. 6p+5 of band tile column e (384 floats
// each): zeros where tile (p / 64, e) is unoccupied; else its 64 table
// entries are read once and placed (place_blocks) into a [6, 384] strip,
// the diagonal where e == 0 and q == p % 64, and the strip goes out as
// float4 rows.
__global__ void __launch_bounds__(kCbThreads)
compact_to_band_kernel(const float* __restrict__ gT, int MWg, const int32_t* __restrict__ table,
                       const float* __restrict__ dbT, int PB, const int32_t* __restrict__ occ,
                       float* __restrict__ out) {
  __shared__ __align__(16) float strip[6 * kBandRows];
  __shared__ int32_t ent[kBandTile];
  const int p = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int k = p / kBandTile, pr = p - k * kBandTile;
  float4* dst = reinterpret_cast<float4*>(out + (k * kBandRows + 6 * pr) * (2 * kBandRows) +
                                          e * kBandRows);
  // the occupancy and the table row are loaded together (one latency)
  const int en_t = t < kBandTile ? table[p * (2 * kBandTile) + e * kBandTile + t] : -1;
  if (occ[2 * k + e] <= 0) {  // uniform across the block
    store_strip<kBandTile>(dst, 2 * kBandRows / 4, nullptr);
    return;
  }
  if (t < kBandTile) ent[t] = en_t;
  __syncthreads();
  place_blocks<kBandTile>(gT, MWg, ent, dbT, PB, p, e == 0 ? pr : -1, strip);
  __syncthreads();
  store_strip<kBandTile>(dst, 2 * kBandRows / 4, reinterpret_cast<const float4*>(strip));
}

// Block (p, e) writes rows 6p .. 6p+5 of dense columns 768e .. 768e+767
// (pose blocks 128e .. 128e+127): zeros where the 64x128-block tile (p /
// 64, e) is unoccupied; else table[p, 128e : 128e+128] is read once and
// placed into a [6, 768] strip, the diagonal where 128e + q == p, and the
// strip goes out as float4 rows.  gridDim.y = PB / 128.
__global__ void __launch_bounds__(kCbThreads)
compact_to_dense_kernel(const float* __restrict__ gT, int MWg, const int32_t* __restrict__ table,
                        const float* __restrict__ dbT, int PB, const int32_t* __restrict__ occ,
                        float* __restrict__ out) {
  __shared__ __align__(16) float strip[6 * 6 * kDenseTileQ];
  __shared__ int32_t ent[kDenseTileQ];
  const int p = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int n = 6 * PB;
  float4* dst = reinterpret_cast<float4*>(out + 6 * p * n + e * (6 * kDenseTileQ));
  const int en_t = t < kDenseTileQ ? table[p * PB + e * kDenseTileQ + t] : -1;
  if (occ[(p / kDenseTileP) * static_cast<int>(gridDim.y) + e] <= 0) {  // uniform
    store_strip<kDenseTileQ>(dst, n / 4, nullptr);
    return;
  }
  if (t < kDenseTileQ) ent[t] = en_t;
  __syncthreads();
  place_blocks<kDenseTileQ>(gT, MWg, ent, dbT, PB, p, p - e * kDenseTileQ, strip);
  __syncthreads();
  store_strip<kDenseTileQ>(dst, n / 4, reinterpret_cast<const float4*>(strip));
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

// W, G [18, S], 16-byte aligned, S % 4 == 0, S >= (max sb + 2) * slot_block;
// sb [C]; pairs/offs: the per-lane CSR (offs [C*kwin + 1]) with pairs[q] =
// li | lj << 16 of entry q's triplet, -1 where it is dropped; lane_order
// [C*kwin]: a permutation of each chunk's lanes within groups of 128; out
// [36, C*kwin], 16-byte aligned.  slot_block 256 (a 512-slot window), chunk
// the plan's (at least the entries of a chunk's lanes), kwin a multiple of
// 128.
int cuba_schur_fused(const float* W, const float* G, int64_t S, const int32_t* sb,
                     const int32_t* pairs, const int32_t* offs, const int32_t* lane_order,
                     int64_t slot_block, int64_t chunk, int64_t kwin, int64_t C, float* out,
                     void* stream) {
  const size_t smem = schur_smem_bytes(chunk, kwin);
  if (2 * slot_block != kScWin || kwin % kScPass != 0 || chunk <= 0 || C > kInt32Max ||
      smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(schur_fused_kernel);
  if (C * kwin == 0) return static_cast<int>(cudaGetLastError());
  // above 48 KB only after this opt-in; cheap, and idempotent
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sbk = static_cast<int>(slot_block), ck = static_cast<int>(chunk),
      kw = static_cast<int>(kwin);
  void* args[] = {&W, &G, &S, &sb, &pairs, &offs, &lane_order, &sbk, &ck, &kw, &out};
  err = cudaLaunchKernel(fn, dim3(static_cast<unsigned int>(C)), dim3(kScThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// gT [36, MWg]; table [PB, 128]; dbT [36, PB]; occ [2M]; out [M*384, 768],
// 16-byte aligned; PB = 64 M; M*384*768 and 36*MWg within int32.
int cuba_compact_to_band(const float* gT, int64_t MWg, const int32_t* table,
                         const float* dbT, int64_t PB, const int32_t* occ, int64_t M,
                         float* out, void* stream) {
  if (PB != M * kBandTile || M * kBandRows * 2 * kBandRows > kInt32Max ||
      36 * MWg > kInt32Max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    compact_to_band_kernel<<<dim3(static_cast<unsigned int>(PB), 2), kCbThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        gT, static_cast<int>(MWg), table, dbT, static_cast<int>(PB), occ, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// gT [36, MWg]; table [PB, PB]; dbT [36, PB]; occ [PB/64 * PB/128];
// out [6PB, 6PB], 16-byte aligned; PB a multiple of 128; 36*PB^2 and
// 36*MWg within int32.
int cuba_compact_to_dense(const float* gT, int64_t MWg, const int32_t* table,
                          const float* dbT, int64_t PB, const int32_t* occ, float* out,
                          void* stream) {
  if (PB % kDenseTileQ != 0 || 36 * PB * PB > kInt32Max || 36 * MWg > kInt32Max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (PB > 0) {
    const dim3 grid(static_cast<unsigned int>(PB), static_cast<unsigned int>(PB / kDenseTileQ));
    compact_to_dense_kernel<<<grid, kCbThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        gT, static_cast<int>(MWg), table, dbT, static_cast<int>(PB), occ, out);
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

// What the build made of a kernel: out = {registers a thread, local
// (spilled) bytes a thread, static shared bytes, blocks an SM can hold at
// `smem` dynamic shared bytes}.  which: 0 compact_to_band, 1 schur_fused,
// 2 compact_to_dense.
int cuba_segmm_attributes(int64_t which, int64_t smem, int64_t* out) {
  const void* fns[] = {reinterpret_cast<const void*>(compact_to_band_kernel),
                       reinterpret_cast<const void*>(schur_fused_kernel),
                       reinterpret_cast<const void*>(compact_to_dense_kernel)};
  if (which < 0 || which > 2) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = fns[which];
  const int threads = which == 1 ? kScThreads : kCbThreads;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                        static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int64_t>(attr.localSizeBytes);
  out[2] = static_cast<int64_t>(attr.sharedSizeBytes);
  out[3] = blocks;
  return 0;
}

}  // extern "C"
