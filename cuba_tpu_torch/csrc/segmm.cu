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
// Element types.  Every kernel is a template on its element type T, built
// for float (entry cuba_<name>) and double (cuba_<name>_f64, the same
// parameters with double* for float*): the fp64 builds serve cuba_tpu's
// parity mode on the card.  Both builds keep one contract: the transposed
// [D, N] layouts, ids below 0 or out of range dropped from sums and read as
// 0 by gathers, deterministic sums in one order (__fmaf_rn in fp32 is
// __fma_rn in fp64), no atomics; the fp32 builds are the fp32 kernels as
// they were, launch for launch and bit for bit.  A 16-byte access holds 4
// floats or 2 doubles (Vec16), so the fp64 builds store double2 where the
// fp32 ones store float4, and every index stays in elements (int32, as
// the wrappers check).  What the fp64 builds take (ptxas for sm_90a, and
// cudaOccupancy at the kitti00 launches): schur_fused 18-double slots (144
// bytes, nine double2, no padding), its window loads in two batches of 18
// double2 a thread so that the staging holds as many registers as fp32's
// one batch of 18 float4, 128 registers, no spills, 191,632 bytes of
// shared memory at kwin 256 and 197,776 at kwin 1024 (of 232,448), so one
// block an SM (__launch_bounds__ minimum 1, where fp32 has 2);
// compact_to_band 18,688 and compact_to_dense 37,376 static shared bytes
// (the strip in doubles), 31-32 registers; band_transpose 10,944 shared
// bytes, 32 registers; gather_cols and segsum_csr 31-32 registers, no
// shared memory.  None spills.
//
// Kernels allocate nothing.  Each entry point launches on the caller's
// stream and returns cudaGetLastError() so the Python wrapper can raise on
// a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

constexpr int32_t kInt32Max = 0x7fffffff;

// 16 bytes of T, loaded and stored as one access: four floats (float4) or
// two doubles (double2).
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ type zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ type zero() { return make_double2(0.0, 0.0); }
};

// the values of a 16-byte access to v[0], v[stride], v[2 * stride], ...
__device__ __forceinline__ void scatter16(float* v, int stride, const float4& f) {
  v[0] = f.x;
  v[stride] = f.y;
  v[2 * stride] = f.z;
  v[3 * stride] = f.w;
}
__device__ __forceinline__ void scatter16(double* v, int stride, const double2& f) {
  v[0] = f.x;
  v[stride] = f.y;
}

// a * b + c rounded once
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

template <typename T>
__global__ void gather_cols_kernel(const T* __restrict__ src, const int32_t* __restrict__ ids,
                                   T* __restrict__ out, int D, int S, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int id = ids[n];
  T* dst = out + n;
  if (id >= 0 && id < S) {
    const T* col = src + id;
#pragma unroll 4
    for (int d = 0; d < D; ++d) dst[d * N] = col[d * S];
  } else {
#pragma unroll 4
    for (int d = 0; d < D; ++d) dst[d * N] = T(0);
  }
}

// rows (accumulators) per segsum_csr lane, at most: few registers, so many
// threads resident to hide the latency of the walk
constexpr int kRowChunk = 4;

template <typename T>
__device__ __forceinline__ void add_column(T (&acc)[kRowChunk], const T* rows, int col, int N,
                                           int nr) {
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    if (r < nr) acc[r] += rows[r * N + col];
  }
}

// Group g of G lanes sums segment live[g] (segment g where live is null)
// for the row chunk blockIdx.y.
template <int G, typename T>
__global__ void segsum_csr_kernel(const T* __restrict__ vals, const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ offs,
                                  const int32_t* __restrict__ live, int count,
                                  T* __restrict__ out, int D, int N, int num_out,
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
  const T* rows = vals + d0 * N;
  T acc[kRowChunk];
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) acc[r] = T(0);
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
  T* dst = out + d0 * num_out + s;
#pragma unroll
  for (int r = 0; r < kRowChunk; ++r) {
    if (r < nr && (r & (G - 1)) == lane) dst[r * num_out] = acc[r];
  }
}

// out[0:n] = 0 in 16-byte stores (out from the caching allocator: aligned).
template <typename T>
__global__ void segsum_zero_kernel(T* __restrict__ out, int n) {
  constexpr int kVec = Vec16<T>::n;
  const int i = kVec * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i + kVec <= n) {
    *reinterpret_cast<typename Vec16<T>::type*>(out + i) = Vec16<T>::zero();
  } else {
    for (int k = i; k < n; ++k) out[k] = T(0);
  }
}

template <int G, typename T>
void launch_segsum(const T* vals, const int32_t* order, const int32_t* offs,
                   const int32_t* live, int num_live, T* out, int D, int N, int num_out,
                   int rows, cudaStream_t stream) {
  const int count = live != nullptr ? num_live : num_out;
  if (live != nullptr) {
    const int n = D * num_out;
    segsum_zero_kernel<T>
        <<<(n / Vec16<T>::n + kThreads) / kThreads, kThreads, 0, stream>>>(out, n);
  }
  if (count == 0) return;
  const dim3 grid(static_cast<unsigned int>((static_cast<int64_t>(count) * G + kThreads - 1) /
                                            kThreads),
                  static_cast<unsigned int>((D + rows - 1) / rows));
  segsum_csr_kernel<G, T><<<grid, kThreads, 0, stream>>>(vals, order, offs, live, count, out,
                                                          D, N, num_out, rows);
}

// ---- schur_fused: one block per chunk, its windows staged in shared memory

constexpr int kScWin = 512;     // 2 * slot_block: the slots a chunk reads from W and G
constexpr int kScThreads = 256;
constexpr int kScLoads = 18;    // 16-byte window loads a thread has in flight (one batch)
constexpr int kScPass = 128;    // lanes of one pass (a group of the lane order; kwin % 128 == 0)
constexpr int kScTileStride = kScPass + 4;

// Per element type: the values of a staged slot (its 18, padded to whole
// 16-byte loads) and the blocks an SM is built for.  fp32: 20 floats (five
// float4), 107 KB of shared memory at kwin 256, two blocks.  fp64: 18
// doubles are nine double2, no padding; ~198 KB at kwin 1024, one block.
template <typename T>
struct ScTraits;
template <>
struct ScTraits<float> {
  static constexpr int kSlot = 20;
  static constexpr int kBlocks = 2;
};
template <>
struct ScTraits<double> {
  static constexpr int kSlot = 18;
  static constexpr int kBlocks = 1;
};

// Dynamic shared memory of one block: the W and G windows slot-major
// [2][512][kSlot], the chunk's (li, lj) pairs in CSR order [chunk], its
// lane offsets [kwin + 1] and lane order [kwin] (padded to 4 ints), and the
// output tile [36][kScTileStride] (segmm.schur_fused_launch computes the
// same bytes).
template <typename T>
size_t schur_smem_bytes(int64_t chunk, int64_t kwin) {
  const int64_t ints = (chunk + 2 * kwin + 1 + 3) / 4 * 4;
  return static_cast<size_t>(sizeof(T) * (2 * kScWin * ScTraits<T>::kSlot + 36 * kScTileStride) +
                             4 * ints);
}

// Block c stages W[:, base : base + 512] and G[:, ...] (base = sb[c] *
// slot_block) slot-major from 16-byte loads, window rows fastest across
// the block's threads (a warp's 32 loads are 16 bytes of 32 rows; the
// other half of each 32-byte sector is the load 36 threads on), in
// batches of kScLoads loads a thread (one batch in fp32, two in fp64, so
// that the staging holds the same registers), and the chunk's pairs
// (pairs[q] = li | lj << 16 of CSR entry q, -1 for a dropped triplet), its
// lane offsets relative to its first CSR entry, and its lane order.  Then,
// a pass for each group of 128 lanes: six threads share a lane, each
// summing the six outputs (a, b) of its block row a over the lane's
// triplets in CSR order, from 0; the sums go through the shared tile so
// that the stores to out are 16-byte rows.
template <typename T>
__global__ void __launch_bounds__(kScThreads, ScTraits<T>::kBlocks)
schur_fused_kernel(const T* __restrict__ W, const T* __restrict__ G, int64_t S,
                   const int32_t* __restrict__ sb, const int32_t* __restrict__ pairs,
                   const int32_t* __restrict__ offs, const int32_t* __restrict__ lane_order,
                   int slot_block, int chunk, int kwin, T* __restrict__ out) {
  using V = typename Vec16<T>::type;
  constexpr int kVec = Vec16<T>::n;
  constexpr int kSlot = ScTraits<T>::kSlot;
  constexpr int kBatches = 36 * (kScWin / kVec) / (kScLoads * kScThreads);
  static_assert(kBatches * kScLoads * kScThreads == 36 * (kScWin / kVec),
                "the window loads split into whole batches");
  extern __shared__ __align__(16) float4 smem4[];
  T* wwin = reinterpret_cast<T*>(smem4);  // [512][kSlot]
  T* gwin = wwin + kScWin * kSlot;        // [512][kSlot]
  int32_t* pair = reinterpret_cast<int32_t*>(wwin + 2 * kScWin * kSlot);
  int32_t* loff = pair + chunk;
  int32_t* lord = loff + kwin + 1;
  T* tile = reinterpret_cast<T*>(pair + (chunk + 2 * kwin + 1 + 3) / 4 * 4);
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int64_t lanes = static_cast<int64_t>(gridDim.x) * kwin;
  const int64_t base = static_cast<int64_t>(sb[c]) * slot_block;
  const int64_t lane0 = static_cast<int64_t>(c) * kwin;
#pragma unroll
  for (int h = 0; h < kBatches; ++h) {
    // every load of a batch is issued before any of its stores to shared memory
    V buf[kScLoads];
#pragma unroll
    for (int u = 0; u < kScLoads; ++u) {
      const int v = t + (h * kScLoads + u) * kScThreads, r = v % 36, qv = v / 36;
      const T* src = (r < 18 ? W + r * S : G + (r - 18) * S) + base + kVec * qv;
      buf[u] = __ldg(reinterpret_cast<const V*>(src));
    }
    if (h == 0) {
      const int q0 = offs[lane0];
      const int n = offs[lane0 + kwin] - q0;  // at most chunk: the chunk's own triplets
      for (int k = t; k < n; k += kScThreads) pair[k] = pairs[q0 + k];
      for (int l = t; l <= kwin; l += kScThreads) loff[l] = offs[lane0 + l] - q0;
      for (int l = t; l < kwin; l += kScThreads) lord[l] = lane_order[lane0 + l];
    }
#pragma unroll
    for (int u = 0; u < kScLoads; ++u) {
      const int v = t + (h * kScLoads + u) * kScThreads, r = v % 36, qv = v / 36;
      scatter16((r < 18 ? wwin + r : gwin + (r - 18)) + kVec * qv * kSlot, kSlot, buf[u]);
    }
  }
  __syncthreads();

  for (int p0 = 0; p0 < kwin; p0 += kScPass) {
    __syncthreads();  // the previous pass's tile is stored
    for (int item = t; item < 6 * kScPass; item += kScThreads) {
      const int k = item / 6, a = item - 6 * k;
      const int l = lord[p0 + k];  // a lane of this pass's 128
      T s[6];
#pragma unroll
      for (int b = 0; b < 6; ++b) s[b] = T(0);
      const int end = loff[l + 1];
#pragma unroll 2
      for (int q = loff[l]; q < end; ++q) {
        const int pr = pair[q];
        if (pr >= 0) {
          const T* w = wwin + (pr & 0xffff) * kSlot + 3 * a;
          const V* gv = reinterpret_cast<const V*>(gwin + (pr >> 16) * kSlot);
          const T w0 = w[0], w1 = w[1], w2 = w[2];
          T g[kSlot];
#pragma unroll
          for (int j = 0; j < kSlot / kVec; ++j) scatter16(g + kVec * j, 1, gv[j]);
#pragma unroll
          for (int b = 0; b < 6; ++b) {
            T x = fma_rn(w0, g[3 * b], s[b]);
            x = fma_rn(w1, g[3 * b + 1], x);
            s[b] = fma_rn(w2, g[3 * b + 2], x);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < 6; ++b) tile[(a * 6 + b) * kScTileStride + l - p0] = s[b];
    }
    __syncthreads();
    for (int v = t; v < 36 * (kScPass / kVec); v += kScThreads) {
      const int r = v / (kScPass / kVec), cv = v - r * (kScPass / kVec);
      *reinterpret_cast<V*>(out + r * lanes + lane0 + p0 + kVec * cv) =
          *reinterpret_cast<const V*>(tile + r * kScTileStride + kVec * cv);
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
template <int Q, typename T>
__device__ __forceinline__ void place_blocks(const T* __restrict__ gT, int MWg, const int32_t* ent,
                                             const T* __restrict__ dbT, int PB, int p, int diag_q,
                                             T* strip) {
  for (int v = threadIdx.x; v < 36 * Q; v += kCbThreads) {
    const int r = v / Q, q = v - r * Q;
    const int i = r / 6, j = r - 6 * i;
    const int en = ent[q];
    T val = T(0);
    if (en >= 0) val = -gT[((en & kMirror) ? j * 6 + i : r) * MWg + (en & (kMirror - 1))];
    if (q == diag_q) val += dbT[r * PB + p];
    strip[i * 6 * Q + 6 * q + j] = val;
  }
}

// The strip's six rows of 6Q values (zeros where strip is null) to dst,
// row i at dst + i * stride, in 16-byte stores (stride in those).
template <int Q, typename T>
__device__ __forceinline__ void store_strip(typename Vec16<T>::type* dst, int stride,
                                            const typename Vec16<T>::type* strip) {
  constexpr int kRowVecs = 6 * Q / Vec16<T>::n;
  for (int v = threadIdx.x; v < 6 * kRowVecs; v += kCbThreads) {
    const int i = v / kRowVecs;
    dst[i * stride + v - i * kRowVecs] = strip != nullptr ? strip[v] : Vec16<T>::zero();
  }
}

// Block (p, e) writes rows 6p .. 6p+5 of band tile column e (384 values
// each): zeros where tile (p / 64, e) is unoccupied; else its 64 table
// entries are read once and placed (place_blocks) into a [6, 384] strip,
// the diagonal where e == 0 and q == p % 64, and the strip goes out in
// 16-byte rows.
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
compact_to_band_kernel(const T* __restrict__ gT, int MWg, const int32_t* __restrict__ table,
                       const T* __restrict__ dbT, int PB, const int32_t* __restrict__ occ,
                       T* __restrict__ out) {
  using V = typename Vec16<T>::type;
  __shared__ __align__(16) T strip[6 * kBandRows];
  __shared__ int32_t ent[kBandTile];
  const int p = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int k = p / kBandTile, pr = p - k * kBandTile;
  V* dst = reinterpret_cast<V*>(out + (k * kBandRows + 6 * pr) * (2 * kBandRows) +
                                e * kBandRows);
  constexpr int kStride = 2 * kBandRows / Vec16<T>::n;
  // the occupancy and the table row are loaded together (one latency)
  const int en_t = t < kBandTile ? table[p * (2 * kBandTile) + e * kBandTile + t] : -1;
  if (occ[2 * k + e] <= 0) {  // uniform across the block
    store_strip<kBandTile, T>(dst, kStride, nullptr);
    return;
  }
  if (t < kBandTile) ent[t] = en_t;
  __syncthreads();
  place_blocks<kBandTile>(gT, MWg, ent, dbT, PB, p, e == 0 ? pr : -1, strip);
  __syncthreads();
  store_strip<kBandTile, T>(dst, kStride, reinterpret_cast<const V*>(strip));
}

// Block (p, e) writes rows 6p .. 6p+5 of dense columns 768e .. 768e+767
// (pose blocks 128e .. 128e+127): zeros where the 64x128-block tile (p /
// 64, e) is unoccupied; else table[p, 128e : 128e+128] is read once and
// placed into a [6, 768] strip, the diagonal where 128e + q == p, and the
// strip goes out in 16-byte rows.  gridDim.y = PB / 128.
template <typename T>
__global__ void __launch_bounds__(kCbThreads)
compact_to_dense_kernel(const T* __restrict__ gT, int MWg, const int32_t* __restrict__ table,
                        const T* __restrict__ dbT, int PB, const int32_t* __restrict__ occ,
                        T* __restrict__ out) {
  using V = typename Vec16<T>::type;
  __shared__ __align__(16) T strip[6 * 6 * kDenseTileQ];
  __shared__ int32_t ent[kDenseTileQ];
  const int p = blockIdx.x, e = blockIdx.y, t = threadIdx.x;
  const int n = 6 * PB;
  // int64: the output passes 2^31 elements from PB = 7724 (n = 46344)
  V* dst = reinterpret_cast<V*>(out + static_cast<int64_t>(6 * p) * n + e * (6 * kDenseTileQ));
  const int en_t = t < kDenseTileQ ? table[p * PB + e * kDenseTileQ + t] : -1;
  if (occ[(p / kDenseTileP) * static_cast<int>(gridDim.y) + e] <= 0) {  // uniform
    store_strip<kDenseTileQ, T>(dst, n / Vec16<T>::n, nullptr);
    return;
  }
  if (t < kDenseTileQ) ent[t] = en_t;
  __syncthreads();
  place_blocks<kDenseTileQ>(gT, MWg, ent, dbT, PB, p, p - e * kDenseTileQ, strip);
  __syncthreads();
  store_strip<kDenseTileQ, T>(dst, n / Vec16<T>::n, reinterpret_cast<const V*>(strip));
}

constexpr int kTpQ = 32;             // pose columns per band_transpose block
constexpr int kTpCols = 6 * kTpQ;    // its 192 output columns, one per thread
// Shared row stride, in elements: 38.  The reads (6i + j) * 38 + q of a
// warp (q = t / 6, j = t % 6) meet at most two to a bank in fp32 (32 banks
// of 4 bytes) and at most two to a bank pair in fp64 (a half-warp's 8-byte
// reads over 16 pairs); no stride from 32 to 49 does better in either.
constexpr int kTpStride = kTpQ + 6;

template <typename T>
__global__ void band_transpose_kernel(const T* __restrict__ m4, const int32_t* __restrict__ occ,
                                      int64_t PB, T* __restrict__ out) {
  __shared__ T tile[36 * kTpStride];
  const int64_t p = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * kTpQ;
  const int64_t n = 6 * PB;
  const int t = threadIdx.x;
  T* dst = out + 6 * p * n + 6 * q0 + t;
  // the block's 32 columns share one 64x128-block occupancy tile: the branch
  // is uniform across the block
  if (occ[(p / kDenseTileP) * (PB / kDenseTileQ) + q0 / kDenseTileQ] <= 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dst[i * n] = T(0);
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

// ---- the entry points, one template each; extern "C" below instantiates
// them for float (cuba_<entry>) and double (cuba_<entry>_f64)

template <typename T>
int gather_cols(const T* src, const int32_t* ids, T* out, int64_t D, int64_t S, int64_t N,
                void* stream) {
  if (D * S > kInt32Max || D * N > kInt32Max) return static_cast<int>(cudaErrorInvalidValue);
  if (D * N > 0) {
    gather_cols_kernel<T><<<blocks_for(N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, ids, out, static_cast<int>(D), static_cast<int>(S), static_cast<int>(N));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int segsum_csr(const T* vals, const int32_t* order, const int32_t* offs, const int32_t* live,
               int64_t num_live, T* out, int64_t D, int64_t N, int64_t num_out, int64_t group,
               int64_t rows, void* stream) {
  if (D * N > kInt32Max || D * num_out > kInt32Max || num_out * group > kInt32Max - kThreads ||
      rows < 1 || rows > kRowChunk || (D + rows - 1) / rows > 65535 || num_live > num_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (D * num_out > 0) {
    const int d = static_cast<int>(D), n = static_cast<int>(N), m = static_cast<int>(num_out);
    const int r = static_cast<int>(rows), c = static_cast<int>(num_live);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (group) {
      case 1: launch_segsum<1, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 2: launch_segsum<2, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 4: launch_segsum<4, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 8: launch_segsum<8, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 16: launch_segsum<16, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      case 32: launch_segsum<32, T>(vals, order, offs, live, c, out, d, n, m, r, st); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int schur_fused(const T* W, const T* G, int64_t S, const int32_t* sb, const int32_t* pairs,
                const int32_t* offs, const int32_t* lane_order, int64_t slot_block,
                int64_t chunk, int64_t kwin, int64_t C, T* out, void* stream) {
  const size_t smem = schur_smem_bytes<T>(chunk, kwin);
  if (2 * slot_block != kScWin || kwin % kScPass != 0 || chunk <= 0 || C > kInt32Max ||
      smem > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = reinterpret_cast<const void*>(schur_fused_kernel<T>);
  if (C * kwin == 0) return static_cast<int>(cudaGetLastError());
  // above 48 KB only after this opt-in (per instantiation); cheap, and idempotent
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

template <typename T>
int compact_to_band(const T* gT, int64_t MWg, const int32_t* table, const T* dbT, int64_t PB,
                    const int32_t* occ, int64_t M, T* out, void* stream) {
  if (PB != M * kBandTile || M * kBandRows * 2 * kBandRows > kInt32Max ||
      36 * MWg > kInt32Max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M > 0) {
    compact_to_band_kernel<T><<<dim3(static_cast<unsigned int>(PB), 2), kCbThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        gT, static_cast<int>(MWg), table, dbT, static_cast<int>(PB), occ, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int compact_to_dense(const T* gT, int64_t MWg, const int32_t* table, const T* dbT, int64_t PB,
                     const int32_t* occ, T* out, void* stream) {
  // the output's row offsets are int64; the table's (PB^2) and gT's int32
  if (PB % kDenseTileQ != 0 || PB * PB > kInt32Max || 36 * MWg > kInt32Max) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (PB > 0) {
    const dim3 grid(static_cast<unsigned int>(PB), static_cast<unsigned int>(PB / kDenseTileQ));
    compact_to_dense_kernel<T><<<grid, kCbThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        gT, static_cast<int>(MWg), table, dbT, static_cast<int>(PB), occ, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int band_transpose(const T* m4, const int32_t* occ, int64_t PB, T* out, void* stream) {
  if (PB > 0) {
    const dim3 grid(static_cast<unsigned int>(PB), static_cast<unsigned int>(PB / kTpQ));
    band_transpose_kernel<T><<<grid, kTpCols, 0, static_cast<cudaStream_t>(stream)>>>(
        m4, occ, PB, out);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int segmm_attributes(int64_t which, int64_t smem, int64_t* out) {
  const void* fns[] = {reinterpret_cast<const void*>(compact_to_band_kernel<T>),
                       reinterpret_cast<const void*>(schur_fused_kernel<T>),
                       reinterpret_cast<const void*>(compact_to_dense_kernel<T>)};
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

}  // namespace

// Every entry has an _f64 twin with the same parameters, double* in place
// of float*: the same kernel built for fp64 (segmm.py picks the symbol by
// the tensors' dtype).
extern "C" {

// src [D, S], ids [N] int32, out [D, N]; all contiguous fp32/int32, with
// D*S and D*N within int32.
int cuba_gather_cols(const float* src, const int32_t* ids, float* out,
                     int64_t D, int64_t S, int64_t N, void* stream) {
  return gather_cols(src, ids, out, D, S, N, stream);
}

int cuba_gather_cols_f64(const double* src, const int32_t* ids, double* out,
                         int64_t D, int64_t S, int64_t N, void* stream) {
  return gather_cols(src, ids, out, D, S, N, stream);
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
  return segsum_csr(vals, order, offs, live, num_live, out, D, N, num_out, group, rows, stream);
}

int cuba_segsum_csr_f64(const double* vals, const int32_t* order, const int32_t* offs,
                        const int32_t* live, int64_t num_live, double* out, int64_t D, int64_t N,
                        int64_t num_out, int64_t group, int64_t rows, void* stream) {
  return segsum_csr(vals, order, offs, live, num_live, out, D, N, num_out, group, rows, stream);
}

// W, G [18, S], 16-byte aligned, rows a multiple of 16 bytes, S >= (max sb
// + 2) * slot_block; sb [C]; pairs/offs: the per-lane CSR (offs [C*kwin +
// 1]) with pairs[q] = li | lj << 16 of entry q's triplet, -1 where it is
// dropped; lane_order [C*kwin]: a permutation of each chunk's lanes within
// groups of 128; out [36, C*kwin], 16-byte aligned.  slot_block 256 (a
// 512-slot window), chunk the plan's (at least the entries of a chunk's
// lanes), kwin a multiple of 128.
int cuba_schur_fused(const float* W, const float* G, int64_t S, const int32_t* sb,
                     const int32_t* pairs, const int32_t* offs, const int32_t* lane_order,
                     int64_t slot_block, int64_t chunk, int64_t kwin, int64_t C, float* out,
                     void* stream) {
  return schur_fused(W, G, S, sb, pairs, offs, lane_order, slot_block, chunk, kwin, C, out,
                     stream);
}

int cuba_schur_fused_f64(const double* W, const double* G, int64_t S, const int32_t* sb,
                         const int32_t* pairs, const int32_t* offs, const int32_t* lane_order,
                         int64_t slot_block, int64_t chunk, int64_t kwin, int64_t C, double* out,
                         void* stream) {
  return schur_fused(W, G, S, sb, pairs, offs, lane_order, slot_block, chunk, kwin, C, out,
                     stream);
}

// gT [36, MWg]; table [PB, 128]; dbT [36, PB]; occ [2M]; out [M*384, 768],
// 16-byte aligned; PB = 64 M; M*384*768 and 36*MWg within int32.
int cuba_compact_to_band(const float* gT, int64_t MWg, const int32_t* table,
                         const float* dbT, int64_t PB, const int32_t* occ, int64_t M,
                         float* out, void* stream) {
  return compact_to_band(gT, MWg, table, dbT, PB, occ, M, out, stream);
}

int cuba_compact_to_band_f64(const double* gT, int64_t MWg, const int32_t* table,
                             const double* dbT, int64_t PB, const int32_t* occ, int64_t M,
                             double* out, void* stream) {
  return compact_to_band(gT, MWg, table, dbT, PB, occ, M, out, stream);
}

// gT [36, MWg]; table [PB, PB]; dbT [36, PB]; occ [PB/64 * PB/128];
// out [6PB, 6PB], 16-byte aligned; PB a multiple of 128; 36*PB^2 and
// 36*MWg within int32.
int cuba_compact_to_dense(const float* gT, int64_t MWg, const int32_t* table,
                          const float* dbT, int64_t PB, const int32_t* occ, float* out,
                          void* stream) {
  return compact_to_dense(gT, MWg, table, dbT, PB, occ, out, stream);
}

int cuba_compact_to_dense_f64(const double* gT, int64_t MWg, const int32_t* table,
                              const double* dbT, int64_t PB, const int32_t* occ, double* out,
                              void* stream) {
  return compact_to_dense(gT, MWg, table, dbT, PB, occ, out, stream);
}

// m4 [36, PB, PB]; occ [PB/64 * PB/128]; out [6PB, 6PB]; PB a multiple of 128.
int cuba_band_transpose(const float* m4, const int32_t* occ, int64_t PB, float* out,
                        void* stream) {
  return band_transpose(m4, occ, PB, out, stream);
}

int cuba_band_transpose_f64(const double* m4, const int32_t* occ, int64_t PB, double* out,
                            void* stream) {
  return band_transpose(m4, occ, PB, out, stream);
}

// What the build made of a kernel: out = {registers a thread, local
// (spilled) bytes a thread, static shared bytes, blocks an SM can hold at
// `smem` dynamic shared bytes}.  which: 0 compact_to_band, 1 schur_fused,
// 2 compact_to_dense.
int cuba_segmm_attributes(int64_t which, int64_t smem, int64_t* out) {
  return segmm_attributes<float>(which, smem, out);
}

int cuba_segmm_attributes_f64(int64_t which, int64_t smem, int64_t* out) {
  return segmm_attributes<double>(which, smem, out);
}

}  // extern "C"
