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
// y_k = invd[k] (b_k + d_k), then d -= L[:, stripe k] y_k.
//
// On the GPU the grid is not sequential and blocks cannot carry d from one
// step to the next, so each sweep is one launch whose blocks hand results
// to each other through device memory, left-looking over ROW stripes of L.
//
// The forward sweep (solve_lower_kernel) is one launch, with one hand-off
// a stripe:
//   y_i = invd[i] r_i,  r_i = b_i - sum_{j < i} L[stripe i, stripe j] y_j.
// The first design (2K dependent launches of a warp-per-row dot product,
// 66 at n = 8448) spent its time on launches, scalar loads and a 256-row
// diagonal step on 8 blocks.  A plain mirror of the backward sweep would
// pay its two hand-offs a stripe.  Here:
//  * A tile is (stripe i, kTile = 32 consecutive rows R_t of it), one block
//    each, K * 256/32 blocks, taken from an atomic ticket, stripe 0's tiles
//    first.  A tile waits only on lower stripes, never on the tiles of its
//    own stripe, so every wait ends once one block can be resident.
//  * L's rows are contiguous: the tile reads L[R_t, stripe j] as float4,
//    thread t the column quad t % 64 of rows t/64 + 4m (m < kLowerRows =
//    8), the next stripe's rows loaded into registers before it waits for
//    y_j (L does not depend on y).  It stages invd[i][:, R_t] (256 x 32
//    floats, rows padded to 36 so that its float4 reads meet no bank
//    conflict) in shared memory before its first wait.
//  * One hand-off a stripe: the inverse is linear, so y_i = sum_t
//    invd[i][:, R_t] r_i[R_t].  Once a tile has r_i[R_t] it computes its
//    partial P_{i,t} (256 outputs, one a thread, 32 FMAs from shared
//    memory), writes it to pbuf[i][t] and adds one to done[i].  A consumer
//    of y_j waits for done[j] = 8 and forms the float4 of y_j it needs as
//    P_{j,0} + ... + P_{j,7}, in tile order, from the L2.  The block whose
//    add fills done[i] (the last of its stripe) writes y_i the same way,
//    off the chain.
//  * Deterministic sums: a thread's row sums add its stripes j in order,
//    each stripe's four columns by fmaf; the 64 column quads of a row (two
//    warps) are combined by a xor butterfly in each warp and the two warps'
//    sums in order; r = b - that sum.  walks.solve_lower_walk is that order
//    in NumPy.
//  The waits, fences and reads of other blocks' data follow the rules
//  below.  On an H100 it takes ~0.125 ms at n = 8448 (2.8x the bytes'
//  bound), ~3.8 us a stripe: with no waits at all (wrong values) the
//  tiles' own stream of L, one stripe ahead, takes 0.064; an acquire load
//  in place of the volatile spin and its fence 0.110.  Prefetching L two
//  to six stripes ahead into the L2, rings of 2-4 stripes in shared memory
//  by cp.async (with or without a ninth warp that only waits), a flag for
//  each consumer tile and a longer back-off were each no faster
//  (tools/probe_trisolve.py; PERF.md).
//
// The backward sweep (solve_upper_kernel) is one launch.  It is written
// left-looking, for x = L^-T y directly, over ROW stripes of L (no
// transpose is formed):
//   x_i = invd[i]^T r_i,  r_i = y_i - sum_{j > i} L[stripe j, stripe i]^T x_j.
// What bounded the 2K-launch version was not bytes: 2K dependent launches
// (66 at n = 8448, 6.5 us each against ~1.3 us of bytes a step), a 256x256
// diagonal step on 8 blocks of a 132-SM card, late updates on lo/32 blocks,
// and scalar loads with one row a warp in flight.  Here:
//  * A tile is (stripe i, kTile = 32 consecutive columns of it), one block
//    each, K * 256/32 blocks in all.  It reads its column block
//    L[(i+1)B : n, cols] once as float4 (128 contiguous bytes a row), kRows
//    = 8 rows a thread a stripe, the next stripe's rows loaded into
//    registers before it waits for the current stripe's x (L does not
//    depend on x: a tile waits only for x_j itself, 32 KB a block in
//    flight).  It stages invd[i][:, cols] (B*32 floats) in shared memory
//    first, so its diagonal step reads no device memory.  What bounds it is
//    then the chain of two hand-offs a stripe (on an H100 ~3.5 us a stripe
//    at K = 6, ~5.2 us at K = 33), not the bytes (L's strictly-lower
//    blocks once).  Tiles of 16 columns were no faster.
//  * Order of work without a deadlock: a block takes its tile from an
//    atomic ticket, stripe K-1's tiles first, then K-2's, ...  A tile waits
//    only on tiles of higher stripes (smaller tickets) and on the other
//    tiles of its own stripe; tickets go only to running blocks, so every
//    wait ends once 256/32 blocks can be resident at once.  Any grid size
//    works; no cooperative launch.
//  * Hand-off, two flags a stripe (int32 counters in a zeroed workspace,
//    each on a 128-byte line of its own): a tile writes r for its 32
//    columns to rbuf and adds one to cnt[i], waits for cnt[i] = 8, reads all
//    of r_i, writes its 32 entries of x_i = invd[i][:, cols]^T r_i and adds
//    one to ready[i]; a consumer of x_j waits for ready[j] = 8.
//  * Memory ordering (the usual fault of such kernels; both sweeps).
//    Publish: every writing thread writes, runs __threadfence(), then
//    __syncthreads(), then one thread adds to the flag.  Wait: one thread
//    spins on a volatile read of the flag, runs __threadfence(), then
//    __syncthreads().  x, rbuf and the forward sweep's pbuf, written by
//    other blocks during the kernel, are read only with __ldcg (through the
//    L2), never through __ldg or a const __restrict__ pointer: the
//    non-coherent path may return stale lines.  L, invd, b and y are
//    read-only and use __ldg.
//  * Every wait (both sweeps) is bounded: past kSpinCycles (~0.5 s, far
//    above any real wait) the spinning thread calls __trap(), and the fault
//    surfaces as a CUDA error at the caller's next synchronise.
//  * Deterministic sums, no float atomics: a thread adds its terms in one
//    fixed order (j from K-1 down to i+1, its rows in row order), the row
//    groups are combined through shared memory in group order, and r_i =
//    y_i - that sum.  The diagonal step has the same shape over invd[i]'s
//    rows.  walks.solve_upper_walk is that order in NumPy.
//
// The matvec has a kernel of its own (matvec_kernel): one warp per row
// would leave 1,536 warps at n = 1536, too few loads in flight to hide the
// latency, and one dependent FMA chain per lane.  It splits each row into
// S contiguous slices of 4-column quads, one warp per slice (S from n, so
// that small n still fills the card), loads a quad as one float4 where n
// % 4 == 0 and A, x are 16-byte aligned (four scalar loads otherwise, in
// the same order), and keeps kAccs = 4 accumulators per lane with 4 quads'
// loads issued before their FMAs.  walks.matvec_walk is its order in
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
// read: a sweep reads the strictly-lower blocks of L once (invd stands for
// the diagonal ones: (n^2 - K B^2)/2 * 4 bytes, 3.9 MB at n = 1536, 138 MB
// at n = 8448), the matvec all of A, the copy the K
// diagonal blocks twice (read and write).  At small n the sweeps' K stripe
// hand-offs, not the bytes, set their time.
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
constexpr int kTile = 32;                   // rows (forward) or columns (backward) a sweep's block takes
constexpr int kTileQuads = kTile / 4;       // float4 a row of a tile
constexpr int kGroups = kThreads / kTileQuads;  // row groups of a tile
constexpr int kRows = kBlock / kGroups;     // rows of a stripe a thread of a tile takes
constexpr int kTiles = kBlock / kTile;      // tiles a stripe
constexpr int kLowerGroups = kThreads / kQuads;   // row groups of a forward tile: 4
constexpr int kLowerRows = kTile / kLowerGroups;  // rows of a forward tile a thread takes: 8
constexpr int kDinvStride = kTile + 4;  // floats a staged row of invd[i][:, R_t]: no bank conflicts
constexpr int kLine = 32;                   // int32s between two flags: a 128-byte line
constexpr long long kSpinCycles = 1LL << 30;  // ~0.54 s at 1.98 GHz: a wait past it traps

// out[k] = L[kB:(k+1)B, kB:(k+1)B] for B = 256, in float4 (n4 = n / 4).
// Block (x, k) copies rows x*kPass*kLoads + t/kQuads + i*kPass, i < kLoads,
// of block k, thread t the column quad t % kQuads; a row's offset in L is
// int64 (n*n may pass 2^31: n = 49152 at P = 8192), the rest int32.
__global__ void extract_diag_kernel(const float4* __restrict__ L, int n4,
                                    float4* __restrict__ out) {
  const int c = threadIdx.x % kQuads;
  const int r = blockIdx.y * kBlock + blockIdx.x * (kPass * kLoads) + threadIdx.x / kQuads;
  const float4* src = L + static_cast<int64_t>(r) * n4 + blockIdx.y * kQuads + c;
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
    const float* row = A + static_cast<int64_t>(r) * n;
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

// One thread's wait for *flag >= target (a flag only grows): a volatile
// read (not cached in L1) in a bounded spin, then the acquire fence.  Past
// kSpinCycles it traps: a lost hand-off fails the launch instead of hanging.
__device__ __forceinline__ void wait_flag(const int* flag, int target) {
  const volatile int* f = flag;
  if (*f < target) {
    const long long start = clock64();
    while (*f < target) {
      if (clock64() - start > kSpinCycles) __trap();
      __nanosleep(32);
    }
  }
  __threadfence();
}

// acc.{x,y,z,w} = fmaf(v.{x,y,z,w}, s, acc.{x,y,z,w})
__device__ __forceinline__ void fma4(float4& acc, const float4 v, float s) {
  acc.x = fmaf(v.x, s, acc.x);
  acc.y = fmaf(v.y, s, acc.y);
  acc.z = fmaf(v.z, s, acc.z);
  acc.w = fmaf(v.w, s, acc.w);
}

// rows row0 + kGroups*m (m < kRows) of a column quad: float4 number p +
// row * n4 (an int64 offset)
__device__ __forceinline__ void load_rows(float4 (&v)[kRows], const float4* __restrict__ p,
                                          int n4, int row0) {
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    v[m] = __ldg(p + static_cast<int64_t>(row0 + kGroups * m) * n4);
  }
}

// The sum over the row groups of the tile's partials, in group order, for
// column threadIdx.x < kTile: part holds group g's kTile sums at g*kTile.
__device__ __forceinline__ float combine(const float* part) {
  float s = part[threadIdx.x];
#pragma unroll
  for (int h = 1; h < kGroups; ++h) s += part[h * kTile + threadIdx.x];
  return s;
}

// x = L^-T y (the header's backward sweep), one tile of kTile columns a
// block.  Thread t takes column quad q = t % kTileQuads of the tile and row
// group g = t / kTileQuads: rows g + kGroups*m (m < kRows) of every stripe.
// work: the ticket at 0, cnt[k] at (1 + k) * kLine, ready[k] at (1 + K + k)
// * kLine, all zero on entry; rbuf [n] the stripes' r.  L row-major [n, n],
// 16-byte aligned, as is invd [K, 256, 256]; offsets of rows of L int64,
// the rest int32.
__global__ void __launch_bounds__(kThreads)
solve_upper_kernel(const float* __restrict__ L, const float* __restrict__ invd,
                   const float* __restrict__ y, float* x, int* work, float* rbuf, int n,
                   int K) {
  static_assert(kThreads == kBlock, "one thread an entry of r_i");
  __shared__ float4 dinv[kBlock * kTileQuads];  // invd[i][:, the tile's columns], by row
  __shared__ float4 part4[kThreads];     // the row groups' partial sums
  __shared__ float r[kBlock];            // r_i
  __shared__ int ticket;
  const float* part = reinterpret_cast<const float*>(part4);
  const int q = threadIdx.x % kTileQuads;
  const int g = threadIdx.x / kTileQuads;
  if (threadIdx.x == 0) ticket = atomicAdd(work, 1);
  __syncthreads();
  const int i = K - 1 - ticket / kTiles;           // the tile's stripe
  const int col = (ticket % kTiles) * kTile;       // its first column in the stripe
  const int c0 = i * kBlock + col;                 // ... in L
  {
    const float4* src = reinterpret_cast<const float4*>(invd + i * kBlock * kBlock + col) + q;
    float4 v[kRows];
    load_rows(v, src, kBlock / 4, g);
#pragma unroll
    for (int m = 0; m < kRows; ++m) dinv[(g + kGroups * m) * kTileQuads + q] = v[m];
  }
  if (i + 1 < K) {
    // r for the tile's columns: y - sum_{j > i} L[stripe j, cols]^T x_j
    const float4* Lq = reinterpret_cast<const float4*>(L + c0) + q;
    const int n4 = n / 4;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 cur[kRows], nxt[kRows];
    load_rows(cur, Lq, n4, (K - 1) * kBlock + g);
    for (int j = K - 1; j > i; --j) {
      if (j - 1 > i) load_rows(nxt, Lq, n4, (j - 1) * kBlock + g);
      if (threadIdx.x == 0) wait_flag(work + (1 + K + j) * kLine, kTiles);
      __syncthreads();
      float xa[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) xa[m] = __ldcg(x + j * kBlock + g + kGroups * m);
#pragma unroll
      for (int m = 0; m < kRows; ++m) fma4(acc, cur[m], xa[m]);
      if (j - 1 > i) {
#pragma unroll
        for (int m = 0; m < kRows; ++m) cur[m] = nxt[m];
      }
    }
    part4[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < kTile) {
      rbuf[c0 + threadIdx.x] = __ldg(y + c0 + threadIdx.x) - combine(part);
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicAdd(work + (1 + i) * kLine, 1);
      wait_flag(work + (1 + i) * kLine, kTiles);
    }
    __syncthreads();
    r[threadIdx.x] = __ldcg(rbuf + i * kBlock + threadIdx.x);
  } else {
    r[threadIdx.x] = __ldg(y + i * kBlock + threadIdx.x);  // y - 0: no stripe below
  }
  __syncthreads();
  // the diagonal step: x[cols] = invd[i][:, cols]^T r_i, from shared memory
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    fma4(acc, dinv[(g + kGroups * m) * kTileQuads + q], r[g + kGroups * m]);
  }
  part4[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < kTile) {
    x[c0 + threadIdx.x] = combine(part);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(work + (1 + K + i) * kLine, 1);
}

// y = L^-1 b (the header's forward sweep), one tile of kTile rows a block.
// Thread t takes column quad q = t % kQuads of every stripe and rows g +
// kLowerGroups*m (m < kLowerRows) of the tile, g = t / kQuads: the row sums
// of warp 2g are its rows' quads 0-31, of warp 2g+1 quads 32-63.  work: the
// ticket at 0, done[k] at (1 + k) * kLine, all zero on entry; pbuf [K,
// kTiles, 256] the tiles' partials.  L row-major [n, n], 16-byte aligned,
// as is invd [K, 256, 256]; offsets of rows of L int64, the rest int32.
__global__ void __launch_bounds__(kThreads)
solve_lower_kernel(const float* __restrict__ L, const float* __restrict__ invd,
                   const float* __restrict__ b, float* y, int* work, float* pbuf, int n) {
  __shared__ float4 dinv[kBlock * kDinvStride / 4];  // invd[i][c, R_t] at row c, stride 36
  __shared__ float part[kWarps * kLowerRows];         // the warps' row sums
  __shared__ float4 r4[kTile / 4];                    // r_i on the tile's rows
  __shared__ int ticket;
  float* r = reinterpret_cast<float*>(r4);
  const int t = threadIdx.x;
  const int q = t % kQuads, g = t / kQuads;
  if (t == 0) ticket = atomicAdd(work, 1);
  __syncthreads();
  const int i = ticket / kTiles;             // the tile's stripe
  const int tile = ticket % kTiles;          // its tile within the stripe
  const int row0 = i * kBlock + tile * kTile;  // its first row in L
  const int n4 = n / 4;
  // rows g + kLowerGroups*m of the tile, column quad q of stripe 0
  const float4* Lq = reinterpret_cast<const float4*>(L) + static_cast<int64_t>(row0 + g) * n4 + q;
  float4 cur[kLowerRows], nxt[kLowerRows];
  if (i > 0) {
#pragma unroll
    for (int m = 0; m < kLowerRows; ++m) cur[m] = __ldg(Lq + kLowerGroups * m * n4);
  }
  {  // stage invd[i][:, R_t]: thread t copies quad t % 8 of rows t/8 + 32m
    constexpr int kRowQuads = kTile / 4;
    constexpr int kStep = kThreads / kRowQuads;
    const int kq = t % kRowQuads, c = t / kRowQuads;
    const float4* src =
        reinterpret_cast<const float4*>(invd + i * kBlock * kBlock + tile * kTile) + kq;
    float4 v[kBlock / kStep];
#pragma unroll
    for (int m = 0; m < kBlock / kStep; ++m) v[m] = __ldg(src + (c + kStep * m) * kQuads);
#pragma unroll
    for (int m = 0; m < kBlock / kStep; ++m) {
      dinv[(c + kStep * m) * (kDinvStride / 4) + kq] = v[m];
    }
  }
  const float bt = t < kTile ? __ldg(b + row0 + t) : 0.0f;
  float acc[kLowerRows];
#pragma unroll
  for (int m = 0; m < kLowerRows; ++m) acc[m] = 0.0f;
  for (int j = 0; j < i; ++j) {
    if (j + 1 < i) {
#pragma unroll
      for (int m = 0; m < kLowerRows; ++m) {
        nxt[m] = __ldg(Lq + kLowerGroups * m * n4 + (j + 1) * kQuads);
      }
    }
    if (t == 0) wait_flag(work + (1 + j) * kLine, kTiles);
    __syncthreads();
    // y_j's quad q: the stripe's partials added in tile order
    const float4* pj = reinterpret_cast<const float4*>(pbuf + j * kTiles * kBlock) + q;
    float4 p[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) p[u] = __ldcg(pj + u * kQuads);
    float4 yq = p[0];
#pragma unroll
    for (int u = 1; u < kTiles; ++u) {
      yq.x += p[u].x;
      yq.y += p[u].y;
      yq.z += p[u].z;
      yq.w += p[u].w;
    }
#pragma unroll
    for (int m = 0; m < kLowerRows; ++m) {
      acc[m] = fmaf(cur[m].x, yq.x, acc[m]);
      acc[m] = fmaf(cur[m].y, yq.y, acc[m]);
      acc[m] = fmaf(cur[m].z, yq.z, acc[m]);
      acc[m] = fmaf(cur[m].w, yq.w, acc[m]);
    }
    if (j + 1 < i) {
#pragma unroll
      for (int m = 0; m < kLowerRows; ++m) cur[m] = nxt[m];
    }
  }
  // r on the tile's rows: each warp's butterfly, then the row's two warps in order
#pragma unroll
  for (int m = 0; m < kLowerRows; ++m) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], o);
  }
  if ((t & 31) == 0) {
#pragma unroll
    for (int m = 0; m < kLowerRows; ++m) part[(t >> 5) * kLowerRows + m] = acc[m];
  }
  __syncthreads();
  if (t < kTile) {  // local row t = gg + kLowerGroups * mm
    const int gg = t % kLowerGroups, mm = t / kLowerGroups;
    r[t] = i > 0 ? bt - (part[2 * gg * kLowerRows + mm] + part[(2 * gg + 1) * kLowerRows + mm])
                 : bt;
  }
  __syncthreads();
  // the tile's partial P_{i,tile}[t] = invd[i][t, R_t] . r, from shared memory
  float s = 0.0f;
#pragma unroll
  for (int kq = 0; kq < kTile / 4; ++kq) {
    const float4 d = dinv[t * (kDinvStride / 4) + kq], v = r4[kq];
    s = fmaf(d.x, v.x, s);
    s = fmaf(d.y, v.y, s);
    s = fmaf(d.z, v.z, s);
    s = fmaf(d.w, v.w, s);
  }
  pbuf[(i * kTiles + tile) * kBlock + t] = s;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int before = atomicAdd(work + (1 + i) * kLine, 1);
    __threadfence();
    ticket = before == kTiles - 1;  // the stripe's last tile writes y_i
  }
  __syncthreads();
  if (ticket) {
    const float* pi = pbuf + i * kTiles * kBlock + t;
    float v = __ldcg(pi);
#pragma unroll
    for (int u = 1; u < kTiles; ++u) v += __ldcg(pi + u * kBlock);
    y[i * kBlock + t] = v;
  }
}

// Where pbuf starts in solve_lower_kernel's workspace of int32 words: after
// the ticket's line and the K done lines.
int64_t lower_pbuf_at(int64_t K) { return (1 + K) * kLine; }

// Where rbuf starts in solve_upper_kernel's workspace of int32 words: after
// the ticket's line and the K cnt and K ready lines.
int64_t upper_rbuf_at(int64_t K) { return (1 + 2 * K) * kLine; }

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

// L [n, n] lower triangular and invd [n/256, 256, 256], both 16-byte
// aligned, n a multiple of 256; b [n]; y [n] out; work
// [cuba_solve_lower_work(n)] int32 zeros.  One launch of K * 256/kTile
// blocks.
int cuba_solve_lower(const float* L, const float* invd, const float* b, float* y, int* work,
                     int64_t n, void* stream) {
  if (n % kBlock != 0 || !aligned16(L) || !aligned16(invd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = static_cast<int>(n / kBlock);
  if (K == 0) return static_cast<int>(cudaGetLastError());
  float* pbuf = reinterpret_cast<float*>(work + lower_pbuf_at(K));
  solve_lower_kernel<<<static_cast<unsigned int>(K * kTiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(L, invd, b, y, work, pbuf,
                                                            static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of cuba_solve_lower's workspace for n (the flags' lines,
// then pbuf [K, 256/kTile, 256]); the caller zeroes them before each call.
int cuba_solve_lower_work(int64_t n) {
  return static_cast<int>(lower_pbuf_at(n / kBlock) + n / kBlock * kTiles * kBlock);
}

// L [n, n] lower triangular and invd [n/256, 256, 256], both 16-byte
// aligned, n a multiple of 256; y [n]; x [n] out; work
// [cuba_solve_upper_work(n)] int32 zeros.  One launch of K * 256/kTile
// blocks.
int cuba_solve_upper(const float* L, const float* invd, const float* y, float* x, int* work,
                     int64_t n, void* stream) {
  if (n % kBlock != 0 || !aligned16(L) || !aligned16(invd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int K = static_cast<int>(n / kBlock);
  if (K == 0) return static_cast<int>(cudaGetLastError());
  float* rbuf = reinterpret_cast<float*>(work + upper_rbuf_at(K));
  solve_upper_kernel<<<static_cast<unsigned int>(K * kTiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(L, invd, y, x, work, rbuf,
                                                            static_cast<int>(n), K);
  return static_cast<int>(cudaGetLastError());
}

// The int32 words of cuba_solve_upper's workspace for n (the flags' lines,
// then rbuf [n]); the caller zeroes them before each call.
int cuba_solve_upper_work(int64_t n) { return static_cast<int>(upper_rbuf_at(n / kBlock) + n); }

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
