// Index-driven gather and deterministic segment sum for Hopper (sm_90a).
//
// These two kernels replace the six one-hot-matmul Pallas kernels of
// cuba_tpu/ops/segmm.py that the PCG slice runs:
//
//   gather_cols  <- resident_gather (segmm.py:1257), windowed_gather
//                   (segmm.py:1215), tiled_gather (segmm.py:487)
//                   out[d, n] = src[d, ids[n]], 0 where ids[n] < 0 or >= S
//   segsum_csr   <- accum_segsum (segmm.py:105), accum_segsum_windowed
//                   (segmm.py:205), tiled_segsum (segmm.py:425)
//                   out[d, s] = sum over ids[n] == s of vals[d, n]
//
// On the TPU the one-hot matrix exists because XLA's gather/scatter ran at
// 5-10 GB/s while the MXU was idle; the windows and tiles of the Pallas
// kernels only keep that one-hot factor inside VMEM.  On Hopper an indexed
// load is cheap, so both kernels index directly and ignore the TPU plans.
//
// Both kernels do one or two flops per element loaded: they are bound by
// device-memory bytes, not by arithmetic.
//  * gather_cols: one thread per (row, output column), neighbouring threads
//    on neighbouring output columns, so the id loads and the output stores
//    coalesce.  The source reads are gathered; the ids the slice feeds are
//    locally sorted (landmark-major edge order), so neighbouring threads
//    mostly hit the same or adjacent source columns and share L2/L1 lines.
//  * segsum_csr: one thread per (row, output segment), summing the segment
//    in the fixed CSR order the host built once per structure (a stable
//    sort of the valid ids).  No atomics: every run gives the same bits.
//    Loads of offs and order are coalesced across neighbouring segments;
//    the vals reads are gathered and, for segments of different length,
//    uncoalesced and divergent.  The ids come from a locality-sorted edge
//    stream, so most segments read a narrow, cache-resident range of
//    columns.  Warp-per-segment reduction and vector loads are later work.
//
// Kernels allocate nothing.  Each entry point launches on the caller's
// stream and returns cudaGetLastError() so the Python wrapper can raise on
// a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gather_cols_kernel(const float* __restrict__ src,
                                   const int32_t* __restrict__ ids,
                                   float* __restrict__ out,
                                   int64_t D, int64_t S, int64_t N) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= D * N) return;
  const int64_t d = i / N;
  const int64_t n = i - d * N;
  const int32_t id = ids[n];
  out[i] = (id >= 0 && id < S) ? src[d * S + id] : 0.0f;
}

__global__ void segsum_csr_kernel(const float* __restrict__ vals,
                                  const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ offs,
                                  float* __restrict__ out,
                                  int64_t D, int64_t N, int64_t num_out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= D * num_out) return;
  const int64_t d = i / num_out;
  const int64_t s = i - d * num_out;
  const float* row = vals + d * N;
  const int32_t end = offs[s + 1];
  float acc = 0.0f;
  for (int32_t j = offs[s]; j < end; ++j) acc += row[order[j]];
  out[i] = acc;
}

unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// src [D, S], ids [N] int32, out [D, N]; all contiguous fp32/int32.
int cuba_gather_cols(const float* src, const int32_t* ids, float* out,
                     int64_t D, int64_t S, int64_t N, void* stream) {
  if (D * N > 0) {
    gather_cols_kernel<<<blocks_for(D * N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(src, ids, out, D, S, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// vals [D, N], order [offs[num_out]] int32 (column of vals per CSR entry),
// offs [num_out + 1] int32, out [D, num_out].
int cuba_segsum_csr(const float* vals, const int32_t* order, const int32_t* offs,
                    float* out, int64_t D, int64_t N, int64_t num_out, void* stream) {
  if (D * num_out > 0) {
    segsum_csr_kernel<<<blocks_for(D * num_out), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(vals, order, offs, out,
                                                             D, N, num_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
