// Sorted segment sum with a fused permute, fp32, for sm_90a.
//
// K3 gemnet_sorted_segsum_f32
//     out[e, m] = sum_{t : sorted_ids[t] = e} x[perm[t], m]
//   the VJP of every sorted expand gather x = table[idx]; replaces
//   gemnet_pytorch_tpu/ops/pallas/expand_gather.py::_segsum_pallas (its inner
//   `kernel`), together with the `x[perm]` gather that precedes it there.
//
// What bounds it on an H100: bytes, at one add per row element read. The
// least traffic is x (n*M) and perm (n) once, and out (nSeg*M) once: ~30 MB
// at the quad_abd shape (192512 x 32 -> 29184 x 32).
//
// Design: the host cuts each segment's sorted rows into work items of at
// most 32 rows (data/batch.py::segment_plan): items[i] = {segment, first row,
// end row, partial slot}. One thread per (item, m) sums its item's rows in
// order; the padded rows of a batch all share one segment id, and the items
// spread that segment over thousands of threads instead of one. An item of
// an unsplit segment writes the output; the items of a split segment write
// partial rows that a second kernel adds in order, so each output is written
// once, without atomics, in a fixed order. The permute is fused: the thread
// reads row perm[t] of x where the TPU path first materialized x[perm],
// which saves an (n, M) write and read. Threads of a warp cover consecutive m
// of one item (coalesced for M = 32, 64) or, for the narrow geometry streams
// (M = 3, 4), several neighbouring items. Any n and any M are taken.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void sorted_segsum_kernel(const float* __restrict__ x,
                                     const int* __restrict__ perm,
                                     const int4* __restrict__ items,
                                     float* __restrict__ partial,
                                     float* __restrict__ out, int n_items, int M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_items * M) return;
  const int4 item = items[i / M];  // segment, row0, row1, slot
  const int m = (int)(i % M);
  float acc = 0.f;
#pragma unroll 4
  for (int t = item.y; t < item.z; ++t) acc += x[(size_t)perm[t] * M + m];
  if (item.w < 0) {
    out[(size_t)item.x * M + m] = acc;
  } else {
    partial[(size_t)item.w * M + m] = acc;
  }
}

// out[merge_seg[j], m] = sum of the partial rows of split segment j
__global__ void sorted_segsum_merge_kernel(const float* __restrict__ partial,
                                           const int* __restrict__ merge_ptr,
                                           const int* __restrict__ merge_seg,
                                           float* __restrict__ out, int n_merge,
                                           int M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n_merge * M) return;
  const int j = (int)(i / M);
  const int m = (int)(i % M);
  float acc = 0.f;
  for (int k = merge_ptr[j]; k < merge_ptr[j + 1]; ++k) acc += partial[(size_t)k * M + m];
  out[(size_t)merge_seg[j] * M + m] = acc;
}

unsigned blocks_for(long long threads) {
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int gemnet_sorted_segsum_f32(const float* x, const int* perm, const int* items,
                             int n_items, const int* merge_ptr,
                             const int* merge_seg, int n_merge, float* partial,
                             float* out, int M, cudaStream_t stream) {
  if ((long long)n_items * M > 0) {
    sorted_segsum_kernel<<<blocks_for((long long)n_items * M), kThreads, 0, stream>>>(
        x, perm, reinterpret_cast<const int4*>(items), partial, out, n_items, M);
  }
  if ((long long)n_merge * M > 0) {
    sorted_segsum_merge_kernel<<<blocks_for((long long)n_merge * M), kThreads, 0,
                                 stream>>>(partial, merge_ptr, merge_seg, out,
                                           n_merge, M);
  }
  return (int)cudaGetLastError();
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
