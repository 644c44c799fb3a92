// Row gathers of a bf16 table, for sm_90a: the row-gather probe.
//
// P1 gemnet_row_gather
//     out[r, :] = table[idx[r], :]     table (N, M), out (R, M)
//   replaces scripts/gather_probe.py::tal0 (a Pallas kernel with the whole
//   table resident in VMEM and a take_along_axis over its rows).
// P2 gemnet_row_gather_fm
//     out[:, r] = tableT[:, idx[r]]    tableT (M, N), out (M, R)
//   replaces scripts/gather_probe.py::tal1 (the feature-major layout, a
//   take_along_axis over lanes).
//
// What bounds them on an H100: bytes. Each must read idx once (4R bytes) and
// the table once (2NM: the 1.87 MB table stays in the 50 MB L2, so a row
// named again, random as the reads are, costs L2 rather than HBM traffic) and
// write the output once (2RM): at the probe's shape (N = 29184, M = 32,
// R = 192512) ~15.0 MB, 4.47 us at 3.35 TB/s.
//
// Design. P1: each thread copies 16 bytes (8 bf16) of one output row, so a
// 64-byte row takes 4 neighbouring threads; the reads of a row are one
// 64-byte run and the writes are coalesced across the warp. M must be a
// multiple of 8 and the tensors 16-byte aligned (the wrapper checks). P2: one
// thread per r walks the M feature rows; for each m the warp's writes
// out[m, r..r+31] are coalesced, its reads tableT[m, idx[r]] scattered 2-byte
// loads from L2. An index outside [0, N) writes a zero row (column) and reads
// nothing. Neither kernel is on the model's path, as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ idx,
                                  uint4* __restrict__ out, int N, int V, long long total) {
  // V = M / 8 16-byte vectors per row
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / V;
    const int v = (int)(i - r * V);
    const int row = idx[r];
    out[i] = (row >= 0 && row < N) ? table[(long long)row * V + v] : make_uint4(0, 0, 0, 0);
  }
}

__global__ void row_gather_fm_kernel(const __nv_bfloat16* __restrict__ tableT,
                                     const int* __restrict__ idx,
                                     __nv_bfloat16* __restrict__ out, int N, int M, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int col = idx[r];
  const bool ok = col >= 0 && col < N;
  for (int m = 0; m < M; ++m) {
    out[(size_t)m * R + r] = ok ? tableT[(size_t)m * N + col] : __float2bfloat16_rn(0.f);
  }
}

}  // namespace

extern "C" {

int gemnet_row_gather(const __nv_bfloat16* table, const int* idx, __nv_bfloat16* out, int N,
                      int M, int R, cudaStream_t stream) {
  if (M % 8 != 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)R * (M / 8);
  if (total > 0) {
    const long long want = (total + kThreads - 1) / kThreads;
    const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
    row_gather_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(table), idx, reinterpret_cast<uint4*>(out), N, M / 8,
        total);
  }
  return (int)cudaGetLastError();
}

int gemnet_row_gather_fm(const __nv_bfloat16* tableT, const int* idx, __nv_bfloat16* out,
                         int N, int M, int R, cudaStream_t stream) {
  if (R > 0) {
    row_gather_fm_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        tableT, idx, out, N, M, R);
  }
  return (int)cudaGetLastError();
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
