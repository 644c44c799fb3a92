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
// multiple of 8 and the tensors 16-byte aligned (the wrapper checks).
//
// P2 keeps feature rows resident in shared memory, as tal1 keeps the whole
// (M, N) table resident in VMEM and gathers there: a thread per column
// reading tableT[m, idx[r]] from L2 for every m (row_gather_fm_kernel, the
// first design) made M R = 6.2 M scattered 2-byte L2 reads at the probe's
// shape and stored 64 bytes per warp instruction, 1.2x slower than
// index_select.
// row_gather_fm_resident:
// - A block owns G = 2 consecutive feature rows (1 where 4N bytes do not
//   fit, so up to N = 116 224; a partial last group where M is odd) and a
//   contiguous range of columns; the grid is ceil(M / G) groups x as many
//   column ranges as fill the SMs once (8 x 16 = 128 blocks of 1024 threads
//   at the probe's shape). One block per SM: at G = 2 it takes 4N = 116.7 KB
//   of the 227 KB, opted in above the default 48 KB once per process
//   (cudaFuncAttributeMaxDynamicSharedMemorySize set to the card's opt-in
//   limit); two blocks would need 233 KB.
// - Copy in: the G rows are read as 16-byte loads (four in flight per
//   thread) and stored interleaved, word c = tableT[m0, c] | tableT[m0+1, c]
//   << 16, so one 4-byte shared read gathers a column for both rows. Then
//   the block's only barrier.
// - Gather: per pass a thread takes 8 consecutive columns, loads their 8
//   indices as two int4 (the next pass's two in flight while this one
//   gathers, the first pass's already during the copy-in), reads 8 words
//   and writes 8 values of each row as one 16-byte store: a warp writes
//   512 contiguous bytes per row. The 32 lanes' random word reads hit ~3-4
//   distinct addresses in the busiest of the 32 banks (bank conflicts the
//   random indices make, ~4 shared wavefronts per read instruction): ~750
//   read instructions per SM at the probe's shape, ~3k wavefronts, ~1.7 us
//   at 1.8 GHz, overlapping the 12.3 MB of stores (3.7 us).
// - Where R % 8 != 0 (or idx / out not 16-byte aligned) the rows of out
//   start off 16-byte boundaries, each by its own offset (m R mod 8), so the
//   G rows of a group share no 16-byte grouping of columns: the kernel then
//   writes every column as 2-byte stores, one thread per column. An index
//   outside [0, N) writes a zero column and reads nothing.
// - A table whose feature row does not fit (2N > the opt-in limit) takes
//   row_gather_fm_kernel, chosen by shape in the C entry: one thread per
//   column walking the M rows, scattered 2-byte reads from L2.
// Neither P1 nor P2 is on the model's path, as in the JAX package.

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

constexpr int kResThreads = 1024;
constexpr int kCopyInFlight = 4;  // 16-byte loads per thread per row in flight

template <int G> struct ResWord;  // a shared word: one column of the G rows
template <> struct ResWord<1> { typedef unsigned short T; };
template <> struct ResWord<2> { typedef unsigned int T; };

// 8 words of columns c..c+7 -> the 8 bf16 values of row g (0 or 1)
template <int G>
__device__ __forceinline__ uint4 pack_row(const typename ResWord<G>::T (&w)[8], int g) {
  if constexpr (G == 1) {
    return make_uint4(w[0] | (unsigned)w[1] << 16, w[2] | (unsigned)w[3] << 16,
                      w[4] | (unsigned)w[5] << 16, w[6] | (unsigned)w[7] << 16);
  } else {
    const unsigned sel = g ? 0x7632 : 0x5410;  // the high or the low halves
    return make_uint4(__byte_perm(w[0], w[1], sel), __byte_perm(w[2], w[3], sel),
                      __byte_perm(w[4], w[5], sel), __byte_perm(w[6], w[7], sel));
  }
}

// grid (ranges, ceil(M / G)); 2-byte values as unsigned short. vec_in: N % 8
// == 0 and tableT 16-byte aligned; vec_out: R % 8 == 0 and idx, out 16-byte
// aligned.
template <int G>
__global__ void __launch_bounds__(kResThreads, 1)
row_gather_fm_resident(const unsigned short* __restrict__ tableT, const int* __restrict__ idx,
                       unsigned short* __restrict__ out, int N, int M, int R, bool vec_in,
                       bool vec_out) {
  typedef typename ResWord<G>::T Word;
  extern __shared__ __align__(16) unsigned char res_smem[];
  Word* tab = reinterpret_cast<Word*>(res_smem);  // [N]
  const int m0 = blockIdx.y * G;
  const bool two = G == 2 && m0 + 1 < M;  // block-uniform
  const int units = vec_out ? R / 8 : R;  // 8-column groups, or columns
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  const int4 none = make_int4(-1, -1, -1, -1);

  // the first pass's indices, in flight during the copy-in
  int u = u0 + threadIdx.x;
  int4 i0 = none, i1 = none;
  if (vec_out && u < u1) {
    i0 = idx4[2 * u];
    i1 = idx4[2 * u + 1];
  }

  const unsigned short* row0 = tableT + (size_t)m0 * N;
  const unsigned short* row1 = two ? row0 + N : row0;
  if (vec_in) {
    const uint4* r0 = reinterpret_cast<const uint4*>(row0);
    const uint4* r1 = reinterpret_cast<const uint4*>(row1);
    const uint4 zero = make_uint4(0, 0, 0, 0);
    const int nv = N / 8;
    for (int v0 = threadIdx.x; v0 < nv; v0 += kCopyInFlight * kResThreads) {
      uint4 x[kCopyInFlight], y[kCopyInFlight];
#pragma unroll
      for (int k = 0; k < kCopyInFlight; ++k) {
        const int v = v0 + k * kResThreads;
        x[k] = v < nv ? r0[v] : zero;
        y[k] = (two && v < nv) ? r1[v] : zero;
      }
#pragma unroll
      for (int k = 0; k < kCopyInFlight; ++k) {
        const int v = v0 + k * kResThreads;
        if (v >= nv) continue;
        uint4* dst = reinterpret_cast<uint4*>(tab + 8 * v);
        if constexpr (G == 1) {
          dst[0] = x[k];
        } else {  // word c = row0[c] | row1[c] << 16
          dst[0] = make_uint4(__byte_perm(x[k].x, y[k].x, 0x5410),
                              __byte_perm(x[k].x, y[k].x, 0x7632),
                              __byte_perm(x[k].y, y[k].y, 0x5410),
                              __byte_perm(x[k].y, y[k].y, 0x7632));
          dst[1] = make_uint4(__byte_perm(x[k].z, y[k].z, 0x5410),
                              __byte_perm(x[k].z, y[k].z, 0x7632),
                              __byte_perm(x[k].w, y[k].w, 0x5410),
                              __byte_perm(x[k].w, y[k].w, 0x7632));
        }
      }
    }
  } else {
    for (int c = threadIdx.x; c < N; c += kResThreads) {
      tab[c] = (Word)(row0[c] | (two ? (unsigned)row1[c] << 16 : 0u));
    }
  }
  __syncthreads();  // the only barrier: the rows are resident

  if (vec_out) {
    uint4* o0 = reinterpret_cast<uint4*>(out + (size_t)m0 * R);
    uint4* o1 = reinterpret_cast<uint4*>(out + (size_t)(m0 + 1) * R);
    for (; u < u1; u += kResThreads) {
      const int c[8] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
      const int next = u + kResThreads;
      if (next < u1) {  // the next pass's indices
        i0 = idx4[2 * next];
        i1 = idx4[2 * next + 1];
      }
      Word w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = (unsigned)c[k] < (unsigned)N ? tab[c[k]] : Word(0);
      o0[u] = pack_row<G>(w, 0);
      if (two) o1[u] = pack_row<G>(w, 1);
    }
  } else {
    for (; u < u1; u += kResThreads) {
      const int col = idx[u];
      const unsigned w = (unsigned)col < (unsigned)N ? tab[col] : 0u;
      out[(size_t)m0 * R + u] = (unsigned short)(w & 0xFFFFu);
      if (two) out[(size_t)(m0 + 1) * R + u] = (unsigned short)(w >> 16);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

// The card's SM count and the shared memory a block may opt in to; on the
// first call also opts both resident kernels in to the limit.
void resident_limits(int* sms, int* smem_optin) {
  static int n_sm = 0, optin = 0;
  if (n_sm == 0) {
    int device = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    cudaFuncSetAttribute(row_gather_fm_resident<1>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    cudaFuncSetAttribute(row_gather_fm_resident<2>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  }
  *sms = n_sm;
  *smem_optin = optin;
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

// P2: the resident kernel where a feature row fits in shared memory (two
// interleaved rows where 4N bytes fit), else the thread-per-column kernel.
int gemnet_row_gather_fm(const __nv_bfloat16* tableT, const int* idx, __nv_bfloat16* out,
                         int N, int M, int R, cudaStream_t stream) {
  if (R <= 0 || M <= 0) return (int)cudaGetLastError();
  int sms = 0, optin = 0;
  resident_limits(&sms, &optin);
  const int G = 4LL * N <= optin ? 2 : (2LL * N <= optin ? 1 : 0);
  const int groups = G ? (M + G - 1) / G : 0;
  if (G == 0 || groups > 65535) {
    row_gather_fm_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        tableT, idx, out, N, M, R);
    return (int)cudaGetLastError();
  }
  const bool vec_in = N % 8 == 0 && aligned16(tableT);
  const bool vec_out = R % 8 == 0 && aligned16(idx) && aligned16(out);
  const int units = vec_out ? R / 8 : R;
  int ranges = sms / groups;
  const int passes = (units + kResThreads - 1) / kResThreads;  // ranges of one pass each
  if (ranges > passes) ranges = passes;
  if (ranges < 1) ranges = 1;
  const size_t smem = (size_t)G * 2 * N;
  const dim3 grid(ranges, groups);
  const auto* t = reinterpret_cast<const unsigned short*>(tableT);
  auto* o = reinterpret_cast<unsigned short*>(out);
  if (G == 2) {
    row_gather_fm_resident<2><<<grid, kResThreads, smem, stream>>>(t, idx, o, N, M, R, vec_in,
                                                                   vec_out);
  } else {
    row_gather_fm_resident<1><<<grid, kResThreads, smem, stream>>>(t, idx, o, N, M, R, vec_in,
                                                                   vec_out);
  }
  return (int)cudaGetLastError();
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
