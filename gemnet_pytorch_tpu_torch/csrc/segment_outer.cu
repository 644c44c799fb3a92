// Bilinear neighbour reduction of GemNet and its VJP, fp32 and bf16 streams,
// for sm_90a.
//
// K1 gemnet_segment_outer_sum_{f32,bf16}
//     out[s, e, m] = sum_{t : seg(t) = e} a[t, s] * b[t, m]
//   replaces gemnet_pytorch_tpu/ops/pallas/segment_outer.py::_fwd_kernel
//   (launched by _outer_sum_pallas).
// K2 gemnet_segment_gather_contract_{f32,bf16}
//     da[t, s] = sum_m cot[s, seg(t), m] * b[t, m]
//     db[t, m] = sum_s cot[s, seg(t), m] * a[t, s]
//   replaces segment_outer.py::_bwd_kernel (launched by _gather_contract_pallas).
// K4 gemnet_segment_outer_sum_split3, gemnet_segment_gather_contract_split3
//   K1 and K2 in the fp32 "split3" mode, on the tensor cores (section below).
//
// Stream types follow the JAX package's contract (segment_outer.py:152-157,
// 205-216, 586-590): with fp32 streams everything is fp32; with bf16 streams
// (compute_dtype="bfloat16") the rows, and K2's cotangent, are read as bf16
// and widened to fp32 in shared memory, every product and sum is fp32, and
// the stores round once to bf16: K1's output, K2's da and db. K1's partial
// tiles of a split segment stay fp32 until the merge rounds their sum.
//
// Rows are sorted by segment. The host cuts each segment's rows into work
// items of at most 128 rows (data/batch.py::segment_plan): items[i] =
// {segment, first row, end row, partial slot}. Every row lies in exactly one
// item (the wrapper's precondition).
//
// What bounds them on an H100: bytes. K1 reads a (n*S) and b (n*M) once and
// writes out (S*nSeg*M) once: 2*S*M flops per row over 4*(S+M) bytes is ~8
// flops/byte at the quad shape (S=49, M=32), under the card's fp32 ridge of
// 67 TFLOP/s / 3.35 TB/s = 20 (bf16 streams halve the bytes). K2 moves a, b,
// da, db and cot: ~145 MB at the quad shape in fp32, ~72 MB in bf16.
//
// Design: one thread block per work item. The padded rows of a batch all
// share one segment id (thousands of rows); items spread such a segment
// over many SMs, where one block per segment left a single SM serializing
// it while the card idled. K1 threads own (s, m) output elements with the
// accumulators in registers; an item of an unsplit segment writes the
// output, the items of a split segment write (S, M) partial tiles that a
// second kernel adds in row order, so each output is written once, without
// atomics, in a fixed order. K2 items write their own rows' da/db directly.
// The rows stream through shared memory in chunks of kChunk rows (coalesced
// copies of contiguous row ranges); K2 stages the segment's (S, M) cotangent
// tile once per item. Shared rows are padded to M+1 floats where threads of
// a warp read along s, so those reads fall in distinct banks. This is the
// simple first design: tensor cores (bf16 mma on the staged tiles), several
// items per block and overlap of the next chunk's load with the current
// chunk's math are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kChunk = 32;        // rows staged in shared memory per pass
constexpr int kMaxSPerThread = 8; // K1 register accumulators per thread
constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void outer_sum_kernel(const T* __restrict__ a,
                                 const T* __restrict__ b,
                                 const int4* __restrict__ items,
                                 float* __restrict__ partial,
                                 T* __restrict__ out,
                                 int n_seg, int S, int M, int G) {
  extern __shared__ float smem[];
  float* a_s = smem;               // [kChunk][S]
  float* b_s = smem + kChunk * S;  // [kChunk][M]
  const int4 item = items[blockIdx.x];  // segment, row0, row1, slot
  const int tid = threadIdx.x;
  const int m = tid % M;  // blockDim.x == G * M
  const int g = tid / M;  // this thread owns s = g, g + G, ...

  float acc[kMaxSPerThread];
#pragma unroll
  for (int k = 0; k < kMaxSPerThread; ++k) acc[k] = 0.f;

  for (int r = item.y; r < item.z; r += kChunk) {
    const int nr = min(kChunk, item.z - r);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < nr * S; i += blockDim.x) a_s[i] = widen(a[(size_t)r * S + i]);
    for (int i = tid; i < nr * M; i += blockDim.x) b_s[i] = widen(b[(size_t)r * M + i]);
    __syncthreads();
    for (int t = 0; t < nr; ++t) {
      const float bv = b_s[t * M + m];
#pragma unroll
      for (int k = 0; k < kMaxSPerThread; ++k) {
        const int s = g + k * G;
        if (s < S) acc[k] += a_s[t * S + s] * bv;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxSPerThread; ++k) {
    const int s = g + k * G;
    if (s < S) {
      if (item.w < 0) {
        out[((size_t)s * n_seg + item.x) * M + m] = narrow<T>(acc[k]);
      } else {
        partial[((size_t)item.w * S + s) * M + m] = acc[k];
      }
    }
  }
}

// out[s, merge_seg[j], m] = sum of the (fp32) partial tiles of split segment j
template <typename T>
__global__ void outer_sum_merge_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ merge_ptr,
                                       const int* __restrict__ merge_seg,
                                       T* __restrict__ out,
                                       int n_seg, int S, int M) {
  const int j = blockIdx.x;
  const int e = merge_seg[j];
  const int k0 = merge_ptr[j], k1 = merge_ptr[j + 1];
  for (int i = threadIdx.x; i < S * M; i += blockDim.x) {
    float acc = 0.f;
    for (int k = k0; k < k1; ++k) acc += partial[(size_t)k * S * M + i];
    out[((size_t)(i / M) * n_seg + e) * M + i % M] = narrow<T>(acc);
  }
}

template <typename T>
__global__ void gather_contract_kernel(const T* __restrict__ cot,
                                       const T* __restrict__ a,
                                       const T* __restrict__ b,
                                       const int4* __restrict__ items,
                                       T* __restrict__ da,
                                       T* __restrict__ db,
                                       int n_seg, int S, int M) {
  extern __shared__ float smem[];
  const int Mp = M + 1;
  float* c_s = smem;               // [S][Mp]   the segment's cotangent tile
  float* a_s = c_s + S * Mp;       // [kChunk][S]
  float* b_s = a_s + kChunk * S;   // [kChunk][Mp]
  const int4 item = items[blockIdx.x];  // segment, row0, row1, slot
  const int tid = threadIdx.x;
  if (item.y == item.z) return;  // uniform across the block

  for (int i = tid; i < S * M; i += blockDim.x) {
    const int s = i / M, m = i % M;
    c_s[s * Mp + m] = widen(cot[((size_t)s * n_seg + item.x) * M + m]);
  }
  for (int r = item.y; r < item.z; r += kChunk) {
    const int nr = min(kChunk, item.z - r);
    __syncthreads();  // the cotangent tile is staged / the last chunk consumed
    for (int i = tid; i < nr * S; i += blockDim.x) a_s[i] = widen(a[(size_t)r * S + i]);
    for (int i = tid; i < nr * M; i += blockDim.x) {
      b_s[(i / M) * Mp + i % M] = widen(b[(size_t)r * M + i]);
    }
    __syncthreads();
    for (int i = tid; i < nr * S; i += blockDim.x) {
      const int t = i / S, s = i % S;
      float acc = 0.f;
      for (int m = 0; m < M; ++m) acc += c_s[s * Mp + m] * b_s[t * Mp + m];
      da[(size_t)r * S + i] = narrow<T>(acc);
    }
    for (int i = tid; i < nr * M; i += blockDim.x) {
      const int t = i / M, m = i % M;
      float acc = 0.f;
      for (int s = 0; s < S; ++s) acc += c_s[s * Mp + m] * a_s[t * S + s];
      db[(size_t)r * M + i] = narrow<T>(acc);
    }
  }
}

int outer_sum_threads(int S, int M) {
  int G = (S + kMaxSPerThread - 1) / kMaxSPerThread;
  int want = kThreads / M;
  if (want > S) want = S;
  if (want > G) G = want;
  if (G < 1) G = 1;
  return G * M <= 1024 ? G * M : 0;
}

size_t outer_sum_smem(int S, int M) { return sizeof(float) * (size_t)kChunk * (S + M); }

size_t gather_contract_smem(int S, int M) {
  return sizeof(float) * ((size_t)S * (M + 1) + (size_t)kChunk * (S + M + 1));
}

template <typename T>
int outer_sum(const T* a, const T* b, const int* items, int n_items,
              const int* merge_ptr, const int* merge_seg, int n_merge,
              float* partial, T* out, int n_seg, int S, int M,
              cudaStream_t stream) {
  const int threads = outer_sum_threads(S, M);
  if (threads == 0) return (int)cudaErrorInvalidConfiguration;
  if (n_items > 0) {
    outer_sum_kernel<T><<<n_items, threads, outer_sum_smem(S, M), stream>>>(
        a, b, reinterpret_cast<const int4*>(items), partial, out, n_seg, S, M,
        threads / M);
  }
  if (n_merge > 0) {
    outer_sum_merge_kernel<T><<<n_merge, kThreads, 0, stream>>>(
        partial, merge_ptr, merge_seg, out, n_seg, S, M);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int gather_contract(const T* cot, const T* a, const T* b, const int* items,
                    int n_items, T* da, T* db, int n_seg, int S, int M,
                    cudaStream_t stream) {
  if (n_items > 0) {
    gather_contract_kernel<T><<<n_items, kThreads, gather_contract_smem(S, M), stream>>>(
        cot, a, b, reinterpret_cast<const int4*>(items), da, db, n_seg, S, M);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- K4, split3
//
// K4 forward  gemnet_segment_outer_sum_split3 and backward
// gemnet_segment_gather_contract_split3: K1 and K2 on fp32 streams in the
// 3-pass "split3" mode, on the tensor cores; they replace the split3 branches
// of segment_outer.py::_fwd_kernel (:355-364) and ::_bwd_kernel (:499-513),
// with their staging (:398-404, :557-563, :582-585);
// ModelConfig.matmul_precision = "high".
//
// Arithmetic, as the JAX package's (segment_outer.py:160-202): every fp32
// value x is split into hi = x's bits masked with 0xFFFF0000 (exact in bf16)
// and lo = bf16(x - hi) rounded to nearest even, and every contraction runs
// as hi*hi + hi*lo + lo*hi: bf16 products, exact in fp32, summed in fp32,
// about 16 mantissa bits of the exact fp32 result. Inputs and outputs are
// fp32.
//
// What bounds them: bytes, as K1's and K2's fp32 rows. The forward reads
// exactly K1's fp32 bytes, because the split happens in shared memory (the
// JAX wrapper stages the halves through HBM first); at the quad shape its 3
// passes of 2*n*S*M flops are ~2.7 us of bf16 tensor time against ~24 us of
// bytes. The backward moves K2's fp32 bytes for twice the flops.
//
// Design, the simple first one: K1/K2's work items, one thread block of 8
// warps per item. A chunk of kChunk rows of a (n x S) and b (n x M) is staged
// in shared memory as bf16 hi and lo tiles, S and M padded to multiples of 16
// and the rows to kChunk, every padded entry zero in both halves. The
// products run as nvcuda::wmma 16x16x16 bf16 fragments with fp32
// accumulators:
//   forward:  acc(S x M) += A_hi^T B_hi + A_hi^T B_lo + A_lo^T B_hi, each
//             warp owning up to 4 output tiles across the item's chunks (A^T
//             is a col_major view of the row-major A tile, no transposing
//             copy); the tile is written once, to the output or, for the
//             items of a split segment, to an fp32 partial slot that K1's
//             merge kernel adds in row order (deterministic, no atomics);
//   backward: the segment's (S x M) cotangent tile is split once per item;
//             per chunk, da(rows x S) = B C^T with depth M and
//             db(rows x M) = A C with depth S, each three passes, each output
//             tile written once by the warp that computed it.
// wgmma, TMA and overlap of the next chunk's load with the current chunk's
// products are later work.

typedef __nv_bfloat16 bf16;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

constexpr int kWarps = kThreads / 32;
constexpr int kMaxTilesPerWarp = 4;   // forward accumulator fragments per warp
constexpr int kMaxTiles = kWarps * kMaxTilesPerWarp;
constexpr size_t kMaxSmem = 48 * 1024;  // no opt-in to more

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

__device__ __forceinline__ void split_hi_lo(float x, bf16* hi, bf16* lo) {
  const float h = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  *hi = __float2bfloat16_rn(h);      // exact: h keeps 8 significant bits
  *lo = __float2bfloat16_rn(x - h);  // x - h is exact in fp32
}

// Rows [r, r + nr) of x (row width W, fp32) -> hi/lo tiles [kChunk][Wp],
// zero in rows nr..kChunk and columns W..Wp.
__device__ __forceinline__ void stage_rows(const float* __restrict__ x, int r, int nr,
                                           int W, int Wp, bf16* hi, bf16* lo) {
  for (int i = threadIdx.x; i < kChunk * Wp; i += blockDim.x) {
    const int t = i / Wp, c = i - t * Wp;
    const float v = (t < nr && c < W) ? x[(size_t)(r + t) * W + c] : 0.f;
    split_hi_lo(v, hi + i, lo + i);
  }
}

__global__ void __launch_bounds__(kThreads)
outer_sum_split3_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        const int4* __restrict__ items, float* __restrict__ partial,
                        float* __restrict__ out, int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char tiles[];
  const int Sp = round16(S), Mp = round16(M);
  bf16* a_hi = reinterpret_cast<bf16*>(tiles);  // [kChunk][Sp]
  bf16* a_lo = a_hi + kChunk * Sp;
  bf16* b_hi = a_lo + kChunk * Sp;             // [kChunk][Mp]
  bf16* b_lo = b_hi + kChunk * Mp;
  float* c_s = reinterpret_cast<float*>(b_lo + kChunk * Mp);  // [Sp][Mp]
  const int4 item = items[blockIdx.x];  // segment, row0, row1, slot
  const int warp = threadIdx.x / 32;
  const int tiles_m = Mp / 16;
  const int n_tiles = (Sp / 16) * tiles_m;

  Acc acc[kMaxTilesPerWarp];
#pragma unroll
  for (int j = 0; j < kMaxTilesPerWarp; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int r = item.y; r < item.z; r += kChunk) {
    const int nr = min(kChunk, item.z - r);
    __syncthreads();  // the previous chunk is consumed
    stage_rows(a, r, nr, S, Sp, a_hi, a_lo);
    stage_rows(b, r, nr, M, Mp, b_hi, b_lo);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxTilesPerWarp; ++j) {
      const int tile = warp + j * kWarps;  // warp-uniform
      if (tile < n_tiles) {
        const int s0 = (tile / tiles_m) * 16, m0 = (tile % tiles_m) * 16;
#pragma unroll
        for (int k = 0; k < kChunk; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ah, al;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bh, bl;
          // A^T (s x t): element (s, t) of the row-major [t][Sp] tile
          wmma::load_matrix_sync(ah, a_hi + k * Sp + s0, Sp);
          wmma::load_matrix_sync(al, a_lo + k * Sp + s0, Sp);
          wmma::load_matrix_sync(bh, b_hi + k * Mp + m0, Mp);
          wmma::load_matrix_sync(bl, b_lo + k * Mp + m0, Mp);
          wmma::mma_sync(acc[j], ah, bh, acc[j]);
          wmma::mma_sync(acc[j], ah, bl, acc[j]);
          wmma::mma_sync(acc[j], al, bh, acc[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxTilesPerWarp; ++j) {
    const int tile = warp + j * kWarps;
    if (tile < n_tiles) {
      const int s0 = (tile / tiles_m) * 16, m0 = (tile % tiles_m) * 16;
      wmma::store_matrix_sync(c_s + s0 * Mp + m0, acc[j], Mp, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * M; i += blockDim.x) {
    const int s = i / M, m = i - s * M;
    const float v = c_s[s * Mp + m];
    if (item.w < 0) {
      out[((size_t)s * n_seg + item.x) * M + m] = v;
    } else {
      partial[((size_t)item.w * S + s) * M + m] = v;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gather_contract_split3_kernel(const float* __restrict__ cot, const float* __restrict__ a,
                              const float* __restrict__ b, const int4* __restrict__ items,
                              float* __restrict__ da, float* __restrict__ db,
                              int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char tiles[];
  const int Sp = round16(S), Mp = round16(M);
  bf16* c_hi = reinterpret_cast<bf16*>(tiles);  // [Sp][Mp] the segment's cotangent
  bf16* c_lo = c_hi + Sp * Mp;
  bf16* a_hi = c_lo + Sp * Mp;                 // [kChunk][Sp]
  bf16* a_lo = a_hi + kChunk * Sp;
  bf16* b_hi = a_lo + kChunk * Sp;             // [kChunk][Mp]
  bf16* b_lo = b_hi + kChunk * Mp;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(b_lo + kChunk * Mp) + warp * 256;  // 16x16
  const int4 item = items[blockIdx.x];  // segment, row0, row1, slot
  if (item.y == item.z) return;  // uniform across the block

  for (int i = threadIdx.x; i < Sp * Mp; i += blockDim.x) {
    const int s = i / Mp, m = i - s * Mp;
    const float v = (s < S && m < M) ? cot[((size_t)s * n_seg + item.x) * M + m] : 0.f;
    split_hi_lo(v, c_hi + i, c_lo + i);
  }
  const int tiles_s = Sp / 16, tiles_m = Mp / 16;
  for (int r = item.y; r < item.z; r += kChunk) {
    const int nr = min(kChunk, item.z - r);
    __syncthreads();  // the cotangent tile is staged / the last chunk consumed
    stage_rows(a, r, nr, S, Sp, a_hi, a_lo);
    stage_rows(b, r, nr, M, Mp, b_hi, b_lo);
    __syncthreads();
    const int row_tiles = (nr + 15) / 16;
    const int n_da = row_tiles * tiles_s;
    const int n_tiles = n_da + row_tiles * tiles_m;
    for (int tile = warp; tile < n_tiles; tile += kWarps) {  // warp-uniform
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
      const bool is_da = tile < n_da;
      const int local = is_da ? tile : tile - n_da;
      const int per_row = is_da ? tiles_s : tiles_m;
      const int t0 = (local / per_row) * 16, c0 = (local % per_row) * 16;
      if (is_da) {
        // da[t, s] = sum_m b[t, m] c[s, m]: (ch.bh + ch.bl + cl.bh), depth Mp
        for (int k = 0; k < Mp; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> bh, bl;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> ch, cl;
          wmma::load_matrix_sync(bh, b_hi + t0 * Mp + k, Mp);
          wmma::load_matrix_sync(bl, b_lo + t0 * Mp + k, Mp);
          // C^T (m x s): element (m, s) of the row-major [s][Mp] tile
          wmma::load_matrix_sync(ch, c_hi + c0 * Mp + k, Mp);
          wmma::load_matrix_sync(cl, c_lo + c0 * Mp + k, Mp);
          wmma::mma_sync(acc, bh, ch, acc);
          wmma::mma_sync(acc, bl, ch, acc);
          wmma::mma_sync(acc, bh, cl, acc);
        }
      } else {
        // db[t, m] = sum_s a[t, s] c[s, m]: (ch.ah + ch.al + cl.ah), depth Sp
        for (int k = 0; k < Sp; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah, al;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> ch, cl;
          wmma::load_matrix_sync(ah, a_hi + t0 * Sp + k, Sp);
          wmma::load_matrix_sync(al, a_lo + t0 * Sp + k, Sp);
          wmma::load_matrix_sync(ch, c_hi + k * Mp + c0, Mp);
          wmma::load_matrix_sync(cl, c_lo + k * Mp + c0, Mp);
          wmma::mma_sync(acc, ah, ch, acc);
          wmma::mma_sync(acc, al, ch, acc);
          wmma::mma_sync(acc, ah, cl, acc);
        }
      }
      wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
      __syncwarp();
      const int W = is_da ? S : M;
      float* dst = is_da ? da : db;
      for (int i = lane; i < 256; i += 32) {
        const int t = t0 + i / 16, c = c0 + i % 16;
        if (t < nr && c < W) dst[(size_t)(r + t) * W + c] = scratch[i];
      }
      __syncwarp();  // the scratch tile is read before the next store
    }
  }
}

size_t outer_sum_split3_smem(int S, int M) {
  const int Sp = round16(S), Mp = round16(M);
  if (S < 1 || M < 1 || (Sp / 16) * (Mp / 16) > kMaxTiles) return 0;
  const size_t bytes = 2 * sizeof(bf16) * kChunk * (size_t)(Sp + Mp) +
                       sizeof(float) * (size_t)Sp * Mp;
  return bytes <= kMaxSmem ? bytes : 0;
}

size_t gather_contract_split3_smem(int S, int M) {
  const int Sp = round16(S), Mp = round16(M);
  if (S < 1 || M < 1) return 0;
  const size_t bytes = 2 * sizeof(bf16) * ((size_t)Sp * Mp + kChunk * (size_t)(Sp + Mp)) +
                       sizeof(float) * 256 * kWarps;
  return bytes <= kMaxSmem ? bytes : 0;
}

}  // namespace

extern "C" {

// Shared memory (bytes) each kernel needs, the same for both stream types
// (rows are widened to fp32 in shared memory); the wrapper refuses shapes
// above the 48 KB a block gets without opting in.
size_t gemnet_segment_outer_sum_smem(int S, int M) { return outer_sum_smem(S, M); }

size_t gemnet_segment_gather_contract_smem(int S, int M) {
  return gather_contract_smem(S, M);
}

// Threads per K1 block: G groups of M threads, each group owning at most
// kMaxSPerThread values of s. 0 if no such block fits in 1024 threads.
int gemnet_segment_outer_sum_threads(int S, int M) { return outer_sum_threads(S, M); }

int gemnet_segment_outer_sum_f32(const float* a, const float* b, const int* items,
                                 int n_items, const int* merge_ptr,
                                 const int* merge_seg, int n_merge, float* partial,
                                 float* out, int n_seg, int S, int M,
                                 cudaStream_t stream) {
  return outer_sum<float>(a, b, items, n_items, merge_ptr, merge_seg, n_merge,
                          partial, out, n_seg, S, M, stream);
}

int gemnet_segment_outer_sum_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                  const int* items, int n_items,
                                  const int* merge_ptr, const int* merge_seg,
                                  int n_merge, float* partial, __nv_bfloat16* out,
                                  int n_seg, int S, int M, cudaStream_t stream) {
  return outer_sum<__nv_bfloat16>(a, b, items, n_items, merge_ptr, merge_seg,
                                  n_merge, partial, out, n_seg, S, M, stream);
}

int gemnet_segment_gather_contract_f32(const float* cot, const float* a,
                                       const float* b, const int* items,
                                       int n_items, float* da, float* db,
                                       int n_seg, int S, int M,
                                       cudaStream_t stream) {
  return gather_contract<float>(cot, a, b, items, n_items, da, db, n_seg, S, M, stream);
}

int gemnet_segment_gather_contract_bf16(const __nv_bfloat16* cot,
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, const int* items,
                                        int n_items, __nv_bfloat16* da,
                                        __nv_bfloat16* db, int n_seg, int S,
                                        int M, cudaStream_t stream) {
  return gather_contract<__nv_bfloat16>(cot, a, b, items, n_items, da, db, n_seg,
                                        S, M, stream);
}

// Shared memory (bytes) of each kernel at (S, M); 0 where the kernel takes no
// such shape (more than 48 KB, or more than 32 forward output tiles).
size_t gemnet_segment_outer_sum_split3_smem(int S, int M) { return outer_sum_split3_smem(S, M); }

size_t gemnet_segment_gather_contract_split3_smem(int S, int M) {
  return gather_contract_split3_smem(S, M);
}

int gemnet_segment_outer_sum_split3(const float* a, const float* b, const int* items,
                                    int n_items, const int* merge_ptr, const int* merge_seg,
                                    int n_merge, float* partial, float* out, int n_seg,
                                    int S, int M, cudaStream_t stream) {
  const size_t smem = outer_sum_split3_smem(S, M);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (n_items > 0) {
    outer_sum_split3_kernel<<<n_items, kThreads, smem, stream>>>(
        a, b, reinterpret_cast<const int4*>(items), partial, out, n_seg, S, M);
  }
  if (n_merge > 0) {
    outer_sum_merge_kernel<float><<<n_merge, kThreads, 0, stream>>>(
        partial, merge_ptr, merge_seg, out, n_seg, S, M);
  }
  return (int)cudaGetLastError();
}

int gemnet_segment_gather_contract_split3(const float* cot, const float* a, const float* b,
                                          const int* items, int n_items, float* da,
                                          float* db, int n_seg, int S, int M,
                                          cudaStream_t stream) {
  const size_t smem = gather_contract_split3_smem(S, M);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (n_items > 0) {
    gather_contract_split3_kernel<<<n_items, kThreads, smem, stream>>>(
        cot, a, b, reinterpret_cast<const int4*>(items), da, db, n_seg, S, M);
  }
  return (int)cudaGetLastError();
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
