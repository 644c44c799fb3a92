// Bilinear neighbour reduction of GemNet and its VJP, fp32 and bf16 streams,
// for sm_90a.
//
// K1 gemnet_segment_outer_sum_{f32,bf16}
//     out[s, e, m] = sum_{t : seg(t) = e} a[t, s] * b[t, m]
//   replaces gemnet_pytorch_tpu/ops/pallas/segment_outer.py::_fwd_kernel
//   (launched by _outer_sum_pallas), its non-split3 branch (:366-369): the
//   kernels of the last section at the triplet and the quadruplet shape,
//   the general kernel below at other shapes.
// K2 gemnet_segment_gather_contract_{f32,bf16}
//     da[t, s] = sum_m cot[s, seg(t), m] * b[t, m]
//     db[t, m] = sum_s cot[s, seg(t), m] * a[t, s]
//   replaces segment_outer.py::_bwd_kernel (launched by _gather_contract_pallas).
// K4 gemnet_segment_outer_sum_split3, gemnet_segment_gather_contract_split3
//   K1 and K2 in the fp32 "split3" mode: at the quadruplet shape the ring
//   kernels of the section "K4 at the quadruplet shape" (tensor cores); at
//   the triplet shape K1's warp-per-item kernel with split3 products on the
//   CUDA cores (forward) and a warp-per-item kernel on its ring (backward),
//   both in the last section; the wmma kernels of the section below serve
//   the other shapes.
//
// Stream types follow the JAX package's contract (segment_outer.py:152-157,
// 205-216, 586-590): with fp32 streams everything is fp32; with bf16 streams
// (compute_dtype="bfloat16") the rows, and K2's cotangent, are read as bf16
// (kept as bf16 in shared memory, or widened there to fp32), every product
// and sum is fp32, and the stores round once to bf16: K1's output, K2's da
// and db. K1's partial tiles of a split segment stay fp32 until the merge
// rounds their sum.
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
// Work items, and the merge of a split segment: K1 and K4's forward give
// each item its accumulators in registers; an item of an unsplit segment
// writes the output, the items of a split segment write (S, M) fp32 partial
// tiles, added without atomics in a fixed order. The padded rows of a batch
// all share one segment id (thousands of rows), and items spread such a
// segment over many SMs. K1's kernels are in the last section, K2 has its
// own design in its section below.

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

// ------------------------------------------------ K1, the general kernel
//
// K1 at the shapes the kernels of the last section do not take (narrow
// widths): one thread block per work item; threads own (s, m) output
// elements with the accumulators in registers; a chunk of kChunk rows at a
// time is widened to fp32 in shared memory between two block barriers. The
// items of a split segment write partial tiles that a second kernel,
// outer_sum_merge_kernel (which K4's wmma forward uses too, at the shapes
// neither the warp kernel nor the ring takes), adds in row order.

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

int outer_sum_threads(int S, int M) {
  int G = (S + kMaxSPerThread - 1) / kMaxSPerThread;
  int want = kThreads / M;
  if (want > S) want = S;
  if (want > G) G = want;
  if (G < 1) G = 1;
  return G * M <= 1024 ? G * M : 0;
}

size_t outer_sum_smem(int S, int M) { return sizeof(float) * (size_t)kChunk * (S + M); }

template <typename T>
int outer_sum_general(const T* a, const T* b, const int* items, int n_items,
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
// Design of the kernels below, the simple first one, which serve the shapes
// the faster kernels do not take: shapes the model does not give, and
// tensors that are not 16-byte aligned (at the triplet shape both
// directions are warp-per-item kernels, last section; at the quadruplet
// shape the ring kernels). K1/K2's work items, one thread block of 8 warps
// per item. A chunk of kChunk rows of a (n x S) and b (n x M) is staged in
// shared memory as
// bf16 hi and lo tiles, S and M padded to multiples of 16
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

// ------------------------------------------------------- K2, exact fp32 and bf16
//
// gemnet_segment_gather_contract_{f32,bf16}; the stream contract is the one
// at the top of this file. Three kernels, picked by shape:
//
// 1. S <= 16 and M <= 128 (the triplet shape, S = 7, M = 64, ~8 rows per
//    segment), both stream types: gather_contract_warp_kernel. One warp per
//    piece of kPieceRows consecutive rows, whatever their segments: rows
//    carry their segment id (the sorted ids), so short segments fill every
//    warp and the padded segment spreads over ~200 warps. A lane keeps its
//    columns of the row's cotangent tile (S x ceil(M/32) values) in
//    registers, reloaded when the segment changes; db[t, m] is a lane's own
//    S FMAs, and da[t, s] a reduce-scatter of the lanes' partial dot
//    products across the warp (log2(32) shuffle steps for S' = 8 or 16
//    values). The perm-free row loads are coalesced (b) or broadcast (a).
// 2. fp32, S > 16 (the quad shape, S = 49, M = 32): gather_contract_tiled_kernel.
//    Persistent blocks (as many as the card holds) walk the work items
//    (<= 128 rows of one segment) in chunks of 32 rows through a ring of
//    three shared stages: cp.async copies chunks q + 1 and q + 2 while chunk
//    q computes; an item's (S, M) cotangent tile is copied with its first
//    chunk. a rows (196 bytes at S = 49, so rarely 16-byte aligned) are
//    copied as whole 16-byte pieces of the chunk's contiguous bytes; b rows
//    and the tile by row. Each thread owns a 4 x 4 register tile (4 rows x 4
//    values of s for da, of m for db): 8 shared loads per 64 FMAs, float4s
//    where the layout allows. Rows of a tile are 8 apart and row strides are
//    odd in float4s (or odd in floats), so the 8 threads of a quarter warp
//    read distinct banks or one broadcast address. Exact fp32 on the CUDA
//    cores: the quad shape's 0.6 G FMAs take ~18 us at 67 TFLOP/s, under
//    its 43 us of bytes, so TF32 or split passes would gain nothing.
// 3. bf16, S > 16: gather_contract_mma_kernel, the same blocks, items and
//    ring on the tensor cores: mma.sync m16n8k16, bf16 operands and fp32
//    accumulators (bf16 products are exact in fp32, sums fp32, one rounding
//    at the store). The fragments are read straight from the raw stages
//    (bf16 a rows are 98 bytes at S = 49: pairs of values where aligned,
//    single values otherwise, zero past S and M) and from the cotangent
//    tile, zero-padded to 16 in shared memory; each A fragment serves a
//    row tile's every 8-wide output tile.
// Every output element is written once by one thread; no atomics.

constexpr int kPieceRows = 8;    // rows per warp, warp kernel
constexpr int kTileChunk = 32;   // rows per shared stage, tiled and mma kernels
constexpr int kMmaThreads = 128;
constexpr int kNTiles = 8;       // mma kernel: 8-wide output tiles per A fragment
constexpr int kStages = 3;       // shared stages of rows: one computed, two in flight
constexpr size_t kMaxDynSmem = 227 * 1024;  // a block's shared memory on sm_90
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }
// a row stride (floats) of round4(x) or 4 more, holding an odd number of float4s
__host__ __device__ constexpr int odd_stride4(int x) {
  return (round4(x) / 4) % 2 ? round4(x) : round4(x) + 4;
}
__host__ __device__ constexpr int round32(int x) { return (x + 31) / 32 * 32; }
__host__ __device__ constexpr size_t round128(size_t x) { return (x + 127) / 128 * 128; }

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}
// 16 bytes, of which the first src_bytes are read and the rest zero-filled
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum over the warp of each lane's N values (N a power of two, <= 32),
// returned scattered: every lane ends with the total of value
// (lane >> (5 - log2 N)) & (N - 1). Fixed order, no float atomics.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    const int o = 16 >> l;
    const int n = N >> (l + 1);  // values a lane keeps after this step
    if (n >= 1) {
      const bool upper = lane & o;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        if (k < n) {
          const float send = upper ? v[k] : v[k + n];
          const float keep = upper ? v[k + n] : v[k];
          v[k] = keep + __shfl_xor_sync(kFullMask, send, o);
        }
      }
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], o);
    }
  }
  return v[0];
}

template <int N> __host__ __device__ constexpr int log2_of() {
  if constexpr (N <= 1) {
    return 0;
  } else {
    return 1 + log2_of<N / 2>();
  }
}

template <typename T, int SP, int MPL>
__global__ void __launch_bounds__(kThreads)
gather_contract_warp_kernel(const T* __restrict__ cot, const T* __restrict__ a,
                            const T* __restrict__ b, const long long* __restrict__ seg,
                            T* __restrict__ da, T* __restrict__ db, int n, int n_seg,
                            int S, int M) {
  const int lane = threadIdx.x % 32;
  const int r0 = (blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * kPieceRows;
  if (r0 >= n) return;  // warp-uniform
  const int nr = min(kPieceRows, n - r0);
  const long long my_seg = lane < nr ? seg[r0 + lane] : -1;  // ahead of the row loads
  constexpr int kGroup = 32 / SP;  // lanes that end with the same da value
  constexpr int kShift = log2_of<kGroup>();
  const int s_out = lane >> kShift;
  float c[SP][MPL];
  long long cur = -1;
#pragma unroll 2
  for (int t = 0; t < nr; ++t) {
    const long long e = __shfl_sync(kFullMask, my_seg, t);
    if (e != cur) {  // warp-uniform
      cur = e;
#pragma unroll
      for (int s = 0; s < SP; ++s) {
#pragma unroll
        for (int k = 0; k < MPL; ++k) {
          const int m = lane + 32 * k;
          c[s][k] = (s < S && m < M) ? widen(cot[((size_t)s * n_seg + e) * M + m]) : 0.f;
        }
      }
    }
    const size_t row = (size_t)(r0 + t);
    float bv[MPL], dbv[MPL], part[SP];
#pragma unroll
    for (int k = 0; k < MPL; ++k) {
      const int m = lane + 32 * k;
      bv[k] = m < M ? widen(b[row * M + m]) : 0.f;
      dbv[k] = 0.f;
    }
#pragma unroll
    for (int s = 0; s < SP; ++s) {
      const float av = s < S ? widen(a[row * S + s]) : 0.f;  // one address per warp
      part[s] = 0.f;
#pragma unroll
      for (int k = 0; k < MPL; ++k) {
        dbv[k] = fmaf(c[s][k], av, dbv[k]);
        part[s] = fmaf(c[s][k], bv[k], part[s]);
      }
    }
    const float das = reduce_scatter<SP>(part, lane);
    if (lane % kGroup == 0 && s_out < S) da[row * S + s_out] = narrow<T>(das);
#pragma unroll
    for (int k = 0; k < MPL; ++k) {
      const int m = lane + 32 * k;
      if (m < M) db[row * M + m] = narrow<T>(dbv[k]);
    }
  }
}

// The chunks of kTileChunk rows that one block of the tiled and mma
// kernels computes: those of work items b, b + G, b + 2G, ... (b the block,
// G the grid), in that order, so the padded segment's items spread over the
// grid; empty items have none. `cbuf` picks the cotangent buffer of the
// chunk's item, the next of kStages for each item. The block's next item is
// loaded when it enters an item, so moving on does not wait for memory.
struct ChunkCursor {
  int item, chunk, cbuf;
  int4 it;    // segment, row0, row1, slot
  int4 peek;  // items[item + gridDim.x], where that exists
};

__device__ __forceinline__ ChunkCursor first_cursor(const int4* __restrict__ items,
                                                    int n_items) {
  ChunkCursor c{(int)blockIdx.x - (int)gridDim.x, 0, kStages - 1, make_int4(0, 0, 0, 0),
                make_int4(0, 0, 0, 0)};
  if ((int)blockIdx.x < n_items) c.peek = items[blockIdx.x];
  return c;
}

__device__ __forceinline__ bool next_item(const int4* __restrict__ items, int n_items,
                                          ChunkCursor& c) {
  for (c.item += gridDim.x; c.item < n_items; c.item += gridDim.x) {
    c.it = c.peek;
    if (c.item + (int)gridDim.x < n_items) c.peek = items[c.item + gridDim.x];
    if (c.it.z > c.it.y) {
      c.chunk = 0;
      c.cbuf = c.cbuf + 1 == kStages ? 0 : c.cbuf + 1;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ bool next_chunk(const int4* __restrict__ items, int n_items,
                                           ChunkCursor& c) {
  if ((c.chunk + 1) * kTileChunk < c.it.z - c.it.y) {
    ++c.chunk;
    return true;
  }
  return next_item(items, n_items, c);
}

// The pipeline of both kernels: chunk q computes while chunks q + 1 and
// q + 2 are in flight (cp.async, one commit group per chunk, empty past the
// block's last chunk); `stage(cursor, q)` issues chunk q's copies into
// stage q % kStages, `compute(cursor, q)` consumes it after the barrier.
// The barrier after each compute frees its stage for chunk q + kStages.
template <typename Stage, typename Compute>
__device__ __forceinline__ void run_chunks(const int4* __restrict__ items, int n_items,
                                           Stage stage, Compute compute) {
  static_assert(kStages >= 3, "two chunks in flight beside the one computed");
  ChunkCursor cur = first_cursor(items, n_items);
  if (!next_item(items, n_items, cur)) return;  // uniform across the block
  stage(cur, 0);
  cp_async_commit();
  ChunkCursor n1 = cur;
  bool has1 = next_chunk(items, n_items, n1);
  if (has1) stage(n1, 1);
  cp_async_commit();
  ChunkCursor n2 = n1;
  bool has2 = has1 && next_chunk(items, n_items, n2);
  for (int q = 0;; ++q) {
    if (has2) stage(n2, q + 2);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk q landed
    __syncthreads();
    compute(cur, q);
    __syncthreads();
    if (!has1) break;
    cur = n1;
    n1 = n2;
    has1 = has2;
    if (has2) has2 = next_chunk(items, n_items, n2);
  }
}

// `bytes` bytes from `first` into `raw` as 16-byte copies, from the 16-byte
// boundary at or below `first`, the bytes past the last zero-filled; the
// first byte lands at raw + (address of first mod 16). A chunk of rows is
// contiguous in device memory whatever its rows' alignment.
__device__ __forceinline__ void stage_raw(const void* first, size_t bytes, void* raw) {
  const char* begin = static_cast<const char*>(first);
  const char* end = begin + bytes;
  const char* base = reinterpret_cast<const char*>(reinterpret_cast<size_t>(begin) & ~(size_t)15);
  const int pieces = (int)((end - base + 15) / 16);
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const char* src = base + 16 * i;
    const long long rest = end - src;
    cp_async16(static_cast<char*>(raw) + 16 * i, src, rest < 16 ? (int)rest : 16);
  }
}

// Floats of a tiled-kernel stage of a: a chunk's rows as they lie in device
// memory, from the 16-byte boundary at or below the first.
__host__ __device__ constexpr int tiled_a_floats(int S) { return round4(kTileChunk * S + 8); }

// Shared memory (bytes) of the tiled kernel: kStages cotangent tiles
// [Sp][ldc] and kStages stages of a (flat) and b [kTileChunk][ldb].
size_t tiled_smem(int S, int M) {
  return sizeof(float) * kStages * ((size_t)round4(S) * odd_stride4(M) + tiled_a_floats(S) +
                                    (size_t)kTileChunk * odd_stride4(M));
}

// at most 85 registers a thread: 4 blocks of 192 threads share an SM
__global__ void __launch_bounds__(kThreads, 3)
gather_contract_tiled_kernel(const float* __restrict__ cot, const float* __restrict__ a,
                             const float* __restrict__ b, const int4* __restrict__ items,
                             int n_items, float* __restrict__ da, float* __restrict__ db,
                             int n_seg, int S, int M) {
  extern __shared__ __align__(16) float fsmem[];
  const int Sp = round4(S), Mp = round4(M);
  const int la = tiled_a_floats(S), ldb = odd_stride4(M), ldc = odd_stride4(M);
  float* c_s = fsmem;                               // [kStages][Sp][ldc]
  float* a_s = c_s + kStages * Sp * ldc;            // [kStages][la], rows as in memory
  float* b_s = a_s + kStages * la;                  // [kStages][kTileChunk][ldb]
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  // 16-byte copies of b rows and cotangent rows where M and alignment allow
  const bool b16 = M % 4 == 0 && (reinterpret_cast<size_t>(b) & 15) == 0;   // uniform
  const bool c16 = M % 4 == 0 && (reinterpret_cast<size_t>(cot) & 15) == 0;

  // the padding, which the copies never write, is zero in every buffer:
  // b's columns [M, ldb), the cotangent tiles' rows [S, Sp) and columns
  // [M, ldc); rows by warp, columns by lane
  for (int t = warp; t < kStages * kTileChunk; t += nwarps) {
    for (int k = M + lane; k < ldb; k += 32) b_s[t * ldb + k] = 0.f;
  }
  for (int t = warp; t < kStages * Sp; t += nwarps) {
    const bool pad_row = t % Sp >= S;
    for (int k = pad_row ? lane : M + lane; k < ldc; k += 32) c_s[t * ldc + k] = 0.f;
  }

  // chunk q's rows into stage q % kStages and, for an item's first chunk,
  // its cotangent tile; a as whole 16-byte pieces of its contiguous rows
  // (196 bytes each at S = 49), b and the tile by rows: warp, columns: lane
  auto stage = [&](const ChunkCursor& c, int q) {
    const int r = c.it.y + c.chunk * kTileChunk;
    const int nr = min(kTileChunk, c.it.z - r);
    float* as = a_s + (q % kStages) * la;
    float* bs = b_s + (q % kStages) * kTileChunk * ldb;
    if (c.chunk == 0) {
      float* cs = c_s + c.cbuf * Sp * ldc;
      for (int s = warp; s < S; s += nwarps) {
        const float* src = cot + ((size_t)s * n_seg + c.it.x) * M;
        if (c16) {
          for (int m = 4 * lane; m < M; m += 128) cp_async16(cs + s * ldc + m, src + m, 16);
        } else {
          for (int m = lane; m < M; m += 32) cp_async4(cs + s * ldc + m, src + m);
        }
      }
    }
    stage_raw(a + (size_t)r * S, (size_t)nr * S * sizeof(float), as);
    for (int t = warp; t < nr; t += nwarps) {
      const float* src = b + (size_t)(r + t) * M;
      if (b16) {
        for (int k = 4 * lane; k < M; k += 128) cp_async16(bs + t * ldb + k, src + k, 16);
      } else {
        for (int k = lane; k < M; k += 32) cp_async4(bs + t * ldb + k, src + k);
      }
    }
  };

  const int Q = Sp / 4;                 // a da thread owns s = st + Q*j, j < 4
  const int n_da = 8 * Q, n_da_pad = round32(n_da), n_db = 2 * Mp;
  auto compute = [&](const ChunkCursor& c, int q) {
    const int r0 = c.it.y + c.chunk * kTileChunk;
    // the chunk's first a value, past the bytes below it in the stage
    const float* as = a_s + (q % kStages) * la +
                      (reinterpret_cast<size_t>(a + (size_t)r0 * S) & 15) / sizeof(float);
    const float* bs = b_s + (q % kStages) * kTileChunk * ldb;
    const float* cs = c_s + c.cbuf * Sp * ldc;
    const int r = c.it.y + c.chunk * kTileChunk;
    const int nr = min(kTileChunk, c.it.z - r);
    for (int tile = tid; tile < n_da_pad + n_db; tile += nthr) {  // warp-uniform branch
      const int rt = tile % 8;  // rows rt + 8i, i < 4
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      if (tile < n_da) {
        // da[t, s] = sum_m b[t, m] c[s, m]
        const int st = tile / 8;
        for (int m4 = 0; m4 < Mp; m4 += 4) {
          float4 bv[4], cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            bv[i] = *reinterpret_cast<const float4*>(bs + (rt + 8 * i) * ldb + m4);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            cv[j] = *reinterpret_cast<const float4*>(cs + (st + Q * j) * ldc + m4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(bv[i].x, cv[j].x, acc[i][j]);
              acc[i][j] = fmaf(bv[i].y, cv[j].y, acc[i][j]);
              acc[i][j] = fmaf(bv[i].z, cv[j].z, acc[i][j]);
              acc[i][j] = fmaf(bv[i].w, cv[j].w, acc[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = rt + 8 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = st + Q * j;
            if (t < nr && s < S) da[(size_t)(r + t) * S + s] = acc[i][j];
          }
        }
      } else if (tile >= n_da_pad) {
        // db[t, m] = sum_s a[t, s] c[s, m]; a rows lie S floats apart
        // (odd S: 8 rows in 8 banks), read 4 values of s at a time
        const int m0 = 4 * ((tile - n_da_pad) / 8);
        for (int s4 = 0; s4 < S; s4 += 4) {
          float ak[4][4];
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float* arow = as + (rt + 8 * i) * S + s4;
#pragma unroll
            for (int k = 0; k < 4; ++k) ak[i][k] = s4 + k < S ? arow[k] : 0.f;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
            cv[k] = *reinterpret_cast<const float4*>(cs + (s4 + k) * ldc + m0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              acc[i][0] = fmaf(ak[i][k], cv[k].x, acc[i][0]);
              acc[i][1] = fmaf(ak[i][k], cv[k].y, acc[i][1]);
              acc[i][2] = fmaf(ak[i][k], cv[k].z, acc[i][2]);
              acc[i][3] = fmaf(ak[i][k], cv[k].w, acc[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = rt + 8 * i;
          if (t < nr) {
            float* dst = db + (size_t)(r + t) * M + m0;
            if (m0 + 3 < M && b16) {
              *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2],
                                                            acc[i][3]);
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                if (m0 + k < M) dst[k] = acc[i][k];
              }
            }
          }
        }
      }
    }
  };
  run_chunks(items, n_items, stage, compute);
}

// Shared memory (bytes) of the mma kernel: per stage, the bf16 cotangent
// tile [Sp][ldc] (Sp = S, Mp = M rounded up to 16, zero beyond S and M) and
// the raw bytes of the chunk's a and b rows.
struct MmaSmem {
  int Sp, Mp, ldc;
  size_t c, raw_a, raw_b, stage, total;
};

__host__ __device__ inline MmaSmem mma_smem(int S, int M) {
  MmaSmem L;
  L.Sp = round16(S);
  L.Mp = round16(M);
  L.ldc = L.Mp + 8;  // 16 bytes past a multiple of 32: rows fall in other banks
  L.c = round128(sizeof(bf16) * (size_t)L.Sp * L.ldc);
  L.raw_a = round128(sizeof(bf16) * (size_t)kTileChunk * S + 32);
  L.raw_b = round128(sizeof(bf16) * (size_t)kTileChunk * M + 32);
  L.stage = L.c + L.raw_a + L.raw_b;
  L.total = kStages * L.stage;
  return L;
}

__device__ __forceinline__ unsigned bf16_pair(bf16 lo, bf16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// Two consecutive bf16 values at p, one 32-bit load where p is 4-byte
// aligned; a value at or past `valid` reads as zero.
__device__ __forceinline__ unsigned ld_pair(const bf16* p, bool aligned, int valid) {
  if (aligned && valid >= 2) return *reinterpret_cast<const unsigned*>(p);
  const bf16 zero = __float2bfloat16_rn(0.f);
  return bf16_pair(valid > 0 ? p[0] : zero, valid > 1 ? p[1] : zero);
}

// D (16 x 8, fp32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kMmaThreads)
gather_contract_mma_kernel(const bf16* __restrict__ cot, const bf16* __restrict__ a,
                           const bf16* __restrict__ b, const int4* __restrict__ items,
                           int n_items, bf16* __restrict__ da, bf16* __restrict__ db,
                           int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char bsmem[];
  const MmaSmem L = mma_smem(S, M);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const int g = lane >> 2, tig = lane & 3;  // the mma fragments' row group and column pair
  const bf16 zero = __float2bfloat16_rn(0.f);
  // cotangent rows copied as bf16 pairs where M is even and cot 4-byte aligned
  const bool c4 = M % 2 == 0 && (reinterpret_cast<size_t>(cot) & 3) == 0;  // uniform
  const int c_elems = (int)(L.c / sizeof(bf16));
  auto c_tile = [&](int k) { return reinterpret_cast<bf16*>(bsmem + k * L.stage); };
  auto raw_a = [&](int q) { return bsmem + (q % kStages) * L.stage + L.c; };
  auto raw_b = [&](int q) { return raw_a(q) + L.raw_a; };

  // each stage's cotangent tile is zero in rows [S, Sp) and columns [M, ldc)
  for (int i = warp; i < kStages * L.Sp; i += nwarps) {
    const int k = i / L.Sp, t = i - k * L.Sp;
    bf16* row = c_tile(k) + t * L.ldc;
    for (int m = t >= S ? lane : M + lane; m < L.ldc; m += 32) row[m] = zero;
  }

  // chunk q's a and b rows into stage q % kStages as raw bytes, and for an
  // item's first chunk its cotangent tile into the tile of stage c.cbuf
  auto stage = [&](const ChunkCursor& c, int q) {
    const int r = c.it.y + c.chunk * kTileChunk;
    const int nr = min(kTileChunk, c.it.z - r);
    if (c.chunk == 0) {
      bf16* cs = c_tile(c.cbuf);
      for (int s = warp; s < S; s += nwarps) {
        const bf16* src = cot + ((size_t)s * n_seg + c.it.x) * M;
        if (c4) {
          for (int m = 2 * lane; m < M; m += 64) cp_async4(cs + s * L.ldc + m, src + m);
        } else {  // visible after the barrier that precedes this item's first chunk
          for (int m = lane; m < M; m += 32) cs[s * L.ldc + m] = src[m];
        }
      }
    }
    stage_raw(a + (size_t)r * S, sizeof(bf16) * (size_t)nr * S, raw_a(q));
    stage_raw(b + (size_t)r * M, sizeof(bf16) * (size_t)nr * M, raw_b(q));
  };

  const int nt_s = (S + 7) / 8, nt_m = (M + 7) / 8;  // 8-wide output tiles
  auto compute = [&](const ChunkCursor& c, int q) {
    const int r = c.it.y + c.chunk * kTileChunk;
    const int nr = min(kTileChunk, c.it.z - r);
    // the chunk's first a and b values, past the bytes below them in the stage
    const size_t ha = (reinterpret_cast<size_t>(a + (size_t)r * S) & 15) / sizeof(bf16);
    const size_t hb = (reinterpret_cast<size_t>(b + (size_t)r * M) & 15) / sizeof(bf16);
    const bf16* as = reinterpret_cast<const bf16*>(raw_a(q)) + ha;
    const bf16* bs = reinterpret_cast<const bf16*>(raw_b(q)) + hb;
    const bf16* cs = c_tile(c.cbuf);
    const bool a_al = S % 2 == 0 && ha % 2 == 0, b_al = M % 2 == 0 && hb % 2 == 0;
    const int row_tiles = (nr + 15) / 16;
    // a warp's job: 16 rows of da (A = b rows, depth M) or of db (A = a
    // rows, depth S), up to kNTiles 8-wide output tiles at a time, so each A
    // fragment is loaded once per k-step for all of them
    for (int job = warp; job < 2 * row_tiles; job += nwarps) {  // warp-uniform
      const bool is_da = job < row_tiles;
      const int t0 = (is_da ? job : job - row_tiles) * 16;
      const bf16* x0 = is_da ? bs + (t0 + g) * M : as + (t0 + g) * S;
      const int W = is_da ? S : M, depth = is_da ? M : S;
      const int x_stride = is_da ? M : S;
      const bool x_al = is_da ? b_al : a_al;
      const int kp = is_da ? L.Mp : L.Sp, nt = is_da ? nt_s : nt_m;
      bf16* dst = is_da ? da : db;
      for (int nb = 0; nb < nt; nb += kNTiles) {
        float d[kNTiles][4];
#pragma unroll
        for (int u = 0; u < kNTiles; ++u) d[u][0] = d[u][1] = d[u][2] = d[u][3] = 0.f;
        for (int k = 0; k < kp; k += 16) {
          const int k0 = k + 2 * tig, k8 = k0 + 8;
          unsigned af[4];
          af[0] = ld_pair(x0 + k0, x_al, depth - k0);
          af[1] = ld_pair(x0 + 8 * x_stride + k0, x_al, depth - k0);
          af[2] = ld_pair(x0 + k8, x_al, depth - k8);
          af[3] = ld_pair(x0 + 8 * x_stride + k8, x_al, depth - k8);
#pragma unroll
          for (int u = 0; u < kNTiles; ++u) {
            const int n = (nb + u) * 8 + g;  // this lane's output column of tile u
            if (nb + u < nt) {
              unsigned bfr[2];
              if (is_da) {  // B(k=m, n=s) = c[s][m]: pairs along a tile row
                const bf16* crow = cs + n * L.ldc;
                bfr[0] = *reinterpret_cast<const unsigned*>(crow + k0);
                bfr[1] = *reinterpret_cast<const unsigned*>(crow + k8);
              } else {      // B(k=s, n=m) = c[s][m]: pairs down a tile column
                const bf16* ccol = cs + n;
                bfr[0] = bf16_pair(ccol[k0 * L.ldc], ccol[(k0 + 1) * L.ldc]);
                bfr[1] = bf16_pair(ccol[k8 * L.ldc], ccol[(k8 + 1) * L.ldc]);
              }
              mma_bf16(d[u], af, bfr);
            }
          }
        }
        // d[u][0..1]: row t0 + g, columns 2 tig (+1) of tile u; d[u][2..3]: row t0 + g + 8
#pragma unroll
        for (int u = 0; u < kNTiles; ++u) {
          const int col = (nb + u) * 8 + 2 * tig;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int t = t0 + g + 8 * h;
            if (nb + u < nt && t < nr) {
              bf16* out = dst + (size_t)(r + t) * W + col;
              if (col < W) out[0] = __float2bfloat16_rn(d[u][2 * h]);
              if (col + 1 < W) out[1] = __float2bfloat16_rn(d[u][2 * h + 1]);
            }
          }
        }
      }
    }
  };
  run_chunks(items, n_items, stage, compute);
}

// Blocks of a persistent kernel: as many as the card holds at once, at most
// one per work item. The first launch of a kernel at a shape (an eager one,
// never one captured into a CUDA graph) lets it take the most shared memory
// any of its shapes so far asked for, at least `smem` bytes (so a launch at
// an earlier, larger shape still may), and asks the occupancy; later
// launches reuse the answer.
template <typename Kernel>
int persistent_blocks(Kernel kernel, int threads, size_t smem, int n_items) {
  struct Entry { const void* kernel; int threads; size_t smem; int blocks; };
  static Entry cache[16];
  static int n_cached = 0;
  int blocks = 0;
  size_t most = smem;
  for (int i = 0; i < n_cached; ++i) {
    const Entry& e = cache[i];
    if (e.kernel != (const void*)kernel) continue;
    if (e.threads == threads && e.smem == smem) blocks = e.blocks;
    if (e.smem > most) most = e.smem;
  }
  if (blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    blocks = sms * (per_sm > 0 ? per_sm : 1);
    if (n_cached < 16) cache[n_cached++] = Entry{(const void*)kernel, threads, smem, blocks};
  }
  return blocks < n_items ? blocks : n_items;
}

bool warp_shape(int S, int M) { return S >= 1 && S <= 16 && M >= 1 && M <= 128; }

template <typename T, int SP>
void launch_warp(const T* cot, const T* a, const T* b, const long long* seg, T* da, T* db,
                 int n, int n_seg, int S, int M, cudaStream_t stream) {
  const int warps = (n + kPieceRows - 1) / kPieceRows;
  const unsigned blocks = (unsigned)((warps + kThreads / 32 - 1) / (kThreads / 32));
  switch ((M + 31) / 32) {
    case 1:
      gather_contract_warp_kernel<T, SP, 1><<<blocks, kThreads, 0, stream>>>(
          cot, a, b, seg, da, db, n, n_seg, S, M);
      break;
    case 2:
      gather_contract_warp_kernel<T, SP, 2><<<blocks, kThreads, 0, stream>>>(
          cot, a, b, seg, da, db, n, n_seg, S, M);
      break;
    case 3:
      gather_contract_warp_kernel<T, SP, 3><<<blocks, kThreads, 0, stream>>>(
          cot, a, b, seg, da, db, n, n_seg, S, M);
      break;
    default:
      gather_contract_warp_kernel<T, SP, 4><<<blocks, kThreads, 0, stream>>>(
          cot, a, b, seg, da, db, n, n_seg, S, M);
  }
}

// Shared memory (bytes) K2 takes at (S, M) in either stream type; 0 where
// the warp kernel runs it.
size_t gather_contract_smem(int S, int M) {
  if (warp_shape(S, M)) return 0;
  const size_t f = tiled_smem(S, M), h = mma_smem(S, M).total;
  return f > h ? f : h;
}

template <typename T>
int gather_contract(const T* cot, const T* a, const T* b, const long long* seg,
                    const int* items, int n_items, T* da, T* db, int n, int n_seg, int S,
                    int M, cudaStream_t stream) {
  if (S < 1 || M < 1 || gather_contract_smem(S, M) > kMaxDynSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (n <= 0) return (int)cudaGetLastError();
  if (warp_shape(S, M)) {
    if (S <= 8) {
      launch_warp<T, 8>(cot, a, b, seg, da, db, n, n_seg, S, M, stream);
    } else {
      launch_warp<T, 16>(cot, a, b, seg, da, db, n, n_seg, S, M, stream);
    }
  } else if (n_items > 0) {
    const int4* it = reinterpret_cast<const int4*>(items);
    if constexpr (sizeof(T) == 4) {
      const int tiles = round32(round32(8 * (round4(S) / 4)) + 2 * round4(M));
      const int threads = tiles < kThreads ? tiles : kThreads;
      const size_t smem = tiled_smem(S, M);
      const int blocks = persistent_blocks(gather_contract_tiled_kernel, threads, smem, n_items);
      gather_contract_tiled_kernel<<<blocks, threads, smem, stream>>>(
          cot, a, b, it, n_items, da, db, n_seg, S, M);
    } else {
      const size_t smem = mma_smem(S, M).total;
      const int blocks = persistent_blocks(gather_contract_mma_kernel, kMmaThreads, smem, n_items);
      gather_contract_mma_kernel<<<blocks, kMmaThreads, smem, stream>>>(
          cot, a, b, it, n_items, da, db, n_seg, S, M);
    }
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------- K4 at the quadruplet shape: the ring
//
// outer_sum_split3_ring (forward) and gather_contract_split3_ring (backward)
// replace the split3 branches of segment_outer.py::_fwd_kernel (:355-364,
// staging :398-404) and ::_bwd_kernel (:499-513, staging :557-563,
// :582-585) where 16 < S <= 64, M <= 32, M % 4 == 0 and the row, cotangent
// and output tensors are 16-byte aligned (the quadruplet shape, S = 49,
// M = 32, as the model gives it); other shapes keep the kernels above.
// The forward's body (outer_sum_mma_body) and the producer (ring_produce)
// also serve K1 at this shape (last section).
//
// What bounds them on an H100: bytes. The forward reads a and b once and
// writes the (S, nSeg, M) output once: 81.7 MB at the bench quad shape (192
// 512 rows, 3072 segments), 24 us at 3.35 TB/s; its three bf16 passes are
// 3 * 2 * n * S * M = 1.8 GFLOP, ~2 us of tensor time. The backward reads a,
// b and the cotangent and writes da and db: 144 MB, 43 us, for 3.6 GFLOP.
//
// Design, per block: one producer warp and four consumer warps, persistent
// blocks walking the work items (<= 128 rows of one segment; block b takes
// items b, b + G, b + 2G, ... of the grid's G, in row order) in chunks of
// kRingRows rows through a ring of kRingStages shared stages. Full and
// empty mbarriers hand each stage over; no block-wide barrier runs after
// the set-up, so the copies never wait for the math.
// - The producer copies a chunk's a rows (contiguous in device memory) as
//   one bulk copy (TMA, cp.async.bulk ... complete_tx) from the 16-byte
//   boundary at or below the first byte, clamped to the last 16-byte
//   boundary of the tensor (the tail, <= 3 floats, by a plain load); the
//   forward copies each b row as its own bulk copy, into rows ldb floats
//   apart, the backward the chunk's b rows as one; the backward's first
//   chunk of an item also copies the item's (S x M) cotangent rows.
//   Little's law: the card's 3.35 TB/s over 132 SMs at ~1 us of latency
//   asks ~25 KB in flight per SM. A stage holds ~10.4 KB of rows (S = 49,
//   M = 32), so a block keeps three stages in flight while one computes,
//   ~31 KB, and as many blocks as fit (at least two) share an SM.
// - The stages hold raw fp32 rows. A consumer builds each mma.sync m16n8k16
//   bf16 fragment from them in registers: hi is x's bits masked with
//   0xFFFF0000, lo = bf16_rn(x - hi), bit for bit split_hi_lo; the passes
//   hi*hi + hi*lo + lo*hi accumulate in fp32. Only fragments are zero past
//   S and M; no bf16 tile and no padded column is stored.
// - Bank conflicts: the fragment reads of a rows fall in 32 distinct banks
//   (rows S floats apart, S odd, and the s values picked to match: s_sel
//   and consume_db below), and so do the forward's reads of b rows (ldb = 4
//   mod 16). The backward reads b rows M floats apart, four rows to a bank:
//   one bulk copy per chunk in place of 32 measured faster (PERF.md §6).
// - Forward: each consumer warp owns 16 values of s and all M columns, its
//   accumulators in registers across the item's chunks (rows are the
//   contraction, in the natural order). At the item's end the warp writes
//   its 16 output rows of M floats whole, as 16-byte stores, to the output
//   or, for an item of a split segment, to its partial slot. A split
//   segment's partials are added through the plan's merge tree
//   (data/batch.py::merge_tree): the last child of a node to arrive (the
//   consumer warps' barrier, then one release-acquire atomic count in
//   tree_arrivals) adds its <= 16 children in slot order and resets the
//   count, so no block adds more than 16 tiles in sequence, the order is
//   fixed and a captured graph replays.
// - Backward: an item is one segment and each consumer warp keeps one role
//   for it: da (two warps, 16 rows each, depth M, N = S) holding the C^T
//   hi/lo fragments in 64 registers, or db (two warps, depth S, N = M)
//   holding C's. A warp stages its 16 output rows in shared memory as they
//   lie in device memory and writes them as 16-byte stores, the ragged head
//   and tail plainly.

constexpr int kRingStages = 4;
constexpr int kRingRows = 32;
constexpr int kConsumerWarps = 4;
constexpr int kRingThreads = 32 * (kConsumerWarps + 1);  // the producer is the last warp
constexpr int kRingMaxS = 64, kRingMaxM = 32;
constexpr int kMergeFan = 16;  // data/batch.py::MERGE_FAN
constexpr int kFirstChunk = 1, kLastChunk = 2, kEndOfWork = 4;
constexpr int kRingHeader = 256;  // bytes: barriers, descriptors, the merge flag

// the smallest y >= x with y % 16 == r (x, r multiples of 4)
__host__ __device__ constexpr int stride_mod16(int x, int r) {
  return x + ((r - x % 16) + 16) % 16;
}
// the 16-byte boundary at or below p
__device__ __forceinline__ const char* floor16(const void* p) {
  return reinterpret_cast<const char*>(reinterpret_cast<size_t>(p) & ~(size_t)15);
}
// values from the 16-byte boundary at or below p to p: where a chunk's
// first value lands in its stage
template <typename T> __device__ __forceinline__ int head_floats(const T* p) {
  return (int)((reinterpret_cast<size_t>(p) & 15) / sizeof(T));
}

struct RingSmem {
  int la, ldb, lc, lo;  // 4-byte words: a rows, b row stride, cotangent tile, a warp's scratch
  size_t stage, total;  // bytes
};

// The kernels on the ring: K4's forward and backward, and K1's fp32
// (FFMA) and bf16 (mma) forward
enum RingKind { kRingSplit3Fwd, kRingSplit3Bwd, kRingFfma, kRingMma };

__host__ __device__ inline RingSmem ring_smem(int S, int M, RingKind kind) {
  RingSmem L;
  const bool backward = kind == kRingSplit3Bwd;
  if (kind == kRingMma) {  // bf16 rows: head (<= 7 values) and reads past S
    L.la = round4((kRingRows * S + kRingMaxS + 9) / 2);
    L.ldb = stride_mod16(M / 2, 4);  // rows 80 bytes apart at M = 32
  } else {                 // fp32 rows: head (<= 3 floats) and reads past S
    L.la = round4(kRingRows * S + 4 + kRingMaxS);
    L.ldb = kind == kRingSplit3Fwd ? stride_mod16(M, 4) : M;
  }
  L.lc = backward ? kRingMaxS * M : 0;
  if (kind == kRingFfma) {
    L.lo = round4(S * (M + 4));  // the warp's whole (S, M) tile, rows M + 4 floats apart
  } else {
    L.lo = backward ? round4(16 * (S > M ? S : M) + 4) : 16 * stride_mod16(M, 8);
  }
  L.stage = sizeof(float) * (size_t)(L.la + kRingRows * L.ldb + L.lc);
  L.total = kRingHeader + kRingStages * L.stage + sizeof(float) * kConsumerWarps * (size_t)L.lo;
  return L;
}

bool ring_shape(int S, int M) {
  return S > 16 && S <= kRingMaxS && M >= 4 && M <= kRingMaxM && M % 4 == 0;
}

// bf16 rows on the ring: each b row a whole number of 16-byte pieces
bool mma_ring_shape(int S, int M) { return ring_shape(S, M) && M % 8 == 0; }

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

struct ChunkDesc {  // one stage's chunk, written by the producer
  int r, nr, flags, seg;
  int slot, pad0, pad1, pad2;
};

struct Ring {
  unsigned long long* full;   // [kRingStages]
  unsigned long long* empty;  // [kRingStages]
  ChunkDesc* desc;            // [kRingStages]
  int* flag;                  // the merge's broadcast
  unsigned char* stages;
  float* scratch;
  RingSmem L;

  __device__ Ring(unsigned char* smem, int S, int M, RingKind kind) {
    full = reinterpret_cast<unsigned long long*>(smem);
    empty = full + kRingStages;
    desc = reinterpret_cast<ChunkDesc*>(empty + kRingStages);
    flag = reinterpret_cast<int*>(desc + kRingStages);
    L = ring_smem(S, M, kind);
    stages = smem + kRingHeader;
    scratch = reinterpret_cast<float*>(stages + kRingStages * L.stage);
  }
  __device__ float* a(int st) const { return reinterpret_cast<float*>(stages + st * L.stage); }
  __device__ float* b(int st) const { return a(st) + L.la; }
  __device__ float* c(int st) const { return b(st) + kRingRows * L.ldb; }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}
// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
// *p += v at device scope, release and acquire; returns the old value
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}
// the consumer warps' own barrier (named barrier 1), never the producer's
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// fp32 x0, x1 -> the bf16 pairs (hi0 | hi1 << 16) and (lo0 | lo1 << 16),
// bit for bit split_hi_lo
__device__ __forceinline__ void split_pair(float x0, float x1, unsigned& hi, unsigned& lo) {
  const unsigned u0 = __float_as_uint(x0), u1 = __float_as_uint(x1);
  hi = __byte_perm(u0, u1, 0x7632);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __uint_as_float(u0 & 0xFFFF0000u),
                                                 x1 - __uint_as_float(u1 & 0xFFFF0000u));
  lo = (unsigned)__bfloat16_as_ushort(l.x) | ((unsigned)__bfloat16_as_ushort(l.y) << 16);
}

// D += A_hi B_hi + A_hi B_lo + A_lo B_hi
__device__ __forceinline__ void mma_split3(float (&d)[4], const unsigned (&ah)[4],
                                           const unsigned (&al)[4], const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_bf16(d, ah, bh);
  mma_bf16(d, ah, bl);
  mma_bf16(d, al, bh);
}

// The producer warp: the block's chunks in the consumers' order, each into
// the next free stage with its descriptor; then a descriptor kEndOfWork.
// Forward: every item (an empty one writes zeros); backward: the items with
// rows. kRowB: each b row its own bulk copy, R.L.ldb words from the last;
// else the chunk's b rows as they lie in memory, one bulk copy. T: the
// rows' type (fp32, or bf16 for K1's bf16 streams), copied as it is.
template <typename T, bool kBackward, bool kRowB>
__device__ void ring_produce(const Ring& R, const T* __restrict__ a, const T* __restrict__ b,
                            const T* __restrict__ cot, const int4* __restrict__ items,
                            int n_items, int n, int n_seg, int S, int M) {
  const int lane = threadIdx.x % 32;
  const char* a_end = reinterpret_cast<const char*>(a + (size_t)n * S);
  const char* a_end16 = floor16(a_end);
  const unsigned row_bytes = (unsigned)(M * sizeof(T));
  int q = 0;
  auto acquire = [&]() {
    const int st = q % kRingStages;
    mbar_wait(R.empty + st, ((q / kRingStages) & 1) ^ 1);
    return st;
  };
  // items b, b + G, b + 2G, ... (b the block, G the grid), in that order;
  // the next one is loaded when the block enters an item, so moving on does
  // not wait for memory
  auto item = [&](int k) { return k < n_items ? items[k] : make_int4(0, 0, 0, 0); };
  int4 next = item(blockIdx.x);
  for (int k = blockIdx.x; k < n_items; k += gridDim.x) {
    const int4 it = next;  // segment, row0, row1, slot
    next = item(k + gridDim.x);
    const int len = it.z - it.y;
    if (kBackward && len == 0) continue;  // no rows, nothing to write
    for (int c = 0; c == 0 || c * kRingRows < len; ++c, ++q) {
      const int st = acquire();
      const int r = it.y + c * kRingRows;
      const int nr = min(kRingRows, len - c * kRingRows);
      const bool first = c == 0;
      const char* lo = reinterpret_cast<const char*>(a + (size_t)r * S);
      const char* hi = lo + (size_t)nr * S * sizeof(T);
      const char* base = floor16(lo);
      const char* stop = floor16(hi + 15);
      if (stop > a_end) stop = a_end16;  // no byte past the tensor
      const unsigned a_bytes = nr > 0 ? (unsigned)(stop - base) : 0u;
      char* as = reinterpret_cast<char*>(R.a(st));
      if (lane == 0) {
        ChunkDesc& d = R.desc[st];
        d.r = r;
        d.nr = nr;
        d.flags = (first ? kFirstChunk : 0) | ((c + 1) * kRingRows >= len ? kLastChunk : 0);
        d.seg = it.x;
        d.slot = it.w;
        if (nr > 0 && stop < hi) {  // the tail past the tensor's last 16-byte boundary
          for (const char* p = stop; p < hi; p += sizeof(T)) {
            *reinterpret_cast<T*>(as + (p - base)) = *reinterpret_cast<const T*>(p);
          }
          // these plain writes precede any later bulk copy into the stage
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        const unsigned tx = a_bytes + (unsigned)nr * row_bytes +
                            (kBackward && first ? (unsigned)S * row_bytes : 0u);
        mbar_arrive_expect_tx(R.full + st, tx);
      }
      __syncwarp();
      if (lane == 0 && a_bytes > 0) bulk_copy(as, base, a_bytes, R.full + st);
      float* bs = R.b(st);
      if (!kRowB) {  // the chunk's b rows as they lie in memory
        if (lane == 0 && nr > 0) bulk_copy(bs, b + (size_t)r * M, nr * row_bytes, R.full + st);
      } else {  // each row ldb words from the last
        for (int t = lane; t < nr; t += 32) {
          bulk_copy(bs + t * R.L.ldb, b + (size_t)(r + t) * M, row_bytes, R.full + st);
        }
      }
      if (kBackward && first) {
        float* cs = R.c(st);
        for (int s = lane; s < S; s += 32) {
          bulk_copy(cs + s * M, cot + ((size_t)s * n_seg + it.x) * M, row_bytes, R.full + st);
        }
      }
    }
  }
  const int st = acquire();
  if (lane == 0) {
    R.desc[st].flags = kEndOfWork;
    mbar_arrive(R.full + st);
  }
}

// The forward consumer warp w's s values: fragment row g (hf = 0) or g + 8
// (hf = 1) is s = 32 (w / 2) + 4 (w % 2) + 8 (g / 2) + g % 2 + 2 hf. With a
// rows S (odd) floats apart, the 8 values of g and the 4 rows 2 tig of one
// fragment read fall in 32 distinct banks.
__device__ __forceinline__ int s_sel(int w, int hf, int g) {
  return 32 * (w >> 1) + 4 * (w & 1) + 8 * (g >> 1) + (g & 1) + 2 * hf;
}

// four fp32 values to p: 16 bytes, or 8 bytes of bf16 rounded once
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}

// Node nd = {first child slot, end slot, out slot, segment} of a merge
// tree: its children's (S, M) fp32 tiles (TS floats, a multiple of 4)
// added in slot order into slot `out`, or into the output of `segment`
// (rounded once to T) where out is -1. Thread tid of nthreads takes kVec
// groups of 4 floats at a time, the loads of all children and all kVec
// groups in flight together: each round of loads costs a latency, so a
// merge by few threads (one warp) takes kVec = 2.
template <int kVec, typename T>
__device__ __forceinline__ void merge_node(int4 nd, float* __restrict__ partial,
                                           T* __restrict__ out, int n_seg, int TS, int M,
                                           int tid, int nthreads) {
  for (int i0 = 4 * tid; i0 < TS; i0 += 4 * nthreads * kVec) {
    float4 v[kMergeFan][kVec];
#pragma unroll
    for (int u = 0; u < kMergeFan; ++u) {
#pragma unroll
      for (int h = 0; h < kVec; ++h) {
        const int i = i0 + 4 * nthreads * h;
        const float* src = partial + (size_t)(nd.x + u) * TS + i;
        v[u][h] = nd.x + u < nd.y && i < TS ? __ldcg(reinterpret_cast<const float4*>(src))
                                            : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int h = 0; h < kVec; ++h) {
      const int i = i0 + 4 * nthreads * h;
      float4 acc = v[0][h];
#pragma unroll
      for (int u = 1; u < kMergeFan; ++u) {
        if (nd.x + u < nd.y) {
          acc.x += v[u][h].x;
          acc.y += v[u][h].y;
          acc.z += v[u][h].z;
          acc.w += v[u][h].w;
        }
      }
      if (i < TS) {
        if (nd.z >= 0) {
          store4(partial + (size_t)nd.z * TS + i, acc);
        } else {
          store4(out + ((size_t)(i / M) * n_seg + nd.w) * M + i % M, acc);
        }
      }
    }
  }
}

// Adds the partial tile of `slot` into its merge-tree node if it is the
// node's last child to arrive, then goes on up the tree; the four consumer
// warps together (each has fenced its own stores of the slot's tile). The
// root rounds to the output's type T once.
template <int kVec, typename T>
__device__ void merge_up(const Ring& R, int slot, const int4* __restrict__ tree_nodes,
                         const int* __restrict__ tree_parent, int* __restrict__ tree_arrivals,
                         float* __restrict__ partial, T* __restrict__ out, int n_seg, int S,
                         int M) {
  const int tid = threadIdx.x;  // 0 .. 32 * kConsumerWarps - 1
  const int TS = S * M;         // floats of a tile, a multiple of 4
  for (;;) {
    consumer_sync();  // every warp has stored its rows of `slot`
    if (tid == 0) {
      const int node = tree_parent[slot];
      const int4 nd = tree_nodes[node];
      // release: the block's stores of `slot` (ordered before by the barrier)
      // are visible to the child that arrives last; acquire: so are theirs
      const int prev = atomic_add_acq_rel(tree_arrivals + node, 1);
      *R.flag = prev == nd.y - nd.x - 1 ? node : -1;
    }
    consumer_sync();
    const int node = *reinterpret_cast<volatile int*>(R.flag);
    if (node < 0) return;
    const int4 nd = tree_nodes[node];
    merge_node<kVec>(nd, partial, out, n_seg, TS, M, tid, 32 * kConsumerWarps);
    if (tid == 0) tree_arrivals[node] = 0;  // for the next launch
    if (nd.z < 0) return;
    slot = nd.z;
  }
}

// Two consecutive rows' values of one column, t and t + 1, as a bf16 pair
// (the fragment's k pair); rows at or past nr read as zero.
__device__ __forceinline__ unsigned col_pair(const bf16* p, int stride, int t, int nr) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  return bf16_pair(t < nr ? p[t * stride] : zero, t + 1 < nr ? p[(t + 1) * stride] : zero);
}

// The ring forward on the tensor cores, one consumer warp per 16 values of
// s (s_sel) and all M columns. T = float: K4, fp32 rows split into bf16 hi
// and lo in registers, three products; T = bf16: K1 on bf16 streams, the
// bf16 rows as they are, one product. fp32 accumulators in both; the
// output rounds once to T.
template <typename T>
__device__ __forceinline__ void outer_sum_mma_body(
    const T* __restrict__ a, const T* __restrict__ b, const int4* __restrict__ items,
    int n_items, const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
    int* __restrict__ tree_arrivals, float* __restrict__ partial, T* __restrict__ out, int n,
    int n_seg, int S, int M) {
  constexpr bool kSplit3 = sizeof(T) == sizeof(float);
  extern __shared__ __align__(128) unsigned char ring_smem_raw[];
  const Ring R(ring_smem_raw, S, M, kSplit3 ? kRingSplit3Fwd : kRingMma);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      mbar_init(R.full + i, 1);
      mbar_init(R.empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (warp == kConsumerWarps) {
    ring_produce<T, false, true>(R, a, b, nullptr, items, n_items, n, n_seg, S, M);
    return;
  }
  const int g = lane >> 2, tig = lane & 3;
  const int ldb = R.L.ldb * (int)(sizeof(float) / sizeof(T));  // in values of T
  const bool active = s_sel(warp, 0, 0) < S;  // warp-uniform: some of its s are real
  const int s0 = s_sel(warp, 0, g), s1 = s_sel(warp, 1, g);
  float acc[4][4];
  for (int q = 0;; ++q) {
    const int st = q % kRingStages;
    mbar_wait(R.full + st, (q / kRingStages) & 1);
    const ChunkDesc d = R.desc[st];
    if (d.flags & kEndOfWork) break;
    if (d.flags & kFirstChunk) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
    }
    if (active) {
      const T* as = reinterpret_cast<const T*>(R.a(st)) + head_floats(a + (size_t)d.r * S);
      const T* bs = reinterpret_cast<const T*>(R.b(st));
      for (int h = 0; 16 * h < d.nr; ++h) {
        if constexpr (kSplit3) {
          // fragment k index 2 tig + j + 8 q is the chunk's row 16 h + 8 q + 2 tig + j
          float av[2][2][2], bv[4][2][2];  // [hf][q][j], [u][q][j]
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int t = 16 * h + 8 * qq + 2 * tig + j;
              const bool ok = t < d.nr;
              av[0][qq][j] = ok ? as[t * S + s0] : 0.f;
              av[1][qq][j] = ok ? as[t * S + s1] : 0.f;
#pragma unroll
              for (int u = 0; u < 4; ++u) bv[u][qq][j] = ok ? bs[t * ldb + 8 * u + g] : 0.f;
            }
          }
          unsigned ah[4], al[4];
          split_pair(av[0][0][0], av[0][0][1], ah[0], al[0]);
          split_pair(av[1][0][0], av[1][0][1], ah[1], al[1]);
          split_pair(av[0][1][0], av[0][1][1], ah[2], al[2]);
          split_pair(av[1][1][0], av[1][1][1], ah[3], al[3]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * u < M) {
              unsigned bh[2], bl[2];
              split_pair(bv[u][0][0], bv[u][0][1], bh[0], bl[0]);
              split_pair(bv[u][1][0], bv[u][1][1], bh[1], bl[1]);
              mma_split3(acc[u], ah, al, bh, bl);
            }
          }
        } else {
          // the same fragments from bf16 values: rows t and t + 1 of column s or m
          const int t0 = 16 * h + 2 * tig, t1 = t0 + 8;
          const unsigned af[4] = {col_pair(as + s0, S, t0, d.nr), col_pair(as + s1, S, t0, d.nr),
                                  col_pair(as + s0, S, t1, d.nr), col_pair(as + s1, S, t1, d.nr)};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * u < M) {
              const unsigned bfr[2] = {col_pair(bs + 8 * u + g, ldb, t0, d.nr),
                                       col_pair(bs + 8 * u + g, ldb, t1, d.nr)};
              mma_bf16(acc[u], af, bfr);
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty + st);  // this warp is done with the stage
    if (!(d.flags & kLastChunk)) continue;

    // the item's tile: this warp's 16 rows of M floats, whole, by 16-byte
    // stores (8-byte ones of bf16), through its scratch [16][ldo] (ldo = 8
    // mod 16: conflict-free float2 stores)
    const int ldo = R.L.lo / 16;
    float* sc = R.scratch + warp * R.L.lo;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = 8 * u + 2 * tig;
      if (col < M) {
        *reinterpret_cast<float2*>(sc + g * ldo + col) = make_float2(acc[u][0], acc[u][1]);
        *reinterpret_cast<float2*>(sc + (g + 8) * ldo + col) = make_float2(acc[u][2], acc[u][3]);
      }
    }
    __syncwarp();
    const int m4 = M / 4;
    for (int i = lane; i < 16 * m4; i += 32) {
      const int rr = i / m4, c4 = i - rr * m4;
      const int s = s_sel(warp, rr >> 3, rr & 7);
      if (s < S) {
        const float4 v = *reinterpret_cast<const float4*>(sc + rr * ldo + 4 * c4);
        if (d.slot < 0) {
          store4(out + ((size_t)s * n_seg + d.seg) * M + 4 * c4, v);
        } else {
          store4(partial + ((size_t)d.slot * S + s) * M + 4 * c4, v);
        }
      }
    }
    __syncwarp();  // the scratch is read before the next item writes it
    if (d.slot >= 0) {
      merge_up<1>(R, d.slot, tree_nodes, tree_parent, tree_arrivals, partial, out, n_seg, S, M);
    }
  }
}

__global__ void __launch_bounds__(kRingThreads, 3)
outer_sum_split3_ring(const float* __restrict__ a, const float* __restrict__ b,
                      const int4* __restrict__ items, int n_items,
                      const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
                      int* __restrict__ tree_arrivals, float* __restrict__ partial,
                      float* __restrict__ out, int n, int n_seg, int S, int M) {
  outer_sum_mma_body<float>(a, b, items, n_items, tree_nodes, tree_parent, tree_arrivals,
                            partial, out, n, n_seg, S, M);
}

// A consumer warp's 16 rows of da (W = S) or db (W = M), as computed in
// fragments, through its scratch into device memory: rows
// [row0, row0 + nrow) of a (rows x W) tensor are one contiguous range, which
// it writes as 16-byte stores, the ragged head and tail plainly.
__device__ __forceinline__ void store_rows(float* sc, float* __restrict__ dst, size_t row0,
                                           int nrow, int W, int lane) {
  const size_t g0 = row0 * W, g1 = g0 + (size_t)nrow * W;
  const size_t base = g0 & ~(size_t)3;  // sc[i] is dst[base + i]
  const size_t b0 = (g0 + 3) & ~(size_t)3, b1 = g1 & ~(size_t)3;
  if (b0 >= b1) {
    for (size_t i = g0 + lane; i < g1; i += 32) dst[i] = sc[i - base];
    return;
  }
  if (g0 + lane < b0) dst[g0 + lane] = sc[g0 + lane - base];
  if (b1 + lane < g1) dst[b1 + lane] = sc[b1 + lane - base];
  for (size_t v = b0 + 4 * lane; v < b1; v += 128) {
    *reinterpret_cast<float4*>(dst + v) = *reinterpret_cast<const float4*>(sc + (v - base));
  }
}

// backward consumer, da role: rows t0 .. t0 + 15 of each chunk;
// da[t, s] = sum_m b[t, m] c[s, m], A = b rows (k = m), B = C^T
__device__ void consume_da(const Ring& R, float* __restrict__ da, int t0, int S, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int ldb = R.L.ldb;
  const int nts = (S + 7) / 8;  // 8-wide tiles of s
  float* sc = R.scratch + warp * R.L.lo;
  unsigned ch[8][2][2], cl[8][2][2];  // [s tile][k step][q]
  for (int q = 0;; ++q) {
    const int st = q % kRingStages;
    mbar_wait(R.full + st, (q / kRingStages) & 1);
    const ChunkDesc d = R.desc[st];
    if (d.flags & kEndOfWork) break;
    if (d.flags & kFirstChunk) {
      const float* cs = R.c(st);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = 8 * u + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int m = 16 * h + 8 * qq + 2 * tig;  // M even: m < M means m + 1 < M
            float2 v = make_float2(0.f, 0.f);
            if (s < S && m < M) v = *reinterpret_cast<const float2*>(cs + s * M + m);
            split_pair(v.x, v.y, ch[u][h][qq], cl[u][h][qq]);
          }
        }
      }
    }
    const int nrow = min(16, d.nr - t0);
    float acc[8][4];
    if (nrow > 0) {
#pragma unroll
      for (int u = 0; u < 8; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      const float* bs = R.b(st) + t0 * ldb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (16 * h < M) {
          float2 v[2][2];  // [hf][q]
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
              const int m = 16 * h + 8 * qq + 2 * tig;
              v[hf][qq] = m < M ? *reinterpret_cast<const float2*>(bs + (g + 8 * hf) * ldb + m)
                                : make_float2(0.f, 0.f);
            }
          }
          unsigned ah[4], al[4];
          split_pair(v[0][0].x, v[0][0].y, ah[0], al[0]);
          split_pair(v[1][0].x, v[1][0].y, ah[1], al[1]);
          split_pair(v[0][1].x, v[0][1].y, ah[2], al[2]);
          split_pair(v[1][1].x, v[1][1].y, ah[3], al[3]);
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            if (u < nts) mma_split3(acc[u], ah, al, ch[u][h], cl[u][h]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty + st);
    if (nrow <= 0) continue;
    const size_t row0 = (size_t)d.r + t0;
    const int sh = (int)((row0 * S) & 3);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 8 * u + 2 * tig + j;
        if (col < S) {
          sc[sh + g * S + col] = acc[u][j];
          sc[sh + (g + 8) * S + col] = acc[u][2 + j];
        }
      }
    }
    __syncwarp();
    store_rows(sc, da, row0, nrow, S, lane);
    __syncwarp();
  }
}

// backward consumer, db role: db[t, m] = sum_s a[t, s] c[s, m], A = a rows
// (k = s), B = C. Fragment k index 2 tig + j + 8 q of k step h is
// s = 32 (h / 2) + 8 tig + 4 (h % 2) + 2 q + j: with a rows S (odd) floats
// apart, one fragment read of 8 rows g and 4 tig falls in 32 banks.
__device__ void consume_db(const Ring& R, const float* __restrict__ a, float* __restrict__ db,
                           int t0, int S, int M) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  float* sc = R.scratch + warp * R.L.lo;
  unsigned ch[4][4][2], cl[4][4][2];  // [k step][m tile][q]
  for (int q = 0;; ++q) {
    const int st = q % kRingStages;
    mbar_wait(R.full + st, (q / kRingStages) & 1);
    const ChunkDesc d = R.desc[st];
    if (d.flags & kEndOfWork) break;
    if (d.flags & kFirstChunk) {
      const float* cs = R.c(st);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int m = 8 * u + g;
#pragma unroll
          for (int qq = 0; qq < 2; ++qq) {
            const int s = 32 * (h >> 1) + 8 * tig + 4 * (h & 1) + 2 * qq;
            const float x0 = s < S && m < M ? cs[s * M + m] : 0.f;
            const float x1 = s + 1 < S && m < M ? cs[(s + 1) * M + m] : 0.f;
            split_pair(x0, x1, ch[h][u][qq], cl[h][u][qq]);
          }
        }
      }
    }
    const int nrow = min(16, d.nr - t0);
    float acc[4][4];
    if (nrow > 0) {
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;
      const float* as = R.a(st) + head_floats(a + (size_t)d.r * S) + t0 * S;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        if (32 * (h >> 1) < S) {
          float v[2][2][2];  // [hf][q][j]
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
            for (int qq = 0; qq < 2; ++qq) {
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int s = 32 * (h >> 1) + 8 * tig + 4 * (h & 1) + 2 * qq + j;
                v[hf][qq][j] = s < S ? as[(g + 8 * hf) * S + s] : 0.f;
              }
            }
          }
          unsigned ah[4], al[4];
          split_pair(v[0][0][0], v[0][0][1], ah[0], al[0]);
          split_pair(v[1][0][0], v[1][0][1], ah[1], al[1]);
          split_pair(v[0][1][0], v[0][1][1], ah[2], al[2]);
          split_pair(v[1][1][0], v[1][1][1], ah[3], al[3]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (8 * u < M) mma_split3(acc[u], ah, al, ch[h][u], cl[h][u]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty + st);
    if (nrow <= 0) continue;
    const size_t row0 = (size_t)d.r + t0;
    const int sh = (int)((row0 * M) & 3);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int col = 8 * u + 2 * tig;  // M % 4 == 0: col < M means col + 1 < M
      if (col < M) {
        *reinterpret_cast<float2*>(sc + sh + g * M + col) = make_float2(acc[u][0], acc[u][1]);
        *reinterpret_cast<float2*>(sc + sh + (g + 8) * M + col) =
            make_float2(acc[u][2], acc[u][3]);
      }
    }
    __syncwarp();
    store_rows(sc, db, row0, nrow, M, lane);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kRingThreads, 2)
gather_contract_split3_ring(const float* __restrict__ cot, const float* __restrict__ a,
                            const float* __restrict__ b, const int4* __restrict__ items,
                            int n_items, float* __restrict__ da, float* __restrict__ db, int n,
                            int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char ring_smem_raw[];
  const Ring R(ring_smem_raw, S, M, kRingSplit3Bwd);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      mbar_init(R.full + i, 1);
      mbar_init(R.empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (warp == kConsumerWarps) {
    ring_produce<float, true, false>(R, a, b, cot, items, n_items, n, n_seg, S, M);
  } else if (warp < 2) {
    consume_da(R, da, 16 * warp, S, M);
  } else {
    consume_db(R, a, db, 16 * (warp - 2), S, M);
  }
}

// ------------------------------------------------------------ K1 on Hopper
//
// gemnet_segment_outer_sum_{f32,bf16} at the model's shapes; they replace
// segment_outer.py::_fwd_kernel's non-split3 branch (:366-369), launched by
// _outer_sum_pallas (:375), and keep its stream contract (file header).
//
// What bounds K1 on an H100: bytes. At the bench quad shape (192 512 rows,
// S = 49, M = 32, 3072 segments) it reads and writes 81.7 MB in fp32, 24.4
// us at 3.35 TB/s, for 2 n S M = 0.60 GFLOP (9.0 us at 67 TFLOP/s of FFMA);
// bf16 streams halve the bytes (12.2 us) and put the product on the tensor
// cores (0.6 us at 989 TFLOP/s). At the triplet shape (25 600 rows, S = 7,
// M = 64, real segments ~8 rows) 12.8 MB, 3.8 us, and the work is latency:
// ~3100 items of a few rows each, and one padded segment of ~1600 rows.
//
// Design.
// - Quadruplet shape (ring_shape, 16-byte aligned tensors): the ring of
//   K4's forward, a producer warp copying each chunk of kRingRows rows by
//   TMA into a kRingStages ring, four consumer warps handing stages back
//   through mbarriers, persistent blocks, no block-wide barrier after
//   set-up; a split segment's partial tiles added through the plan's merge
//   tree (merge_up: no block adds more than 16 tiles, fixed order, counters
//   back at zero).
//   - fp32 (outer_sum_ffma_ring): exact fp32 FFMAs. Each consumer warp
//     takes rows w, w + 4, ... of a chunk and sums the whole (S, M) tile;
//     lane (g = lane % 8, mg = lane / 8) owns s = g + 8 j (j < JS =
//     ceil(S / 8)) and m = 8 mg .. 8 mg + 7: per row JS a loads (8 distinct
//     consecutive addresses, broadcast) and two float4 b loads for 8 JS
//     FFMAs, 56 FFMAs per 9 shared loads at S = 49. The instructions:
//     192 512 rows x (56 FFMA + 9 loads) / (132 SMs x 4 schedulers) ~ 24k
//     cycles, ~13 us at 1.8 GHz, under the copies' 24 us; a chunk's b rows
//     are one bulk copy (lanes read 4 distinct float4s, conflict-free). At
//     the item's end the four warps' tiles are added in warp order through
//     shared memory (rows M + 4 floats apart) and written as whole 128-byte
//     rows.
//   - bf16 (outer_sum_mma_ring): K4's forward with T = bf16
//     (outer_sum_mma_body): the stages hold bf16 rows as they lie in memory
//     (a chunk's a bytes from the 16-byte boundary below them, the <= 7
//     values past the tensor's last boundary read plainly; b rows 80 bytes
//     apart at M = 32, conflict-free fragment reads); each warp builds
//     mma.sync m16n8k16 bf16 fragments straight from them, one product,
//     fp32 accumulators, and the output rounds once at the store (64-byte
//     rows).
// - Triplet shape (S <= 8, M <= 64, M % 4 == 0, outer_sum_warp_kernel,
//   both stream types; and K4's forward, outer_sum_split3_warp, the same
//   body with split3 products): a 128-row block item is the wrong unit for
//   ~8-row segments. Persistent blocks of four warps; each warp owns an
//   item at a time (items w, w + W, ... of the grid's W warps, their descriptors
//   loaded 32 at a time) and walks its rows in chunks of kWarpRows through
//   its own ring of kWarpStages stages (cp.async, the next two chunks in
//   flight, the next items' among them); each lane owns columns 2 lane,
//   2 lane + 1 for all S values of s (16 fp32 accumulators), widening bf16
//   in registers (at S = 7 the tensor cores buy nothing). The tile is
//   written as one 256-byte (fp32) or 128-byte (bf16) row per s. The
//   triplet plan's items are 16 rows (data/batch.py::SEGMENT_PLANS), so the
//   padded segment spreads over ~100 warps; its partial tiles merge through
//   the plan's tree, a warp per node (warp_merge_up), whose latency rounds
//   are the launch's critical path: measured on the H100 (PERF.md §6), a
//   warp streaming 128-row items, and a merge with sc fences and 16 loads in
//   flight per lane, each cost several microseconds.
//   K4's forward there (split3) replaces the wmma kernel
//   (outer_sum_split3_kernel, kept for other shapes) and its second,
//   one-block merge launch. It moves K1's fp32 bytes (12.8 MB, 3.8 us at
//   3.35 TB/s); at S = 7 a lane does 28 FFMAs per row and its two b splits,
//   so the tensor cores again buy nothing. The warp's lanes split the
//   chunk's a values together, once, into a buffer of (hi, lo) fp32 pairs
//   (1 KB a warp), which the row loop reads as one broadcast 8-byte load a
//   value; a_hi b_hi + a_hi b_lo is one FFMA by b_hi + b_lo, exact in fp32,
//   and a_lo b_hi a second. Measured on the H100 (PERF.md §6): every lane
//   splitting each a value as it read it, with three FFMAs a product,
//   0.0176 ms; the split in place as one word (hi's bits | lo's bf16 bits)
//   that each read decodes with two integer instructions, 0.0161 ms. The
//   split segment's partial tiles merge through the plan's tree, as K1's.
//   K4's backward there (gather_contract_split3_warp) walks the same items
//   through the same ring, its stages also holding the segment's cotangent
//   tile, and needs no merge: each row's da and db are the warp's own.
// Other shapes take the general kernel of the first section.

constexpr int kWarpRows = 16;     // rows per stage of a warp's ring
constexpr int kWarpStages = 3;    // one summed, two in flight
constexpr int kWarpItemThreads = 128;
constexpr int kWarpMaxS = 8, kWarpMaxM = 64;

__global__ void __launch_bounds__(kRingThreads, 3)
outer_sum_mma_ring(const bf16* __restrict__ a, const bf16* __restrict__ b,
                   const int4* __restrict__ items, int n_items,
                   const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
                   int* __restrict__ tree_arrivals, float* __restrict__ partial,
                   bf16* __restrict__ out, int n, int n_seg, int S, int M) {
  outer_sum_mma_body<bf16>(a, b, items, n_items, tree_nodes, tree_parent, tree_arrivals,
                           partial, out, n, n_seg, S, M);
}

template <int JS>
__global__ void __launch_bounds__(kRingThreads, 3)
outer_sum_ffma_ring(const float* __restrict__ a, const float* __restrict__ b,
                    const int4* __restrict__ items, int n_items,
                    const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
                    int* __restrict__ tree_arrivals, float* __restrict__ partial,
                    float* __restrict__ out, int n, int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char ring_smem_raw[];
  const Ring R(ring_smem_raw, S, M, kRingFfma);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRingStages; ++i) {
      mbar_init(R.full + i, 1);
      mbar_init(R.empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (warp == kConsumerWarps) {
    ring_produce<float, false, false>(R, a, b, nullptr, items, n_items, n, n_seg, S, M);
    return;
  }
  const int g = lane & 7, m0 = 8 * (lane >> 3);
  const int ldo = M + 4;
  float acc[JS][8];
  for (int q = 0;; ++q) {
    const int st = q % kRingStages;
    mbar_wait(R.full + st, (q / kRingStages) & 1);
    const ChunkDesc d = R.desc[st];
    if (d.flags & kEndOfWork) break;
    if (d.flags & kFirstChunk) {
#pragma unroll
      for (int j = 0; j < JS; ++j)
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = 0.f;
    }
    // past S and M the reads stay in shared memory and feed accumulators
    // that are never stored
    const float* as = R.a(st) + head_floats(a + (size_t)d.r * S) + g;
    const float* bs = R.b(st) + m0;
#pragma unroll 2
    for (int t = warp; t < d.nr; t += kConsumerWarps) {
      const float4 b0 = *reinterpret_cast<const float4*>(bs + t * M);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + t * M + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < JS; ++j) {
        const float av = as[t * S + 8 * j];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[j][k] = fmaf(av, bv[k], acc[j][k]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(R.empty + st);  // this warp is done with the stage
    if (!(d.flags & kLastChunk)) continue;

    // the item's tile: the four warps' tiles, added in warp order
    consumer_sync();  // the last item's tiles are read
    float* sc = R.scratch + warp * R.L.lo;
#pragma unroll
    for (int j = 0; j < JS; ++j) {
      const int s = g + 8 * j;
      if (s < S) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (m0 + 4 * h < M) {
            *reinterpret_cast<float4*>(sc + s * ldo + m0 + 4 * h) = make_float4(
                acc[j][4 * h], acc[j][4 * h + 1], acc[j][4 * h + 2], acc[j][4 * h + 3]);
          }
        }
      }
    }
    consumer_sync();
    const int m4 = M / 4;
    for (int i = threadIdx.x; i < S * m4; i += 32 * kConsumerWarps) {
      const int s = i / m4, c = 4 * (i - s * m4);
      float4 v = *reinterpret_cast<const float4*>(R.scratch + s * ldo + c);
#pragma unroll
      for (int w = 1; w < kConsumerWarps; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(R.scratch + w * R.L.lo + s * ldo + c);
        v.x += x.x;
        v.y += x.y;
        v.z += x.z;
        v.w += x.w;
      }
      if (d.slot < 0) {
        store4(out + ((size_t)s * n_seg + d.seg) * M + c, v);
      } else {
        store4(partial + ((size_t)d.slot * S + s) * M + c, v);
      }
    }
    if (d.slot >= 0) {
      merge_up<1>(R, d.slot, tree_nodes, tree_parent, tree_arrivals, partial, out, n_seg, S, M);
    }
  }
}

// two fp32 values from two consecutive values of T, and back (bf16: one
// rounding each)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Bytes of a warp's stage: a chunk's a rows (and reads past S), then its b
// rows, each from the 16-byte boundary below them.
__host__ __device__ constexpr int warp_stage_a(int S, int es) {
  return round16(es * (kWarpRows * S + kWarpMaxS) + 16);
}
__host__ __device__ constexpr int warp_stage(int S, int M, int es) {
  return warp_stage_a(S, es) + round16(es * kWarpRows * M + 16);
}
// the warps' rings; split3: and each warp's buffer of split a values
size_t warp_outer_smem(int S, int M, int es, bool split3) {
  const size_t split = split3 ? sizeof(float2) * kWarpRows * S : 0;
  return (kWarpStages * (size_t)warp_stage(S, M, es) + split) * (kWarpItemThreads / 32);
}

bool warp_outer_shape(int S, int M) {
  return S >= 1 && S <= kWarpMaxS && M >= 4 && M <= kWarpMaxM && M % 4 == 0;
}

// `bytes` bytes from `first` into `raw` as a warp's 16-byte cp.async copies,
// from the 16-byte boundary at or below `first` (within the tensor, which
// is 16-byte aligned), never past the last byte
__device__ __forceinline__ void warp_stage_raw(const void* first, size_t bytes, void* raw,
                                               int lane) {
  const char* begin = static_cast<const char*>(first);
  const char* end = begin + bytes;
  const char* base = floor16(begin);
  const int pieces = (int)((end - base + 15) / 16);
  for (int i = lane; i < pieces; i += 32) {
    const char* src = base + 16 * i;
    const long long rest = end - src;
    cp_async16(static_cast<char*>(raw) + 16 * i, src, rest < 16 ? (int)rest : 16);
  }
}

// Adds the warp's partial tile `slot` into its merge-tree node if it is the
// node's last child to arrive, then goes on up the tree: merge_up for one
// warp.
template <typename T>
__device__ void warp_merge_up(int slot, const int4* __restrict__ tree_nodes,
                              const int* __restrict__ tree_parent, int* __restrict__ tree_arrivals,
                              float* __restrict__ partial, T* __restrict__ out, int n_seg, int S,
                              int M, int lane) {
  for (;;) {
    __syncwarp();  // every lane has stored its columns of `slot`
    int node = 0, last = 0;
    if (lane == 0) {
      node = tree_parent[slot];
      const int4 nd = tree_nodes[node];
      // release: the warp's stores of `slot` (ordered before by the warp
      // barrier) are visible to the child that arrives last; acquire: so
      // are theirs, to the lanes after the barrier below
      last = atomic_add_acq_rel(tree_arrivals + node, 1) == nd.y - nd.x - 1;
    }
    node = __shfl_sync(kFullMask, node, 0);
    if (!__shfl_sync(kFullMask, last, 0)) return;
    const int4 nd = tree_nodes[node];
    merge_node<2>(nd, partial, out, n_seg, S * M, M, lane, 32);
    if (lane == 0) tree_arrivals[node] = 0;  // for the next launch
    if (nd.z < 0) return;
    slot = nd.z;
  }
}

// A warp's place in its chunks: the j-th of its items (items w, w + W, ...
// of the grid's W warps), chunk c of it. Lane l holds the descriptor of the
// warp's item 32 (j / 32) + l, all 32 loaded together, so moving on to an
// item waits for no load.
struct WarpCursor {
  int j, c;
  int4 it;    // segment, row0, row1, slot
  int4 mine;  // this lane's prefetched descriptor
};

__device__ __forceinline__ bool warp_next(const int4* __restrict__ items, int n_items, int w,
                                          int W, int lane, WarpCursor& cur) {
  if ((cur.c + 1) * kWarpRows < cur.it.z - cur.it.y) {
    ++cur.c;
    return true;
  }
  ++cur.j;
  cur.c = 0;
  if (w + cur.j * W >= n_items) return false;  // warp-uniform
  if (cur.j % 32 == 0) {
    const int k = w + (cur.j + lane) * W;
    cur.mine = k < n_items ? items[k] : make_int4(0, 0, 0, 0);
  }
  const int l = cur.j % 32;
  cur.it = make_int4(__shfl_sync(kFullMask, cur.mine.x, l), __shfl_sync(kFullMask, cur.mine.y, l),
                     __shfl_sync(kFullMask, cur.mine.z, l), __shfl_sync(kFullMask, cur.mine.w, l));
  return true;
}

// fp32 x -> its split3 halves as fp32 values, bit for bit split_hi_lo's:
// hi is x's bits masked with 0xFFFF0000, lo = bf16_rn(x - hi) widened. A
// product of two halves is exact in fp32, as on the tensor cores.
__device__ __forceinline__ float2 split_f(float x) {
  const float h = __uint_as_float(__float_as_uint(x) & 0xFFFF0000u);
  return make_float2(h, __bfloat162float(__float2bfloat16_rn(x - h)));
}

// The warp-per-item forward. kSplit3 = false: K1, T = float or bf16 (widened
// in registers), one exact fp32 FFMA per product. kSplit3 = true: K4's
// forward, T = float. The warp's lanes split the chunk's a values together,
// once, into the warp's (hi, lo) buffer after its ring; a lane splits its
// two b values once per row (split_f). hi*hi + hi*lo is one FFMA of a_hi by
// b_hi + b_lo: that sum is exact in fp32 (b_lo's bits lie within the 24
// below b_hi's leading bit, since b - b_hi keeps only the 16 low bits of b's
// mantissa), and the FFMA rounds a_hi b_hi + a_hi b_lo, both exact, once;
// lo*hi is a second FFMA.
template <typename T, bool kSplit3>
__device__ __forceinline__ void outer_sum_warp_body(
    const T* __restrict__ a, const T* __restrict__ b, const int4* __restrict__ items,
    int n_items, const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
    int* __restrict__ tree_arrivals, float* __restrict__ partial, T* __restrict__ out, int n_seg,
    int S, int M) {
  static_assert(!kSplit3 || sizeof(T) == sizeof(float), "split3 takes fp32 rows");
  extern __shared__ __align__(128) unsigned char warp_smem_raw[];
  constexpr int es = sizeof(T);
  const int lane = threadIdx.x % 32;
  const int W = gridDim.x * (kWarpItemThreads / 32);
  const int sa = warp_stage_a(S, es), sb = warp_stage(S, M, es);
  unsigned char* ring = warp_smem_raw + (threadIdx.x / 32) * kWarpStages * sb;
  // split3: the chunk's a values as (hi, lo), [kWarpRows][S], after the rings
  float2* ab =
      reinterpret_cast<float2*>(warp_smem_raw + kWarpItemThreads / 32 * kWarpStages * sb) +
      (threadIdx.x / 32) * kWarpRows * S;
  const int m = 2 * lane;  // this lane's columns m, m + 1

  // chunk c of item it into stage q % kWarpStages: its a and b rows as they
  // lie in memory
  auto stage = [&](const WarpCursor& c, int q) {
    const int r = c.it.y + c.c * kWarpRows;
    const int nr = min(kWarpRows, c.it.z - r);
    if (nr > 0) {
      unsigned char* st = ring + (q % kWarpStages) * sb;
      warp_stage_raw(a + (size_t)r * S, (size_t)es * nr * S, st, lane);
      warp_stage_raw(b + (size_t)r * M, (size_t)es * nr * M, st + sa, lane);
    }
  };

  float acc[kWarpMaxS][2];
#pragma unroll
  for (int s = 0; s < kWarpMaxS; ++s) acc[s][0] = acc[s][1] = 0.f;
  const int w = blockIdx.x * (kWarpItemThreads / 32) + threadIdx.x / 32;
  const int4 zero = make_int4(0, 0, 0, 0);
  WarpCursor cur{-1, 0, zero, zero};
  if (!warp_next(items, n_items, w, W, lane, cur)) return;  // warp-uniform
  // two chunks in flight beside the one summed
  static_assert(kWarpStages == 3, "the pipeline keeps kWarpStages - 1 chunks in flight");
  stage(cur, 0);
  cp_async_commit();
  WarpCursor n1 = cur;
  bool has1 = warp_next(items, n_items, w, W, lane, n1);
  if (has1) stage(n1, 1);
  cp_async_commit();
  WarpCursor n2 = n1;
  bool has2 = has1 && warp_next(items, n_items, w, W, lane, n2);
  for (int q = 0;; ++q) {
    if (has2) stage(n2, q + 2);
    cp_async_commit();
    cp_async_wait<kWarpStages - 1>();  // chunk q landed
    __syncwarp();
    const int r = cur.it.y + cur.c * kWarpRows;
    const int nr = min(kWarpRows, cur.it.z - r);
    const unsigned char* st = ring + (q % kWarpStages) * sb;
    const T* as = reinterpret_cast<const T*>(st) + head_floats(a + (size_t)r * S);
    const T* bs = reinterpret_cast<const T*>(st + sa) + head_floats(b + (size_t)r * M);
    if constexpr (kSplit3) {
      for (int i = lane; i < nr * S; i += 32) ab[i] = split_f(widen(as[i]));
      __syncwarp();
    }
#pragma unroll 4
    for (int t = 0; t < nr; ++t) {
      const float2 bv = m < M ? load2(bs + t * M + m) : make_float2(0.f, 0.f);
      if constexpr (kSplit3) {
        const float2 b0 = split_f(bv.x), b1 = split_f(bv.y);  // (hi, lo)
        const float s0 = b0.x + b0.y, s1 = b1.x + b1.y;       // exact
#pragma unroll
        for (int s = 0; s < kWarpMaxS; ++s) {
          if (s < S) {
            const float2 av = ab[t * S + s];  // (hi, lo), one address across the warp
            acc[s][0] = fmaf(av.x, s0, acc[s][0]);
            acc[s][0] = fmaf(av.y, b0.x, acc[s][0]);
            acc[s][1] = fmaf(av.x, s1, acc[s][1]);
            acc[s][1] = fmaf(av.y, b1.x, acc[s][1]);
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < kWarpMaxS; ++s) {
          if (s < S) {
            const float av = widen(as[t * S + s]);  // one address across the warp
            acc[s][0] = fmaf(av, bv.x, acc[s][0]);
            acc[s][1] = fmaf(av, bv.y, acc[s][1]);
          }
        }
      }
    }
    __syncwarp();  // the stage is read before chunk q + kWarpStages lands in it
    if ((cur.c + 1) * kWarpRows >= cur.it.z - cur.it.y) {  // the item's last chunk
      const int4 it = cur.it;
      if (m < M) {
#pragma unroll
        for (int s = 0; s < kWarpMaxS; ++s) {
          if (s < S) {
            if (it.w < 0) {
              store2(out + ((size_t)s * n_seg + it.x) * M + m, acc[s][0], acc[s][1]);
            } else {
              store2(partial + ((size_t)it.w * S + s) * M + m, acc[s][0], acc[s][1]);
            }
          }
        }
      }
      if (it.w >= 0) {
        warp_merge_up(it.w, tree_nodes, tree_parent, tree_arrivals, partial, out, n_seg, S, M,
                      lane);
      }
#pragma unroll
      for (int s = 0; s < kWarpMaxS; ++s) acc[s][0] = acc[s][1] = 0.f;
    }
    if (!has1) break;
    cur = n1;
    n1 = n2;
    has1 = has2;
    if (has2) has2 = warp_next(items, n_items, w, W, lane, n2);
  }
  cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(kWarpItemThreads)
outer_sum_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      const int4* __restrict__ items, int n_items,
                      const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
                      int* __restrict__ tree_arrivals, float* __restrict__ partial,
                      T* __restrict__ out, int n_seg, int S, int M) {
  outer_sum_warp_body<T, false>(a, b, items, n_items, tree_nodes, tree_parent, tree_arrivals,
                                partial, out, n_seg, S, M);
}

// K4's forward at the warp shape: its own name, so that the profiler's
// groups (chip_smoke.PROFILE_GROUPS) count it under K4
__global__ void __launch_bounds__(kWarpItemThreads)
outer_sum_split3_warp(const float* __restrict__ a, const float* __restrict__ b,
                      const int4* __restrict__ items, int n_items,
                      const int4* __restrict__ tree_nodes, const int* __restrict__ tree_parent,
                      int* __restrict__ tree_arrivals, float* __restrict__ partial,
                      float* __restrict__ out, int n_seg, int S, int M) {
  outer_sum_warp_body<float, true>(a, b, items, n_items, tree_nodes, tree_parent, tree_arrivals,
                                   partial, out, n_seg, S, M);
}

// K4's backward at the warp shape, gather_contract_split3_warp (its name
// puts it under K4 in chip_smoke.PROFILE_GROUPS): the split3 branch of
// segment_outer.py::_bwd_kernel (:499-513) at the triplet shape, in place
// of the wmma kernel (gather_contract_split3_kernel, kept for the other
// shapes and for unaligned tensors).
//
// What bounds it: bytes and latency. At the bench triplet shape (25 600
// rows, S = 7, M = 64, 3072 segments) it moves 20.1 MB (the cotangent 5.5
// MB, a and b read once, da and db written once), 6.0 us at 3.35 TB/s, for
// 0.14 GFLOP of split3 products, 2.1 us even at the CUDA cores' 67 TFLOP/s:
// at S = 7 the tensor cores buy nothing. The wmma kernel ran a 256-thread
// block per item of ~8 rows, S padded to 16 in every tile, its loads
// between block barriers with nothing in flight.
//
// Design: the forward's warp per 16-row item of the plan (WarpCursor), its
// 3-stage cp.async ring per warp, whose stages also hold the segment's
// (S, M) cotangent tile, copied with the item's first chunk, so the tile's
// latency hides behind the chunks before it as the rows' does. Lane l owns
// columns m = 2 l, 2 l + 1: it splits its part of the tile once per item
// into (c_hi, c_lo) registers (32, zero past S) and its two b values once
// per row (split_f); the warp's lanes then split the chunk's a values
// together, once, into (a_hi + a_lo, a_hi) pairs, kWarpMaxS a row (zero
// past S), in the stage's tile region. With x_hi + x_lo exact in fp32
// (outer_sum_warp_body's note), per row
//   db[t, m] = sum_s c_hi (a_hi + a_lo) + c_lo a_hi: two FFMAs per s, in s
//              order, stored as one float2 per lane;
//   da[t, s] = sum_m c_hi (b_hi + b_lo) + c_lo b_hi: the lane's two
//              columns, a product and three FFMAs per s, then summed
//              across the warp by reduce_scatter over kContractRows rows at
//              once (32 values: each lane ends with one (row, s) total, and
//              the group's da is one store of contiguous floats).
// Every output element is written once, by the warp that owns its row: no
// atomics, no merge, and two launches write the same bits. Empty items
// write nothing. Why the row loop has no guard s < S (the values past S
// are zero) and takes four rows to a reduce-scatter, and why the split a
// values reuse the tile's place: with a branch per s, a row at a time, the
// rows serialise on their latency (0.0215 ms against 0.0055 for the copies
// alone); branch-free groups of four rows at two blocks an SM, 0.0139; the
// 4 KB a block the tile's place frees lets three blocks of 76.8 KB (168
// registers a thread) share an SM, 0.0121 (PERF.md §6, measured on the
// H100).
constexpr int kContractRows = 4;  // rows per reduce-scatter of da
// a stage's third region: the cotangent tile, then the chunk's split a
// values, [kWarpRows][kWarpMaxS] (hi + lo, hi) pairs
__host__ __device__ constexpr int warp_stage_c(int S, int M) {
  return round16(4 * S * M > 8 * kWarpRows * kWarpMaxS ? 4 * S * M : 8 * kWarpRows * kWarpMaxS);
}

size_t warp_contract_smem(int S, int M) {
  return kWarpStages * (size_t)(warp_stage(S, M, sizeof(float)) + warp_stage_c(S, M)) *
         (kWarpItemThreads / 32);
}

__global__ void __launch_bounds__(kWarpItemThreads, 3)
gather_contract_split3_warp(const float* __restrict__ cot, const float* __restrict__ a,
                            const float* __restrict__ b, const int4* __restrict__ items,
                            int n_items, float* __restrict__ da, float* __restrict__ db,
                            int n_seg, int S, int M) {
  extern __shared__ __align__(128) unsigned char warp_smem_raw[];
  constexpr int es = sizeof(float);
  const int lane = threadIdx.x % 32;
  const int W = gridDim.x * (kWarpItemThreads / 32);
  // a stage: the chunk's a rows (sa bytes), its b rows, the cotangent tile
  const int sa = warp_stage_a(S, es), sc = warp_stage(S, M, es);
  const int sb = sc + warp_stage_c(S, M);
  unsigned char* ring = warp_smem_raw + (threadIdx.x / 32) * kWarpStages * sb;
  const int m = 2 * lane;  // this lane's columns m, m + 1
  const int m4 = M / 4;

  // chunk c of item it into stage q % kWarpStages: its a and b rows as they
  // lie in memory and, with the first chunk, the segment's tile (rows of M
  // floats, 16-byte aligned since M % 4 == 0)
  auto stage = [&](const WarpCursor& c, int q) {
    const int r = c.it.y + c.c * kWarpRows;
    const int nr = min(kWarpRows, c.it.z - r);
    if (nr > 0) {
      unsigned char* st = ring + (q % kWarpStages) * sb;
      warp_stage_raw(a + (size_t)r * S, (size_t)es * nr * S, st, lane);
      warp_stage_raw(b + (size_t)r * M, (size_t)es * nr * M, st + sa, lane);
      if (c.c == 0) {
        float* ct = reinterpret_cast<float*>(st + sc);
        for (int i = lane; i < S * m4; i += 32) {
          const int s = i / m4;
          cp_async16(ct + 4 * i, cot + ((size_t)s * n_seg + c.it.x) * M + 4 * (i - s * m4), 16);
        }
      }
    }
  };

  float ch[kWarpMaxS][2], cl[kWarpMaxS][2];  // the lane's columns of the tile, split
#pragma unroll
  for (int s = 0; s < kWarpMaxS; ++s) ch[s][0] = ch[s][1] = cl[s][0] = cl[s][1] = 0.f;
  const int w = blockIdx.x * (kWarpItemThreads / 32) + threadIdx.x / 32;
  const int4 zero = make_int4(0, 0, 0, 0);
  WarpCursor cur{-1, 0, zero, zero};
  if (!warp_next(items, n_items, w, W, lane, cur)) return;  // warp-uniform
  static_assert(kWarpStages == 3, "the pipeline keeps kWarpStages - 1 chunks in flight");
  stage(cur, 0);
  cp_async_commit();
  WarpCursor n1 = cur;
  bool has1 = warp_next(items, n_items, w, W, lane, n1);
  if (has1) stage(n1, 1);
  cp_async_commit();
  WarpCursor n2 = n1;
  bool has2 = has1 && warp_next(items, n_items, w, W, lane, n2);
  for (int q = 0;; ++q) {
    if (has2) stage(n2, q + 2);
    cp_async_commit();
    cp_async_wait<kWarpStages - 1>();  // chunk q landed
    __syncwarp();
    const int r = cur.it.y + cur.c * kWarpRows;
    const int nr = min(kWarpRows, cur.it.z - r);
    if (nr > 0) {  // warp-uniform
      unsigned char* st = ring + (q % kWarpStages) * sb;
      const float* as = reinterpret_cast<const float*>(st) + head_floats(a + (size_t)r * S);
      const float* bs = reinterpret_cast<const float*>(st + sa) + head_floats(b + (size_t)r * M);
      // the chunk's split a values, in the tile's place once it is in registers
      float2* ab = reinterpret_cast<float2*>(st + sc);
      if (cur.c == 0) {
        const float* ct = reinterpret_cast<const float*>(st + sc);
#pragma unroll
        for (int s = 0; s < kWarpMaxS; ++s) {
          const float2 c =
              s < S && m < M ? load2(ct + s * M + m) : make_float2(0.f, 0.f);
          const float2 c0 = split_f(c.x), c1 = split_f(c.y);
          ch[s][0] = c0.x;
          cl[s][0] = c0.y;
          ch[s][1] = c1.x;
          cl[s][1] = c1.y;
        }
        __syncwarp();  // the tile is read before ab overwrites it
      }
      // rows of kWarpMaxS pairs, zero past S, so the row loop has no branch
      for (int i = lane; i < nr * kWarpMaxS; i += 32) {
        const int t = i / kWarpMaxS, s = i % kWarpMaxS;
        const float2 h = split_f(s < S ? as[t * S + s] : 0.f);
        ab[i] = make_float2(h.x + h.y, h.x);  // exact
      }
      __syncwarp();
      // kContractRows rows at a time: their da parts reduce-scatter
      // together, each lane ending with one (row, s) total
      for (int t0 = 0; t0 < nr; t0 += kContractRows) {
        float part[kContractRows * kWarpMaxS];
        float d[kContractRows][2];
#pragma unroll
        for (int g = 0; g < kContractRows; ++g) {
          const int t = t0 + g;  // rows past nr read zero b and stale a, and store nothing
          const float2 bv = t < nr && m < M ? load2(bs + t * M + m) : make_float2(0.f, 0.f);
          const float2 b0 = split_f(bv.x), b1 = split_f(bv.y);  // (hi, lo)
          const float s0 = b0.x + b0.y, s1 = b1.x + b1.y;       // exact
          // (hi + lo, hi) of s = 2j, 2j + 1: one address across the warp
          const float4* av4 = reinterpret_cast<const float4*>(ab + t * kWarpMaxS);
          float d0 = 0.f, d1 = 0.f;
#pragma unroll
          for (int j = 0; j < kWarpMaxS / 2; ++j) {
            const float4 av = av4[j];
            const float a_sum[2] = {av.x, av.z}, a_hi[2] = {av.y, av.w};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int s = 2 * j + h;
              d0 = fmaf(ch[s][0], a_sum[h], d0);
              d0 = fmaf(cl[s][0], a_hi[h], d0);
              d1 = fmaf(ch[s][1], a_sum[h], d1);
              d1 = fmaf(cl[s][1], a_hi[h], d1);
              float p = ch[s][0] * s0;
              p = fmaf(cl[s][0], b0.x, p);
              p = fmaf(ch[s][1], s1, p);
              part[g * kWarpMaxS + s] = fmaf(cl[s][1], b1.x, p);
            }
          }
          d[g][0] = d0;
          d[g][1] = d1;
        }
        constexpr int kParts = kContractRows * kWarpMaxS;
        const int v = (lane >> (5 - log2_of<kParts>())) & (kParts - 1);  // this lane's total
        const float das = reduce_scatter<kParts>(part, lane);
        const int gv = v / kWarpMaxS, sv = v % kWarpMaxS;
        if (lane % (32 / kParts) == 0 && sv < S && t0 + gv < nr) {
          da[(size_t)(r + t0 + gv) * S + sv] = das;  // the group's rows: contiguous
        }
#pragma unroll
        for (int g = 0; g < kContractRows; ++g) {
          if (t0 + g < nr && m < M) store2(db + (size_t)(r + t0 + g) * M + m, d[g][0], d[g][1]);
        }
      }
    }
    __syncwarp();  // the stage and the split buffer are read before they are refilled
    if (!has1) break;
    cur = n1;
    n1 = n2;
    has1 = has2;
    if (has2) has2 = warp_next(items, n_items, w, W, lane, n2);
  }
  cp_async_wait<0>();
}

// Launches a warp-per-item kernel (K1's or K4's) over n_items > 0 items.
template <typename T, typename Kernel>
int launch_warp_outer(Kernel kernel, size_t smem, const T* a, const T* b, const int4* items,
                      int n_items, const int4* tree_nodes, const int* tree_parent,
                      int* tree_arrivals, float* partial, T* out, int n_seg, int S, int M,
                      cudaStream_t stream) {
  const int warps = kWarpItemThreads / 32;
  const int blocks = persistent_blocks(kernel, kWarpItemThreads, smem,
                                       (n_items + warps - 1) / warps);
  kernel<<<blocks, kWarpItemThreads, smem, stream>>>(a, b, items, n_items, tree_nodes,
                                                     tree_parent, tree_arrivals, partial, out,
                                                     n_seg, S, M);
  return (int)cudaGetLastError();
}

// K4's forward: the warp kernel (K1's, split3 products) at the triplet
// shape, the ring at the quadruplet shape, the wmma kernel and its merge
// kernel at other shapes
int outer_sum_split3(const float* a, const float* b, const int* items, int n_items,
                     const int* merge_ptr, const int* merge_seg, int n_merge,
                     const int* tree_nodes, const int* tree_parent, int* tree_arrivals,
                     float* partial, float* out, int n, int n_seg, int S, int M,
                     cudaStream_t stream) {
  const bool aligned = aligned16(a) && aligned16(b) && aligned16(out) && aligned16(partial);
  if (warp_outer_shape(S, M) && aligned) {
    if (n_items <= 0) return (int)cudaGetLastError();
    return launch_warp_outer(outer_sum_split3_warp, warp_outer_smem(S, M, sizeof(float), true),
                             a, b, reinterpret_cast<const int4*>(items), n_items,
                             reinterpret_cast<const int4*>(tree_nodes), tree_parent,
                             tree_arrivals, partial, out, n_seg, S, M, stream);
  }
  if (ring_shape(S, M) && aligned) {
    if (n_items > 0) {
      const size_t smem = ring_smem(S, M, kRingSplit3Fwd).total;
      const int blocks = persistent_blocks(outer_sum_split3_ring, kRingThreads, smem, n_items);
      outer_sum_split3_ring<<<blocks, kRingThreads, smem, stream>>>(
          a, b, reinterpret_cast<const int4*>(items), n_items,
          reinterpret_cast<const int4*>(tree_nodes), tree_parent, tree_arrivals, partial, out, n,
          n_seg, S, M);
    }
    return (int)cudaGetLastError();
  }
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

// K4's backward: the warp kernel at the triplet shape, the ring at the
// quadruplet shape (both on 16-byte aligned tensors), the wmma kernel at
// other shapes and on unaligned tensors
int gather_contract_split3(const float* cot, const float* a, const float* b, const int* items,
                           int n_items, float* da, float* db, int n, int n_seg, int S, int M,
                           cudaStream_t stream) {
  const bool aligned = aligned16(cot) && aligned16(a) && aligned16(b) && aligned16(da) &&
                       aligned16(db);
  if (warp_outer_shape(S, M) && aligned) {
    if (n_items > 0) {
      const size_t smem = warp_contract_smem(S, M);
      const int warps = kWarpItemThreads / 32;
      const int blocks = persistent_blocks(gather_contract_split3_warp, kWarpItemThreads, smem,
                                           (n_items + warps - 1) / warps);
      gather_contract_split3_warp<<<blocks, kWarpItemThreads, smem, stream>>>(
          cot, a, b, reinterpret_cast<const int4*>(items), n_items, da, db, n_seg, S, M);
    }
    return (int)cudaGetLastError();
  }
  if (ring_shape(S, M) && aligned) {
    if (n_items > 0) {
      const size_t smem = ring_smem(S, M, kRingSplit3Bwd).total;
      const int blocks =
          persistent_blocks(gather_contract_split3_ring, kRingThreads, smem, n_items);
      gather_contract_split3_ring<<<blocks, kRingThreads, smem, stream>>>(
          cot, a, b, reinterpret_cast<const int4*>(items), n_items, da, db, n, n_seg, S, M);
    }
    return (int)cudaGetLastError();
  }
  const size_t smem = gather_contract_split3_smem(S, M);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  if (n_items > 0) {
    gather_contract_split3_kernel<<<n_items, kThreads, smem, stream>>>(
        cot, a, b, reinterpret_cast<const int4*>(items), da, db, n_seg, S, M);
  }
  return (int)cudaGetLastError();
}

template <int JS>
int launch_ffma(const float* a, const float* b, const int4* items, int n_items,
                const int4* tree_nodes, const int* tree_parent, int* tree_arrivals,
                float* partial, float* out, int n, int n_seg, int S, int M,
                cudaStream_t stream) {
  const size_t smem = ring_smem(S, M, kRingFfma).total;
  const int blocks = persistent_blocks(outer_sum_ffma_ring<JS>, kRingThreads, smem, n_items);
  outer_sum_ffma_ring<JS><<<blocks, kRingThreads, smem, stream>>>(
      a, b, items, n_items, tree_nodes, tree_parent, tree_arrivals, partial, out, n, n_seg, S, M);
  return (int)cudaGetLastError();
}

template <typename T>
int outer_sum(const T* a, const T* b, const int* items, int n_items, const int* merge_ptr,
              const int* merge_seg, int n_merge, const int* tree_nodes, const int* tree_parent,
              int* tree_arrivals, float* partial, T* out, int n, int n_seg, int S, int M,
              cudaStream_t stream) {
  const int4* it = reinterpret_cast<const int4*>(items);
  const int4* tn = reinterpret_cast<const int4*>(tree_nodes);
  if (n_items <= 0) return (int)cudaGetLastError();
  if (warp_outer_shape(S, M) && aligned16(a) && aligned16(b) && aligned16(out) &&
      aligned16(partial)) {
    return launch_warp_outer(outer_sum_warp_kernel<T>, warp_outer_smem(S, M, sizeof(T), false),
                             a, b, it, n_items, tn, tree_parent, tree_arrivals, partial, out,
                             n_seg, S, M, stream);
  }
  const bool ring = aligned16(a) && aligned16(b) && aligned16(out) && aligned16(partial);
  if constexpr (sizeof(T) == sizeof(float)) {
    if (ring && ring_shape(S, M)) {
      switch ((S + 7) / 8) {  // 3 .. 8
        case 3: return launch_ffma<3>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                      partial, out, n, n_seg, S, M, stream);
        case 4: return launch_ffma<4>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                      partial, out, n, n_seg, S, M, stream);
        case 5: return launch_ffma<5>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                      partial, out, n, n_seg, S, M, stream);
        case 6: return launch_ffma<6>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                      partial, out, n, n_seg, S, M, stream);
        case 7: return launch_ffma<7>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                      partial, out, n, n_seg, S, M, stream);
        default: return launch_ffma<8>(a, b, it, n_items, tn, tree_parent, tree_arrivals,
                                       partial, out, n, n_seg, S, M, stream);
      }
    }
  } else {
    if (ring && mma_ring_shape(S, M)) {
      const size_t smem = ring_smem(S, M, kRingMma).total;
      const int blocks = persistent_blocks(outer_sum_mma_ring, kRingThreads, smem, n_items);
      outer_sum_mma_ring<<<blocks, kRingThreads, smem, stream>>>(
          a, b, it, n_items, tn, tree_parent, tree_arrivals, partial, out, n, n_seg, S, M);
      return (int)cudaGetLastError();
    }
  }
  return outer_sum_general<T>(a, b, items, n_items, merge_ptr, merge_seg, n_merge, partial, out,
                              n_seg, S, M, stream);
}

}  // namespace

extern "C" {

// Shared memory (bytes) and threads per block of K1's general kernel (the
// shapes the K1 kernels for the model's shapes do not take; every shape
// they take, the general kernel takes too): the wrapper refuses shapes
// above the 48 KB a block gets without opting in, and 0 threads. K2's
// shared memory is the larger of its fp32 and bf16 kernels' (0 where the
// warp kernel runs it); K2 opts in to more, up to the 227 KB a block may
// take.
size_t gemnet_segment_outer_sum_smem(int S, int M) { return outer_sum_smem(S, M); }

size_t gemnet_segment_gather_contract_smem(int S, int M) {
  return gather_contract_smem(S, M);
}

// G groups of M threads, each group owning at most kMaxSPerThread values
// of s. 0 if no such block fits in 1024 threads.
int gemnet_segment_outer_sum_threads(int S, int M) { return outer_sum_threads(S, M); }

// K1. The kernels of the model's shapes merge a split segment through the
// plan's tree (tree_nodes, tree_parent, tree_arrivals; partial holds its
// n_tree_slots tiles), the general kernel through merge_ptr / merge_seg
// (the first n_partials of those tiles); n is the row count.
int gemnet_segment_outer_sum_f32(const float* a, const float* b, const int* items, int n_items,
                                 const int* merge_ptr, const int* merge_seg, int n_merge,
                                 const int* tree_nodes, const int* tree_parent,
                                 int* tree_arrivals, float* partial, float* out, int n,
                                 int n_seg, int S, int M, cudaStream_t stream) {
  return outer_sum<float>(a, b, items, n_items, merge_ptr, merge_seg, n_merge, tree_nodes,
                          tree_parent, tree_arrivals, partial, out, n, n_seg, S, M, stream);
}

int gemnet_segment_outer_sum_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                  const int* items, int n_items, const int* merge_ptr,
                                  const int* merge_seg, int n_merge, const int* tree_nodes,
                                  const int* tree_parent, int* tree_arrivals, float* partial,
                                  __nv_bfloat16* out, int n, int n_seg, int S, int M,
                                  cudaStream_t stream) {
  return outer_sum<__nv_bfloat16>(a, b, items, n_items, merge_ptr, merge_seg, n_merge,
                                  tree_nodes, tree_parent, tree_arrivals, partial, out, n,
                                  n_seg, S, M, stream);
}

// K2: seg holds the n rows' (sorted) segment ids, items their work items.
int gemnet_segment_gather_contract_f32(const float* cot, const float* a, const float* b,
                                       const long long* seg, const int* items, int n_items,
                                       float* da, float* db, int n, int n_seg, int S, int M,
                                       cudaStream_t stream) {
  return gather_contract<float>(cot, a, b, seg, items, n_items, da, db, n, n_seg, S, M,
                                stream);
}

int gemnet_segment_gather_contract_bf16(const __nv_bfloat16* cot, const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, const long long* seg,
                                        const int* items, int n_items, __nv_bfloat16* da,
                                        __nv_bfloat16* db, int n, int n_seg, int S, int M,
                                        cudaStream_t stream) {
  return gather_contract<__nv_bfloat16>(cot, a, b, seg, items, n_items, da, db, n, n_seg,
                                        S, M, stream);
}

// Shared memory (bytes) of the kernel each entry runs at (S, M) with
// 16-byte aligned tensors; 0 where no kernel takes the shape (more than 48
// KB, or more than 32 forward output tiles, outside the warp kernel's and
// the ring's shapes). Every shape a warp kernel takes (forward or
// backward), the wmma kernel of its direction takes too, for unaligned
// tensors.
size_t gemnet_segment_outer_sum_split3_smem(int S, int M) {
  if (warp_outer_shape(S, M)) return warp_outer_smem(S, M, sizeof(float), true);
  return ring_shape(S, M) ? ring_smem(S, M, kRingSplit3Fwd).total : outer_sum_split3_smem(S, M);
}

size_t gemnet_segment_gather_contract_split3_smem(int S, int M) {
  if (warp_outer_shape(S, M)) return warp_contract_smem(S, M);
  return ring_shape(S, M) ? ring_smem(S, M, kRingSplit3Bwd).total
                           : gather_contract_split3_smem(S, M);
}

// K4 forward. The warp kernel (S <= 8, M <= 64, M % 4 == 0) and the ring
// kernel (16 < S <= 64, M <= 32, M % 4 == 0), on aligned tensors, merge
// through the plan's tree (tree_nodes, tree_parent, tree_arrivals; partial
// holds its n_tree_slots tiles); the kernel of the other shapes through
// merge_ptr / merge_seg (partial: n_partials tiles).
int gemnet_segment_outer_sum_split3(const float* a, const float* b, const int* items,
                                    int n_items, const int* merge_ptr, const int* merge_seg,
                                    int n_merge, const int* tree_nodes, const int* tree_parent,
                                    int* tree_arrivals, float* partial, float* out, int n,
                                    int n_seg, int S, int M, cudaStream_t stream) {
  return outer_sum_split3(a, b, items, n_items, merge_ptr, merge_seg, n_merge, tree_nodes,
                          tree_parent, tree_arrivals, partial, out, n, n_seg, S, M, stream);
}

// K4 backward over the n rows of a and b: the warp kernel (S <= 8, M <= 64,
// M % 4 == 0) and the ring kernel (16 < S <= 64, M <= 32, M % 4 == 0) on
// aligned tensors, the wmma kernel otherwise.
int gemnet_segment_gather_contract_split3(const float* cot, const float* a, const float* b,
                                          const int* items, int n_items, float* da,
                                          float* db, int n, int n_seg, int S, int M,
                                          cudaStream_t stream) {
  return gather_contract_split3(cot, a, b, items, n_items, da, db, n, n_seg, S, M, stream);
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
