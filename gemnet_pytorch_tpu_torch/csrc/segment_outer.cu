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

namespace {

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

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
