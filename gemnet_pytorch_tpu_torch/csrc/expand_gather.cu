// Sorted segment sum with a fused permute, fp32 and bf16 rows, for sm_90a.
//
// K3 gemnet_sorted_segsum_{f32,bf16}
//     out[e, m] = sum_{t : sorted_ids[t] = e} x[perm[t], m]
//   the VJP of every sorted expand gather x = table[idx]; replaces
//   gemnet_pytorch_tpu/ops/pallas/expand_gather.py::_segsum_pallas (its inner
//   `kernel`), together with the `x[perm]` gather that precedes it there.
//
// Types follow the JAX package's contract (expand_gather.py:61-68,83-86,177):
// fp32 rows give an fp32 output; bf16 rows (compute_dtype="bfloat16") are
// widened to fp32, summed in fp32, and the store rounds once to bf16. The
// partial rows of a split segment stay fp32 until the merge rounds their sum.
// The geometry streams of the force path (M = 3, 4) are fp32 in both modes.
//
// What bounds it on an H100: bytes, at one add per row element read. The
// least traffic is x (n*M) and perm (n) once, and out (nSeg*M) once: ~29 MB
// at the quad_abd shape (192512 x 32 -> 29184 x 32) in fp32, ~17 MB in bf16.
//
// Design: one launch, one warp per work item. The host cuts each segment's
// sorted rows into items of at most 64 rows (data/batch.py::segment_plan):
// items[i] = {segment, first row, end row, partial slot}; a padding item
// of a capacity plan (segment -1) returns at once. A warp loads the
// perm entries of 64 rows with two coalesced loads, ahead of the row loads,
// and hands them out by shuffle. Rows are read whole and vectorised: the
// warp's lanes split into R row groups of L lanes, each lane loading V
// values of a row with one load (16 bytes where M and the alignment allow:
// 4 fp32 or 8 bf16; M = 3 and 4 give one thread a whole row), and each lane
// issues up to 32 registers' worth of such loads before it adds any (bf16
// pairs stay packed until then: 8 rows of 16 bytes, or 16 rows), so a 64-row
// item costs a few memory latencies, not one per row; 64 registers a thread
// keep 32 warps per SM. The row groups' sums meet
// in a fixed shuffle tree (shared memory, in group order, where L is no
// power of two).
//
// An item of an unsplit segment writes its output row. The padded rows of a
// batch all share one segment id (~9600 rows at the bench quad shape); its
// items write fp32 partial rows, and the last of them to finish merges them:
// each such warp fences its partial row, counts itself in the segment's
// arrival counter (plan.arrivals, int32, zero between launches), and the
// warp that arrives last reads the segment's partial slots in a fixed order
// (slot k by row group (k - k0) mod R, the groups then combined as above),
// writes the output row and resets the counter to zero for the next launch.
// No float atomics: every output is written once, and its sum is taken in
// an order fixed by the plan, so two launches give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }

// V consecutive values at p (aligned to V elements where V is a power of
// two), widened to fp32, in one load where V is 2, 4 or 8.
template <int V>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* __restrict__ p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
    v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z); v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x); v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  } else if constexpr (V == 2) {
    const unsigned q = *reinterpret_cast<const unsigned*>(p);
    v[0] = bf16_lo(q); v[1] = bf16_hi(q);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __bfloat162float(p[j]);
  }
}

// A lane's V values of one row as loaded: packed bf16 pairs where V is even
// (half the registers of widened values, so twice the rows in flight), else
// fp32; widened as they are added.
template <typename T, int V, bool kPacked = sizeof(T) == 2 && V % 2 == 0>
struct RowBits {
  static constexpr int kWords = V;
  float v[V];
  __device__ __forceinline__ void load(const T* __restrict__ p) { load_vec<V>(p, v); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
  __device__ __forceinline__ void add_to(float (&acc)[V]) const {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] += v[j];
  }
};

template <typename T, int V>
struct RowBits<T, V, true> {
  static constexpr int kWords = V / 2;
  unsigned w[V / 2];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (V == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (V == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    } else {
      w[0] = *reinterpret_cast<const unsigned*>(p);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < V / 2; ++j) w[j] = 0u;
  }
  __device__ __forceinline__ void add_to(float (&acc)[V]) const {
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      acc[2 * j] += bf16_lo(w[j]);
      acc[2 * j + 1] += bf16_hi(w[j]);
    }
  }
};

// V fp32 values of a partial row, from L2 (other SMs wrote them).
template <int V>
__device__ __forceinline__ void load_partial(const float* __restrict__ p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + j));
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = __ldcg(p + j);
  }
}

// The sum over the warp's R row groups of each lane's V accumulators,
// returned to the lanes of group 0 (lane < L), in a fixed order: a shuffle
// tree where L is a power of two (then R * L = 32), else the groups in
// order through `red` (32 * V floats of this warp).
template <int V>
__device__ __forceinline__ void reduce_groups(float (&acc)[V], float* red, int lane, int L,
                                              int R) {
  if ((L & (L - 1)) == 0) {
    for (int o = 16; o >= L; o >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], o);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) red[lane * V + j] = acc[j];
  __syncwarp();
  if (lane < L) {
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = red[lane * V + j];
    for (int g = 1; g < R; ++g) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += red[(g * L + lane) * V + j];
    }
  }
  __syncwarp();  // red is read before it is written again
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 4)
sorted_segsum_kernel(const T* __restrict__ x, const int* __restrict__ perm,
                     const int4* __restrict__ items, int n_items,
                     const int* __restrict__ merge_ptr, int n_merge,
                     int* __restrict__ arrivals, float* __restrict__ partial,
                     T* __restrict__ out, int M) {
  // rows in flight per lane: up to 32 registers of loaded values (16 rows
  // at most); the merge reads fp32 partial rows
  using Bits = RowBits<T, V>;
  constexpr int kBatch = 32 / Bits::kWords < 16 ? 32 / Bits::kWords : 16;
  constexpr int kMergeBatch = 32 / V < 16 ? 32 / V : 16;
  __shared__ float red_all[kWarps][32 * V];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n_items) return;  // warp-uniform; the kernel has no block barrier
  float* red = red_all[warp];
  const int4 item = items[i];  // segment, row0, row1, slot
  if (item.x < 0) return;      // a padding item of a capacity plan (warp-uniform)
  const int nv = M / V;        // vectors per row

  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int L = min(32, nv - c0);  // lanes per row
    const int R = 32 / L;            // row groups
    const int g = lane / L;
    const bool active = g < R;
    const int col = (c0 + lane % L) * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int base = item.y; base < item.z; base += 64) {
      const int nr = min(64, item.z - base);
      // the perm entries of 64 rows, ahead of the row loads
      const int p0 = lane < nr ? perm[base + lane] : 0;
      const int p1 = lane + 32 < nr ? perm[base + 32 + lane] : 0;
      const int n_loads = (nr + R - 1) / R;  // per lane; warp-uniform
      for (int k0 = 0; k0 < n_loads; k0 += kBatch) {
        const int nu = min(kBatch, n_loads - k0);
        Bits v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u >= nu) break;
          const int t = g + (k0 + u) * R;
          const int s0 = __shfl_sync(kFull, p0, t & 31);
          const int s1 = __shfl_sync(kFull, p1, t & 31);
          if (active && t < nr) {
            v[u].load(x + (size_t)(t < 32 ? s0 : s1) * M + col);
          } else {
            v[u].zero();
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (u >= nu) break;
          v[u].add_to(acc);
        }
      }
    }
    reduce_groups<V>(acc, red, lane, L, R);
    if (lane < L) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (item.w < 0) {
          out[(size_t)item.x * M + col + j] = narrow<T>(acc[j]);
        } else {
          partial[(size_t)item.w * M + col + j] = acc[j];
        }
      }
    }
  }
  if (item.w < 0) return;

  // a split segment: the last of its items to finish merges its partials
  __threadfence();
  __syncwarp();
  int last = 0;
  if (lane == 0) {
    int lo = 0, hi = n_merge - 1;  // the split segment j with merge_ptr[j] <= slot
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (merge_ptr[mid] <= item.w) lo = mid; else hi = mid - 1;
    }
    const int n_slots = merge_ptr[lo + 1] - merge_ptr[lo];
    if (atomicAdd(&arrivals[lo], 1) == n_slots - 1) last = lo + 1;
  }
  last = __shfl_sync(kFull, last, 0);
  if (!last) return;
  const int j = last - 1;
  __threadfence();
  const int k0 = merge_ptr[j], k1 = merge_ptr[j + 1];
  for (int c0 = 0; c0 < nv; c0 += 32) {
    const int L = min(32, nv - c0);
    const int R = 32 / L;
    const int g = lane / L;
    const int col = (c0 + lane % L) * V;
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int kb = k0; kb < k1; kb += kMergeBatch * R) {  // warp-uniform trip count
      const int nu = min(kMergeBatch, (k1 - kb + R - 1) / R);
      float v[kMergeBatch][V];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (u >= nu) break;
        const int k = kb + g + u * R;
        if (g < R && k < k1) {
          load_partial<V>(partial + (size_t)k * M + col, v[u]);
        } else {
#pragma unroll
          for (int q = 0; q < V; ++q) v[u][q] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        if (u >= nu) break;
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] += v[u][q];
      }
    }
    reduce_groups<V>(acc, red, lane, L, R);
    if (lane < L) {
#pragma unroll
      for (int q = 0; q < V; ++q) out[(size_t)item.x * M + col + q] = narrow<T>(acc[q]);
    }
  }
  if (lane == 0) arrivals[j] = 0;  // zero for the next launch on this stream
}

template <typename T, int V>
void launch(const T* x, const int* perm, const int* items, int n_items, const int* merge_ptr,
            int n_merge, int* arrivals, float* partial, T* out, int M, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n_items + kWarps - 1) / kWarps);
  sorted_segsum_kernel<T, V><<<blocks, kThreads, 0, stream>>>(
      x, perm, reinterpret_cast<const int4*>(items), n_items, merge_ptr, n_merge, arrivals,
      partial, out, M);
}

// Values per lane load: 3 for M = 3 (a whole row); else the widest power of
// two up to 16 bytes that divides M and the alignment of x.
int vec_width(int M, const void* x, int elem_bytes) {
  if (M == 3) return 3;
  const unsigned long long addr = reinterpret_cast<unsigned long long>(x);
  for (int v = 16 / elem_bytes; v > 1; v /= 2) {
    if (M % v == 0 && addr % (unsigned long long)(v * elem_bytes) == 0) return v;
  }
  return 1;
}

template <typename T>
int sorted_segsum(const T* x, const int* perm, const int* items, int n_items,
                  const int* merge_ptr, int n_merge, int* arrivals, float* partial, T* out,
                  int M, cudaStream_t stream) {
  if (n_items <= 0 || M <= 0) return (int)cudaGetLastError();
  const int V = vec_width(M, x, (int)sizeof(T));
  switch (V) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        launch<T, 8>(x, perm, items, n_items, merge_ptr, n_merge, arrivals, partial, out, M,
                     stream);
      }
      break;
    case 4:
      launch<T, 4>(x, perm, items, n_items, merge_ptr, n_merge, arrivals, partial, out, M,
                   stream);
      break;
    case 3:
      launch<T, 3>(x, perm, items, n_items, merge_ptr, n_merge, arrivals, partial, out, M,
                   stream);
      break;
    case 2:
      launch<T, 2>(x, perm, items, n_items, merge_ptr, n_merge, arrivals, partial, out, M,
                   stream);
      break;
    default:
      launch<T, 1>(x, perm, items, n_items, merge_ptr, n_merge, arrivals, partial, out, M,
                   stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gemnet_sorted_segsum_f32(const float* x, const int* perm, const int* items,
                             int n_items, const int* merge_ptr, int n_merge,
                             int* arrivals, float* partial, float* out, int M,
                             cudaStream_t stream) {
  return sorted_segsum<float>(x, perm, items, n_items, merge_ptr, n_merge, arrivals,
                              partial, out, M, stream);
}

int gemnet_sorted_segsum_bf16(const __nv_bfloat16* x, const int* perm, const int* items,
                              int n_items, const int* merge_ptr, int n_merge,
                              int* arrivals, float* partial, __nv_bfloat16* out, int M,
                              cudaStream_t stream) {
  return sorted_segsum<__nv_bfloat16>(x, perm, items, n_items, merge_ptr, n_merge,
                                      arrivals, partial, out, M, stream);
}

const char* gemnet_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
