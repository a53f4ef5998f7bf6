// Fused MoE router gating: softmax over the experts, top-k, renormalise.
//
// Replaces the Pallas TPU kernel `gating_topk`
// (src/repro/kernels/moe_gating/kernel.py:41, body `_gating_kernel`).
//
// One warp computes one token row; a block holds a few warps and the grid
// strides over the rows when there are more rows than warps.  Lane l holds
// the row's columns l, l + 32, ..., C of them (C = ceil(E / 32) <= 8, a
// template parameter), loaded straight from device memory: one 128-byte
// row per warp at E = 32.  No shared memory, no __syncthreads.  Then:
//
// * the row max, propagating NaN as torch.amax and jnp.max do: each lane's
//   own max, then one `redux.sync` over the lanes on an order-preserving
//   unsigned key of the float (NaN above everything);
// * p = expf(l - m) per element;
// * the sum: each lane adds its own columns in index order, then an XOR
//   butterfly over 16, 8, 4, 2, 1 lanes (float addition is commutative,
//   so every lane ends with the same bits); columns past E add 0.  This
//   order is `ref.lane_butterfly_sum`'s;
// * probs = p / sum (IEEE division);
// * k warp-argmax passes over one 64-bit key per element: the probability's
//   bits high (probabilities are >= 0, so their bits sort as the values;
//   NaN takes 0xffffffff, above every number) and ~index low, so the first
//   of equal values wins, as torch.argmax and jnp.argmax choose.  Each pass
//   takes each lane's largest key, then two `redux.sync` max steps (high
//   word, then the low word among the lanes that hold that high word); the
//   lane that owns the winner hands its probability to the warp by shuffle
//   and zeroes the key (0 is below every element's key, so a removed entry
//   never wins again; the plain version's -1e30 could not serve here: its
//   bits, read as unsigned, sort above every positive float);
// * the k gates are summed in the order they are found and divided by
//   max(total, 1e-9), NaN propagating as torch.clamp_min does; lanes
//   0..k-1 store the gate and id of rank `lane`, one store per row.
//
// What bounds it: bytes, by the count (N * E * 4 bytes in, N * k * 8 out:
// 0.06 us at the main path's N = 1024, E = 32, k = 8).  In practice a
// launch at that size is set by the launch itself and by one row's chain
// of dependent warp steps (a reduction, a butterfly and k passes of a few
// steps each); the design keeps that chain short and spreads the rows
// over every SM.
//
// Numerics follow the plain version (ref.py) operation for operation:
// build with -fmad=false, IEEE division (the nvcc default), `expf` (the
// CUDA library's, as torch.exp on the card) and no fast math; the sums
// run in the plain version's order.  Gates and ids are then bitwise the
// plain version's on the card.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTopK = 8;
constexpr int kMaxCols = 8;            // 256 experts over 32 lanes
constexpr unsigned kAll = 0xffffffffu;

// Order-preserving unsigned key of a float for the row max: larger floats
// give larger keys, NaN the largest; 0 is below every float's key.
__device__ __forceinline__ unsigned max_key(float v) {
  const unsigned u = __float_as_uint(v);
  if (v != v) return kAll;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_max_key(unsigned k) {
  if (k == kAll) return __uint_as_float(0x7fffffffu);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Selection key of a probability p >= 0 (or NaN) at column e.
__device__ __forceinline__ uint64_t pick_key(float p, int e) {
  const unsigned hi = (p != p) ? kAll : __float_as_uint(p);
  return (static_cast<uint64_t>(hi) << 32) | static_cast<unsigned>(~e);
}

template <int C>
__global__ void __launch_bounds__(128)
gating_topk_warp_kernel(int n_rows, int n_experts, int top_k,
                        const float* __restrict__ logits,  // [N, E]
                        float* __restrict__ gate,          // [N, k]
                        int32_t* __restrict__ idx) {       // [N, k]
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       row < n_rows; row += warps) {
    const float* src = logits + row * n_experts;
    float v[C];
    unsigned mk = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = lane + 32 * c;
      v[c] = e < n_experts ? src[e] : 0.0f;
      if (e < n_experts) mk = max(mk, max_key(v[c]));
    }
    const float m = from_max_key(__reduce_max_sync(kAll, mk));

    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = lane + 32 * c;
      v[c] = e < n_experts ? expf(v[c] - m) : 0.0f;
      sum = c == 0 ? v[0] : sum + v[c];
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      sum = sum + __shfl_xor_sync(kAll, sum, off);

    uint64_t key[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int e = lane + 32 * c;
      v[c] = v[c] / sum;
      key[c] = e < n_experts ? pick_key(v[c], e) : 0;
    }

    float total = 0.0f, my_g = 0.0f;
    int my_id = 0;
#pragma unroll
    for (int j = 0; j < kMaxTopK; ++j) {
      if (j < top_k) {
        uint64_t best = key[0];
#pragma unroll
        for (int c = 1; c < C; ++c) best = key[c] > best ? key[c] : best;
        const unsigned best_hi = static_cast<unsigned>(best >> 32);
        const unsigned hi = __reduce_max_sync(kAll, best_hi);
        const unsigned lo = __reduce_max_sync(
            kAll, best_hi == hi ? static_cast<unsigned>(best) : 0u);
        const int e = static_cast<int>(~lo);
        float mine = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (static_cast<unsigned>(key[c]) == lo) {   // ~e: one per row
            mine = v[c];
            key[c] = 0;
          }
        }
        const float g = __shfl_sync(kAll, mine, e & 31);
        total = total + g;
        if (lane == j) {
          my_g = g;
          my_id = e;
        }
      }
    }
    const float denom = total != total ? total : fmaxf(total, 1e-9f);
    if (lane < top_k) {
      gate[row * top_k + lane] = my_g / denom;
      idx[row * top_k + lane] = my_id;
    }
  }
}

template <int C>
int launch(int n_rows, int n_experts, int top_k, int warps, int blocks,
           const void* logits, void* gate, void* idx, cudaStream_t stream) {
  gating_topk_warp_kernel<C><<<blocks, 32 * warps, 0, stream>>>(
      n_rows, n_experts, top_k, static_cast<const float*>(logits),
      static_cast<float*>(gate), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  `cols` = ceil(E / 32) columns per lane,
// `warps` warps (token rows at a time) per block, `blocks` blocks; the
// wrapper's `launch_shape` chooses them.  Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gating_topk_launch(int n_rows, int n_experts, int top_k,
                                  int cols, int warps, int blocks,
                                  const void* logits, void* gate, void* idx,
                                  void* stream) {
  if (n_experts < 1 || n_experts > 32 * cols || n_experts <= 32 * (cols - 1) ||
      top_k < 1 || top_k > kMaxTopK || top_k > n_experts || warps < 1 ||
      32 * warps > 128 || blocks < 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cols) {
    case 1: return launch<1>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 2: return launch<2>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 3: return launch<3>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 4: return launch<4>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 5: return launch<5>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 6: return launch<6>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case 7: return launch<7>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    case kMaxCols: return launch<kMaxCols>(n_rows, n_experts, top_k, warps, blocks, logits, gate, idx, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
