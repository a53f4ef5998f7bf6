// Fused MoE router gating: softmax over the experts, top-k, renormalise.
//
// Replaces the Pallas TPU kernel `gating_topk`
// (src/repro/kernels/moe_gating/kernel.py:41, body `_gating_kernel`).
//
// One thread computes one token row.  A block of `rows` threads first
// copies its rows' logits, a contiguous run of rows * E floats, into
// shared memory with coalesced loads, each row at an odd stride so that
// the threads of a warp, each walking its own row, hit distinct banks.
// The thread then works on its row in place: the row max, p = exp(l - m),
// the sum of p over the experts in index order, probs = p / sum; then k
// argmax passes over the row with a strict `>`, so the first maximum
// wins (ties go to the lowest index, as in `lax.top_k` and the TPU
// kernel), each writing -1e30 over its winner; the k gates are summed as
// they are found and divided by max(total, 1e-9).  The ids and gates stay
// in registers until they are written out.
//
// What bounds it: bytes, by the count (N * E * 4 bytes in, N * k * 8
// out: 0.06 us at the main path's N = 1024, E = 32, k = 8).  In practice
// a launch at that size is set by the latency of one thread's chain of
// ~E * (k + 3) dependent shared-memory steps and by the launch itself;
// at a few rows per decode step only the launch counts.  The design keeps
// the row on chip from the one read to the one write.
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
constexpr float kNegInf = -1e30f;

__global__ void gating_topk_kernel(int n_rows, int n_experts, int top_k,
                                   int stride,
                                   const float* __restrict__ logits,  // [N, E]
                                   float* __restrict__ gate,          // [N, k]
                                   int32_t* __restrict__ idx) {       // [N, k]
  extern __shared__ float tile[];  // [rows, stride]
  const int rows = blockDim.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows;
  const int64_t left = static_cast<int64_t>(n_rows) - row0;
  const int here = left < rows ? static_cast<int>(left) : rows;
  const int count = here * n_experts;
  const float* src = logits + row0 * n_experts;
  for (int i = threadIdx.x; i < count; i += rows) {
    const int r = i / n_experts;
    tile[r * stride + (i - r * n_experts)] = src[i];
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= here) return;
  float* p = tile + r * stride;

  float m = p[0];
  for (int e = 1; e < n_experts; ++e) m = fmaxf(m, p[e]);
  float sum = 0.0f;
  for (int e = 0; e < n_experts; ++e) {
    const float v = expf(p[e] - m);
    p[e] = v;
    sum = sum + v;
  }
  for (int e = 0; e < n_experts; ++e) p[e] = p[e] / sum;

  float g[kMaxTopK];
  int id[kMaxTopK];
  float total = 0.0f;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    if (j < top_k) {
      int best = 0;
      float bv = p[0];
      for (int e = 1; e < n_experts; ++e) {
        const float v = p[e];
        if (v > bv) {
          bv = v;
          best = e;
        }
      }
      g[j] = bv;
      id[j] = best;
      total = total + bv;
      p[best] = kNegInf;
    }
  }
  const float denom = fmaxf(total, 1e-9f);
  const int64_t out = (row0 + r) * top_k;
#pragma unroll
  for (int j = 0; j < kMaxTopK; ++j) {
    if (j < top_k) {
      gate[out + j] = g[j] / denom;
      idx[out + j] = id[j];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes.  `rows` threads per block, `rows *
// stride * 4` bytes of dynamic shared memory (the wrapper keeps it within
// the 48 KiB a launch may take without opting in).  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError()
// after the launch.
extern "C" int gating_topk_launch(int n_rows, int n_experts, int top_k,
                                  int rows, int stride, const void* logits,
                                  void* gate, void* idx, void* stream) {
  const int blocks = (n_rows + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(rows) * stride * sizeof(float);
  gating_topk_kernel<<<blocks, rows, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_experts, top_k, stride, static_cast<const float*>(logits),
      static_cast<float*>(gate), static_cast<int32_t*>(idx));
  return static_cast<int>(cudaGetLastError());
}
