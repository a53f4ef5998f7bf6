// SSD intra-chunk pass of the Mamba2 mixer (state-space duality).
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk`
// (src/repro/kernels/ssd_scan/kernel.py:52, body `_ssd_kernel`).  For one
// (batch, chunk, head), with Q steps in the chunk and acum the running sum
// of log_a over the chunk, it computes in float32
//   y[q]  = sum_{k<=q} (C_q . B_k) * exp(acum_q - acum_k) * xdt_k   [Q, hd]
//   h     = sum_k exp(acum_{Q-1} - acum_k) * xdt_k (x) B_k          [hd, st]
//   a     = exp(acum_{Q-1})
// reading xdt, B and C in the model's type (float or bfloat16).  The
// inter-chunk recurrence runs outside, in ops.py.
//
// Design: one block of 256 threads per (batch, chunk, head).  The chunk's
// xdt (this head), B and C are staged in shared memory in their own type
// (the conversion to float is exact), with B and C rows padded to an odd
// number of words so that 32 lanes reading 32 rows hit 32 banks.  The
// Pallas blocking is not carried over: its [Q, Q, heads] float decay tile
// does not fit an SM.  Instead the y phase walks the keys in tiles of 32:
// the block writes W[q][k] = (C_q . B_k) * exp(acum_q - acum_k) for the
// tile into shared memory, then each thread adds W * xdt into the outputs
// it owns (rows q0, q0 + 256/hd, ...; one column d), held in registers.
// Keys after q are skipped: the Pallas body's -1e9 mask gives exactly 0
// there.  The h phase gives each thread columns s and rows d of h.  At
// Q=128, hd=64, st=128 in bfloat16 a block needs 98.5 KiB of shared memory,
// so two blocks share an SM.
//
// What bounds it: operations.  At the main path's shapes (S=1024, 80 heads)
// it does ~2 GFLOP on ~53 MB, all on the CUDA cores in float32; the
// tensor cores, wgmma and TMA are later work.  C . B is recomputed per
// head (the heads of a chunk share it), which the bound does not count.
//
// Numerics: every sum runs in a fixed order (the prefix sum by one thread,
// C . B over the state index, y and h over the keys, each ascending), and
// the library is built with -fmad=false and no fast math, so each step is
// one IEEE float multiply or add and `expf` is the accurate one.  The plain
// version (ref.py `reference_intra_chunk`) performs the same operations in
// the same order with whole-tensor ops, so the two agree bitwise on the
// card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 32;            // keys per W tile
constexpr int kLdw = kTileK + 1;      // padded W row (floats)
constexpr int kMaxChunk = 256;
constexpr int kMaxSmem = 232448;      // H100: 227 KiB per block, opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Row stride of the staged B and C, in elements: one extra word per row.
__host__ __device__ int padded_state(int st, int elem) {
  return st + 4 / elem;
}

int64_t smem_bytes(int Q, int hd, int st, int elem) {
  return static_cast<int64_t>(Q) * (2 + kLdw) * 4 +
         static_cast<int64_t>(Q) * (hd + 2 * padded_state(st, elem)) * elem;
}

template <typename T, int ACC>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(int S, int nh, int hd, int st, int Q,
                       const T* __restrict__ xdt,        // [B, S, nh, hd]
                       const float* __restrict__ log_a,  // [B, S, nh]
                       const T* __restrict__ bmat,       // [B, S, st]
                       const T* __restrict__ cmat,       // [B, S, st]
                       float* __restrict__ y,            // [B, S, nh, hd]
                       float* __restrict__ h_out,        // [B, nC, nh, hd, st]
                       float* __restrict__ a_out) {      // [B, nC, nh]
  extern __shared__ __align__(16) unsigned char smem[];
  const int head = blockIdx.x, chunk = blockIdx.y, batch = blockIdx.z;
  const int nC = gridDim.y;
  const int ldb = padded_state(st, static_cast<int>(sizeof(T)));
  float* acum = reinterpret_cast<float*>(smem);   // [Q]
  float* tail = acum + Q;                         // [Q]
  float* w = tail + Q;                            // [Q][kLdw]
  T* xs = reinterpret_cast<T*>(w + Q * kLdw);     // [Q][hd]
  T* bs = xs + Q * hd;                            // [Q][ldb]
  T* cs = bs + Q * ldb;                           // [Q][ldb]

  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(batch) * S +
                       static_cast<int64_t>(chunk) * Q;
  for (int e = tid; e < Q * hd; e += kThreads) {
    const int k = e / hd, d = e - k * hd;
    xs[e] = xdt[((row0 + k) * nh + head) * hd + d];
  }
  for (int e = tid; e < Q * st; e += kThreads) {
    const int k = e / st, s = e - k * st;
    bs[k * ldb + s] = bmat[(row0 + k) * st + s];
    cs[k * ldb + s] = cmat[(row0 + k) * st + s];
  }
  for (int k = tid; k < Q; k += kThreads)
    acum[k] = log_a[(row0 + k) * nh + head];
  __syncthreads();
  if (tid == 0) {                       // prefix sum, in order
    float run = acum[0];
    for (int k = 1; k < Q; ++k) {
      run = run + acum[k];
      acum[k] = run;
    }
  }
  __syncthreads();
  const float last = acum[Q - 1];
  for (int k = tid; k < Q; k += kThreads) tail[k] = expf(last - acum[k]);
  if (tid == 0)
    a_out[(static_cast<int64_t>(batch) * nC + chunk) * nh + head] =
        expf(last);

  // ---- y: thread owns column d of rows q0, q0 + qs, ...
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  {
    const int d = tid % hd, q0 = tid / hd, qs = kThreads / hd;
    for (int k0 = 0; k0 < Q; k0 += kTileK) {
      const int kn = min(kTileK, Q - k0);
      for (int e = tid; e < Q * kTileK; e += kThreads) {
        const int q = e / kTileK, kk = e - q * kTileK, k = k0 + kk;
        if (kk >= kn || k > q) continue;
        const T* cq = cs + q * ldb;
        const T* bk = bs + k * ldb;
        float s = 0.f;
        for (int j = 0; j < st; ++j) s = s + to_f32(cq[j]) * to_f32(bk[j]);
        w[q * kLdw + kk] = s * expf(acum[q] - acum[k]);
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        const float xk = to_f32(xs[k * hd + d]);
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int q = q0 + i * qs;
          if (q < Q && k <= q) acc[i] = acc[i] + w[q * kLdw + kk] * xk;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int q = q0 + i * qs;
      if (q < Q) y[((row0 + q) * nh + head) * hd + d] = acc[i];
    }
  }

  // ---- h: thread owns column s of rows d0, d0 + ds, ...
  {
    const int s = tid % st, d0 = tid / st, ds = kThreads / st;
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
    for (int k = 0; k < Q; ++k) {
      const float bk = to_f32(bs[k * ldb + s]);
      const float tk = tail[k];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int d = d0 + i * ds;
        if (d < hd) acc[i] = acc[i] + (tk * to_f32(xs[k * hd + d])) * bk;
      }
    }
    float* hb = h_out +
        ((static_cast<int64_t>(batch) * nC + chunk) * nh + head) * hd * st;
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int d = d0 + i * ds;
      if (d < hd) hb[d * st + s] = acc[i];
    }
  }
}

template <typename T, int ACC>
cudaError_t launch(int B, int S, int nh, int hd, int st, int Q,
                   const void* xdt, const void* log_a, const void* b,
                   const void* c, void* y, void* h, void* a,
                   cudaStream_t stream) {
  auto kernel = ssd_intra_chunk_kernel<T, ACC>;
  const int64_t smem = smem_bytes(Q, hd, st, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(nh, S / Q, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      S, nh, hd, st, Q, static_cast<const T*>(xdt),
      static_cast<const float*>(log_a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y),
      static_cast<float*>(h), static_cast<float*>(a));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (elem: 4 float, 2 bfloat16).
long long ssd_intra_chunk_smem_bytes(int Q, int hd, int st, int elem) {
  return smem_bytes(Q, hd, st, elem);
}

// dtype: 0 float32, 1 bfloat16 (xdt, b, c); log_a and the outputs are
// float32.  S is a multiple of Q.  Returns a cudaError_t (0 = launched).
int ssd_intra_chunk_launch(int dtype, int B, int S, int nh, int hd, int st,
                           int Q, const void* xdt, const void* log_a,
                           const void* b, const void* c, void* y, void* h,
                           void* a, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  // outputs a thread holds: rows of y, then rows of h
  const int per_thread =
      (std::max(Q * hd, hd * st) + kThreads - 1) / kThreads;
  if ((dtype != 0 && dtype != 1) || Q < 1 || Q > kMaxChunk || S % Q ||
      kThreads % hd || kThreads % st || per_thread > 64 ||
      smem_bytes(Q, hd, st, elem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return per_thread <= 32
        ? launch<float, 32>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y, h, a, s)
        : launch<float, 64>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y, h, a, s);
  return per_thread <= 32
      ? launch<__nv_bfloat16, 32>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y,
                                  h, a, s)
      : launch<__nv_bfloat16, 64>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y,
                                  h, a, s);
}

}  // extern "C"
