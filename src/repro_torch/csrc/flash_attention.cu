// Flash attention forward (BHSD layout, grouped-query heads) for the dense
// models' scoring forward.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py:67, body `_flash_kernel`).
// For q [B, H, Sq, hd] and k, v [B, Hk, Skv, hd] (Sq and Skv padded by the
// wrapper; keys at or past kv_len masked), query head h reads K/V head
// h / G, G = H / Hk.  Per query row, in float32, over the keys in tiles of
// `bk` (the wrapper's block size, 8 to 128), exactly as `_flash_kernel`:
//   s      = (q * hd^-1/2) . k          masked to -1e30 where col >= kv_len
//                                       or (causal and row < col)
//   m_new  = max(m, rowmax s),  corr = exp(m - m_new),  p = exp(s - m_new)
//   l      = l * corr + sum p,  acc = acc * corr + p . v,  m = m_new
//   o      = acc / max(l, 1e-30)        stored in q's type
// The online-softmax update runs once per `bk` keys, as the TPU kernel's
// grid step does, so the kernel and its plain version (ref.py
// `reference_flash_bhsd`) differ only in the order of the dot-product and
// row sums inside a tile.  There is no backward: the TPU kernel has none.
//
// Design (a first, simple version: float32 on the CUDA cores):
// * One block of 256 threads per (64 query rows, head, batch); the heaviest
//   q-tiles (last rows under the causal mask) are scheduled first.  The
//   q-tile, times hd^-1/2, is staged once in shared memory as float rows
//   padded to hd + 4 (16-byte loads, no bank conflicts over hd).
// * A thread owns rows ty + 16 i (i < 4) and score columns tx + 16 j of
//   each key tile (j < 8, up to 128 keys); the 16 threads of a row are one
//   half-warp, so row max and sum are warp shuffles.  Keys are staged 64
//   at a time (K, then V, in one float buffer), the probabilities go
//   through shared memory into P . V, and the output rows (4 x hd/16 per
//   thread), m and l stay in registers.  ~99 KB of shared memory at
//   hd 128: two blocks per SM.
// * Causal skipping is exact: every row sees key 0 in the first tile, so m
//   is finite after it, and in a tile (or a 64-key half of one) wholly
//   above the diagonal p = exp(-1e30 - m) = 0 and corr = 1, which changes
//   no bit.  Such keys are neither loaded nor multiplied.
//
// What bounds it at the scoring path's shapes (B 4, H 16, Hk 8, hd 128,
// S 4096, causal): operations.  4 hd flop per causal (row, key) pair,
// 2.75e11 flop: 278 us on the bf16 tensor cores (989 TFLOP/s), 4.1 ms in
// float32 on the CUDA cores (67 TFLOP/s); q, k, v and o are 201 MB, 60 us
// at 3.35 TB/s.  This version runs float32 FMAs on the CUDA cores, so its
// floor is the 4.1 ms figure; wgmma with bf16 operands, TMA and K/V loaded
// once per GQA group are later work (they would round q * scale and p to
// bf16, which the comparison with the plain version would then allow).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;              // query rows per block
constexpr int kChunk = 64;             // keys staged at a time
constexpr int kMaxBk = 128;            // largest key tile (score columns)
constexpr int kLdp = kMaxBk + 4;       // padded row of the probability tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);            // round to nearest even, as torch
}

template <int HD>
struct Dims {
  static constexpr int kLd = HD + 4;               // padded float row
  static constexpr int kCols = HD / 16;            // output columns a thread
  static constexpr int kVec = kCols < 4 ? kCols : 4;
  static constexpr int kNVec = kCols / kVec;
};

__host__ __device__ constexpr int smem_floats(int hd) {
  return 2 * kRows * (hd + 4) + kRows * kLdp;      // q, K/V chunk, P
}
// Two blocks of the largest head dim share an SM's 228 KB.
static_assert(2 * smem_floats(128) * 4 <= 227 * 1024,
              "two blocks at hd 128 exceed an H100 SM's shared memory");

// Rows row0 .. row0 + n - 1 (n <= 64) of a [n_rows, HD] matrix into a
// float tile, times `scale`; rows at or past n_rows read as zero.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const T* __restrict__ src,
                                          int row0, int n, int n_rows,
                                          float scale) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPerRow = HD / kPer;
  for (int i = threadIdx.x; i < n * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kPer;
    float vals[kPer];
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) vals[j] = to_f32(e[j]) * scale;
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) vals[j] = 0.f;
    }
    float* out = dst + r * Dims<HD>::kLd + c;
#pragma unroll
    for (int j = 0; j < kPer; j += 4)
      *reinterpret_cast<float4*>(out + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  }
}

// s[i][j] = Q[ty + 16 i] . K[tx + 16 j] over HD for one 64-key chunk.
template <int HD>
__device__ __forceinline__ void scores(const float* Q, const float* K,
                                       float* s, int ty, int tx) {
  constexpr int kLd = Dims<HD>::kLd;
  float c[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Q + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(K + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i * 8 + j] = c[i][j];
}

// Column of output element (jj, e) of thread tx in a [64, HD] tile.
template <int HD>
__device__ __forceinline__ int out_col(int jj, int e, int tx) {
  return jj * 16 * Dims<HD>::kVec + tx * Dims<HD>::kVec + e;
}

template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = *src;
  }
}

// acc[i][c] += sum_k P[ty + 16 i][p0 + k] V[k][out_col(c)] for k < n.
template <int HD>
__device__ __forceinline__ void accumulate(const float* P, const float* V,
                                           float (&acc)[4][Dims<HD>::kCols],
                                           int p0, int n, int ty, int tx) {
  using D = Dims<HD>;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kLdp + p0 + k];
    float v[D::kCols];
#pragma unroll
    for (int jj = 0; jj < D::kNVec; ++jj)
      load_vec<D::kVec>(v + jj * D::kVec,
                        V + k * D::kLd + out_col<HD>(jj, 0, tx));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < D::kCols; ++c)
        acc[i][c] = fmaf(p[i], v[c], acc[i][c]);
  }
}

// Reductions over the 16 threads of one row (one half-warp).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(int H, int G, int Sq, int Skv, int kv_len, int causal,
                 int bk, float scale, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o) {
  using D = Dims<HD>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                        // q * scale, [64][kLd]
  float* KVs = Qs + kRows * D::kLd;        // K chunk, then V chunk
  float* Ps = KVs + kChunk * D::kLd;       // probabilities, [64][kLdp]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int h = blockIdx.y, b = blockIdx.z, Hk = H / G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int64_t bhk = static_cast<int64_t>(b) * Hk + h / G;
  const T* kp = k + bhk * Skv * HD;
  const T* vp = v + bhk * Skv * HD;
  const int chunk = bk < kChunk ? bk : kChunk;   // keys staged at a time

  load_rows<T, HD>(Qs, q + bh * Sq * HD, q0, kRows, Sq, scale);
  float m[4], l[4], acc[4][D::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D::kCols; ++c) acc[i][c] = 0.f;
  }
  // keys this q-tile must visit: those at or before its last row if causal
  const int end = causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (end + bk - 1) / bk;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * bk;
    // a chunk wholly masked for every row of this tile is skipped: its
    // scores stay -1e30, its p are 0 (see the note above)
    float s[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) s[e] = kNegInf;
#pragma unroll
    for (int half = 0; half < kMaxBk / kChunk; ++half) {
      const int c0 = half * kChunk;
      if (c0 < bk && k0 + c0 < end) {
        __syncthreads();                   // earlier chunk reads done
        load_rows<T, HD>(KVs, kp, k0 + c0, chunk, Skv, 1.f);
        __syncthreads();
        scores<HD>(Qs, KVs, s + half * 4, ty, tx);
      }
    }
    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j, col = k0 + c;
        if (c < bk) {
          if (col >= kv_len || (causal && row < col)) s[i * 8 + j] = kNegInf;
          mx = fmaxf(mx, s[i * 8 + j]);
        }
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < bk) {
          const float p = expf(s[i * 8 + j] - m_new);
          s[i * 8 + j] = p;
          sum += p;
        }
      }
      l[i] = l[i] * corr + row_sum(sum);
#pragma unroll
      for (int c = 0; c < D::kCols; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    // P is free to write: the K loads of this tile came after every read
    // of the last tile's P
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        if (c < bk) Ps[(ty + 16 * i) * kLdp + c] = s[i * 8 + j];
      }
#pragma unroll
    for (int half = 0; half < kMaxBk / kChunk; ++half) {
      const int c0 = half * kChunk;
      if (c0 < bk && k0 + c0 < end) {
        __syncthreads();                   // P written; earlier V reads done
        load_rows<T, HD>(KVs, vp, k0 + c0, chunk, Skv, 1.f);
        __syncthreads();
        accumulate<HD>(Ps, KVs, acc, c0, chunk, ty, tx);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * Sq + row) * HD;
#pragma unroll
    for (int jj = 0; jj < D::kNVec; ++jj)
#pragma unroll
      for (int e = 0; e < D::kVec; ++e)
        store(orow + out_col<HD>(jj, e, tx), acc[i][jj * D::kVec + e] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(int B, int H, int Hk, int Sq, int Skv, int kv_len,
                   int causal, int bk, float scale, const void* q,
                   const void* k, const void* v, void* o,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, HD>;
  const int smem = smem_floats(HD) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      H, H / Hk, Sq, Skv, kv_len, causal, bk, scale,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, int B, int H, int Hk, int Sq, int Skv,
                     int kv_len, int causal, int bk, float scale,
                     const void* q, const void* k, const void* v, void* o,
                     cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(B, H, Hk, Sq, Skv, kv_len, causal, bk,
                                  scale, q, k, v, o, s);
    case 32: return launch<T, 32>(B, H, Hk, Sq, Skv, kv_len, causal, bk,
                                  scale, q, k, v, o, s);
    case 64: return launch<T, 64>(B, H, Hk, Sq, Skv, kv_len, causal, bk,
                                  scale, q, k, v, o, s);
    case 128: return launch<T, 128>(B, H, Hk, Sq, Skv, kv_len, causal, bk,
                                    scale, q, k, v, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o).  q [B, H, Sq, hd], k and v
// [B, Hk, Skv, hd], contiguous and 16-byte aligned; bk a power of two in
// [8, 128] that divides Skv; 1 <= kv_len <= Skv; scale = hd^-1/2 rounded to
// float as the plain version rounds it.  Returns a cudaError_t (0 =
// launched).
int flash_attention_launch(int dtype, int B, int H, int Hk, int Sq, int Skv,
                           int hd, int kv_len, int causal, int bk,
                           float scale, const void* q, const void* k,
                           const void* v, void* o, void* stream) {
  if ((dtype != 0 && dtype != 1) || B < 1 || B > 65535 || H < 1 ||
      H > 65535 || Hk < 1 || H % Hk || Sq < 1 || Skv < 1 || bk < 8 ||
      bk > kMaxBk || (bk & (bk - 1)) || Skv % bk || kv_len < 1 ||
      kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(hd, B, H, Hk, Sq, Skv, kv_len, causal, bk, scale,
                           q, k, v, o, s);
  return dispatch<__nv_bfloat16>(hd, B, H, Hk, Sq, Skv, kv_len, causal, bk,
                                 scale, q, k, v, o, s);
}

}  // extern "C"
