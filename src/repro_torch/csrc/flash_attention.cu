// Flash attention forward (BHSD layout, grouped-query heads) for the dense
// models' scoring forward.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd`
// (src/repro/kernels/flash_attention/kernel.py:67, body `_flash_kernel`).
// For q [B, H, Sq, hd] and k, v [B, Hk, Skv, hd] (Sq and Skv padded by the
// wrapper; keys at or past kv_len masked), query head h reads K/V head
// h / G, G = H / Hk.  Per query row, in float32, over the keys in tiles,
// as `_flash_kernel` does:
//   s      = (q * hd^-1/2) . k          masked to -1e30 where col >= kv_len
//                                       or (causal and row < col)
//   m_new  = max(m, rowmax s),  corr = exp(m - m_new),  p = exp(s - m_new)
//   l      = l * corr + sum p,  acc = acc * corr + p . v,  m = m_new
//   o      = acc / max(l, 1e-30)        stored in q's type
// There is no backward: the TPU kernel has none.
//
// What bounds it at the scoring path's shapes (B 4, H 16, Hk 8, hd 128,
// S 4096, causal, bf16): operations.  4 hd flop per causal (row, key)
// pair, 2.75e11 flop: 278 us on the bf16 tensor cores (989 TFLOP/s); q,
// k, v and o are 201 MB, 60 us at 3.35 TB/s.
//
// bfloat16 (the scoring path): wgmma on the tensor cores, bf16 operands
// and float32 sums.
// * One block per (64 query rows, K/V head, batch), the heaviest causal
//   q-tiles first.  Its consumer warpgroups take two query heads of the
//   K/V head's GQA group over the same 64 rows, so every K/V tile in
//   shared memory feeds both, and their causal masks, hence their work,
//   are equal.  A group of G heads is split over G / 2 blocks (G even) or
//   G blocks of one warpgroup (G odd): G 1 and G 4 read K/V G / 2 or G
//   times, the scoring path's G 2 once.
// * A producer warp's lane 0 loads the q-tiles once and K/V in tiles of
//   128 keys by TMA (cp.async.bulk.tensor) into a ring of 2 stages, each
//   with a `full` mbarrier (bytes landed) and an `empty` one (every
//   consumer thread done with it).  Rows are stored as panels of one
//   swizzle row (hd 128: two 64-column panels, 128-byte swizzle; hd 64:
//   128 B; hd 32: 64 B; hd 16: 32 B), the layout both TMA and the wgmma
//   descriptors name.  TMA zero-fills rows past S, so the tile need not
//   match the wrapper's block; kv_len is still masked, since a zero key
//   scores 0, not -inf.
// * S = Q K^T: wgmma m64n128k16, Q and K both K-major in shared memory;
//   q enters unscaled (exact bf16) and hd^-1/2 * log2(e) multiplies the
//   float32 scores, so the softmax runs as exp2.  Only the last tile of
//   a q-tile can hold masked keys (the causal diagonal, kv_len): tiles
//   wholly above the diagonal are neither loaded nor multiplied.  A row
//   lives on the 4 threads of a quad: row max is two shuffles, and l is
//   summed per thread and over the quad once at the end.
// * O += P V: p is rounded to bf16 (round to nearest even) into wgmma's
//   A operand from registers; the S accumulator's layout is the A
//   fragment's, so the conversion moves nothing.  V is read MN-major
//   (transposed) from shared memory; O stays in float32 registers.  l
//   sums the float32 p.  That rounding of p is the kernel's one
//   departure from the float32 function above: ref.py's
//   `rounded_flash_bhsd` repeats it and is the kernel's plain version,
//   while the CPU path and interpret=True compute the function above.
// * The first step of S writes its registers without reading them, so
//   from P's conversion to the next S they hold nothing: at 288 threads
//   (224 registers each) ptxas then keeps the products asynchronous,
//   where with S live across P V it serialised them.
// * Shared memory at hd 128: 2 q-tiles 32 KB + 2 stages x (K 32 KB + V
//   32 KB) = 160 KB, one block per SM; 288 threads.
//
// float32 (no main path; the smoke goldens hold it to 1e-5, which bf16
// or TF32 operands cannot meet): the CUDA cores.
// * One block of 256 threads per (64 query rows, head, batch), the
//   heaviest first; the q-tile, times hd^-1/2, staged once in shared
//   memory as float rows padded to hd + 4.  The online-softmax update runs
//   once per `bk` keys (the wrapper's block), as the TPU kernel's grid
//   step does, so the kernel and `reference_flash_bhsd` differ only in
//   the order of the sums inside a tile.
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
//   no bit.  Such keys are neither loaded nor multiplied.  Its floor is
//   the same flop at 67 TFLOP/s float32: 4.1 ms at the scoring shape.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;              // query rows per block
constexpr int kChunk = 64;             // keys staged at a time
constexpr int kMaxBk = 128;            // largest key tile (score columns)
constexpr int kLdp = kMaxBk + 4;       // padded row of the probability tile
constexpr float kNegInf = -1e30f;


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
template <int HD>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int n, int n_rows,
                                          float scale) {
  constexpr int kPer = 16 / sizeof(float);
  constexpr int kPerRow = HD / kPer;
  for (int i = threadIdx.x; i < n * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kPer;
    float vals[kPer];
    if (row0 + r < n_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          src + static_cast<int64_t>(row0 + r) * HD + c);
      const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) vals[j] = e[j] * scale;
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

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32(int H, int G, int Sq, int Skv, int kv_len, int causal, int bk,
              float scale, const float* __restrict__ q,
              const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ o) {
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
  const float* kp = k + bhk * Skv * HD;
  const float* vp = v + bhk * Skv * HD;
  const int chunk = bk < kChunk ? bk : kChunk;   // keys staged at a time

  load_rows<HD>(Qs, q + bh * Sq * HD, q0, kRows, Sq, scale);
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
        load_rows<HD>(KVs, kp, k0 + c0, chunk, Skv, 1.f);
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
        load_rows<HD>(KVs, vp, k0 + c0, chunk, Skv, 1.f);
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
    float* orow = o + (bh * Sq + row) * HD;
#pragma unroll
    for (int jj = 0; jj < D::kNVec; ++jj)
#pragma unroll
      for (int e = 0; e < D::kVec; ++e)
        orow[out_col<HD>(jj, e, tx)] = acc[i][jj * D::kVec + e] / denom;
  }
}

// ------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores, K/V by TMA once per GQA group.

namespace wg {

constexpr int kRows = 64;              // query rows of a warpgroup (wgmma M)
constexpr int kKeys = 128;             // keys per tile (the S product's N)
constexpr int kStages = 2;             // K/V ring depth
constexpr float kNegInf = -1e30f;

// A tile of HD columns is stored as HD / kPanel panels, each a column
// block of kPanel bf16 = one swizzle row (32, 64 or 128 bytes): the
// layout TMA writes with the matching CU_TENSOR_MAP_SWIZZLE_* mode and
// wgmma reads with the matching descriptor layout type.
template <int HD>
struct Tile {
  static constexpr int kPanel = HD < 64 ? HD : 64;
  static constexpr int kPanels = HD / kPanel;
  static constexpr int kSwizzle = 2 * kPanel;                 // bytes
  static constexpr int kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kQBytes = kRows * HD * 2;              // one head
  static constexpr int kKVBytes = kKeys * HD * 2;             // K or V tile
};

// Shared memory of a block with W consumer warpgroups: W q-tiles, then
// kStages (K tile, V tile) pairs, then the mbarriers; every tile starts
// on 1024 bytes, the period of the 128-byte swizzle.
template <int HD, int W>
struct Smem {
  static constexpr int kK = W * Tile<HD>::kQBytes;
  static constexpr int kBar = kK + kStages * 2 * Tile<HD>::kKVBytes;
  static constexpr int kBytes = kBar + 64 + 1024;   // barriers, alignment
};
static_assert(Smem<128, 2>::kBytes <= 227 * 1024,
              "hd 128 with two warpgroups exceeds an H100 SM's shared memory");

// S[64 x 128] = A[64 x 16] . B[128 x 16]^T, both K-major in shared memory:
// the first step of S.  Its outputs are write-only, so S's registers are
// dead to the compiler from P's conversion until here and hold nothing
// while P . V runs.
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// S[64 x 128] += A[64 x 16] . B[128 x 16]^T: the later steps.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // RN-even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Block (q-tile x, y = K/V head * CTAs per group + part, batch z): W
// consumer warpgroups, one per query head h0 .. h0 + W - 1 of K/V head
// hk, then one producer warp whose lane 0 issues every TMA load.
template <int HD, int W>
__global__ void __launch_bounds__(W * 128 + 32, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int H, int Hk, int Sq,
               int kv_len, int causal, float scale_log2) {
  using T = Tile<HD>;
  using L = Smem<HD, W>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = base + L::kBar;        // full[s]:  + 8 s
  const uint32_t empty = full + 8 * kStages;   // empty[s]: + 8 s
  const uint32_t q_bar = empty + 8 * kStages;
  const int G = H / Hk, parts = G / W;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;   // heaviest first
  const int hk = blockIdx.y / parts;
  const int h0 = hk * G + (blockIdx.y % parts) * W;
  const int b = blockIdx.z;
  // keys this q-tile visits: those at or before its last row if causal
  const int end = causal ? min(kv_len, q0 + kRows) : kv_len;
  const int n_tiles = (end + kKeys - 1) / kKeys;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, W * 128);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * W) {                         // the producer warp
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_bar, W * T::kQBytes);
      for (int w = 0; w < W; ++w)
        for (int p = 0; p < T::kPanels; ++p)
          tma_load_3d(base + w * T::kQBytes + p * kRows * T::kSwizzle, &tm_q,
                   q_bar, p * T::kPanel, q0, b * H + h0 + w);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)                      // consumers freed the stage
          mbar_wait(empty + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * s, 2 * T::kKVBytes);
        const uint32_t kt = base + L::kK + s * 2 * T::kKVBytes;
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load_3d(kt + p * kKeys * T::kSwizzle, &tm_k, full + 8 * s,
                   p * T::kPanel, t * kKeys, b * Hk + hk);
          tma_load_3d(kt + T::kKVBytes + p * kKeys * T::kSwizzle, &tm_v,
                   full + 8 * s, p * T::kPanel, t * kKeys, b * Hk + hk);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: query head h0 + wgi, rows q0 .. q0 + 63.  Its
  // thread holds rows r and r + 8 (r = 16 * warp + lane / 4) of every
  // wgmma accumulator: element 4 j + e sits in row r + 8 (e / 2), column
  // 8 j + 2 (lane % 4) + e % 2.
  const int wgi = warp / 4, lane = threadIdx.x % 32;
  const int r = (warp % 4) * 16 + lane / 4;
  const uint32_t q_tile = base + wgi * T::kQBytes;
  float s_acc[64], o_acc[HD / 2];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o_acc[i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t kt = base + L::kK + s * 2 * T::kKVBytes;
    const uint32_t vt = kt + T::kKVBytes;
    mbar_wait(full + 8 * s, (t / kStages) & 1);

    // S = Q K^T over HD in steps of 16 (32 bytes of a swizzle row)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk * 16 / T::kPanel, c = kk * 16 % T::kPanel;
      const uint64_t da = smem_desc(q_tile + p * kRows * T::kSwizzle + 2 * c,
                                    16, 8 * T::kSwizzle, T::kLayout);
      const uint64_t db = smem_desc(kt + p * kKeys * T::kSwizzle + 2 * c, 16,
                                    8 * T::kSwizzle, T::kLayout);
      if (kk == 0)
        wgmma_ss_n128_first(s_acc, da, db);
      else
        wgmma_ss_n128(s_acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s_acc);

    // scale into the log2 domain; only the last tile holds masked keys
    const bool last = t == n_tiles - 1;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_acc[4 * j + e] * scale_log2;
        if (last) {
          const int row = q0 + r + 8 * (e / 2);
          const int col = t * kKeys + 8 * j + 2 * (lane % 4) + e % 2;
          if (col >= kv_len || (causal && col > row)) x = kNegInf;
        }
        s_acc[4 * j + e] = x;
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(s_acc[4 * j + 2 * h], s_acc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[h] = exp2f(m[h] - mx);
      m[h] = mx;
    }
    // p = 2^(s - m) in float32; l sums these, P . V takes them rounded to
    // bf16 (the kernel's one rounding beyond the plain float32 function)
    uint32_t pa[32];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s_acc[4 * j + e] - m[e / 2]);
        s_acc[4 * j + e] = p;
        sum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 32; ++i)
      pa[i] = pack_bf16(s_acc[2 * i], s_acc[2 * i + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + sum[h];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o_acc[i] *= corr[(i / 2) % 2];

    // O += P V over the tile's keys in steps of 16: P's accumulator
    // layout is wgmma's A-fragment layout, so pa[4 kk .. 4 kk + 3] is the
    // A operand of step kk; V is read transposed (MN-major)
    reg_fence(o_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs(o_acc, pa + 4 * kk,
                   smem_desc(vt + kk * 16 * T::kSwizzle,
                             kKeys * T::kSwizzle, 8 * T::kSwizzle,
                             T::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o_acc);
    mbar_arrive(empty + 8 * s);                // this stage may be refilled
  }

  const int hq = h0 + wgi;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b * H + hq) * Sq * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];                           // the row's 4 threads
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float den = fmaxf(lt, 1e-30f);
    const int row = q0 + r + 8 * h;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + static_cast<int64_t>(row) * HD + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o_acc[4 * j + 2 * h] / den,
                                o_acc[4 * j + 2 * h + 1] / den);
  }
}

}  // namespace wg

cudaError_t launch_f32(int hd, int B, int H, int Hk, int Sq, int Skv,
                       int kv_len, int causal, int bk, float scale,
                       const void* q, const void* k, const void* v, void* o,
                       cudaStream_t stream) {
  auto go = [&](auto kernel) {
    const int smem = smem_floats(hd) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((Sq + kRows - 1) / kRows, H, B);
    kernel<<<grid, kThreads, smem, stream>>>(
        H, H / Hk, Sq, Skv, kv_len, causal, bk, scale,
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o));
    return cudaGetLastError();
  };
  switch (hd) {
    case 16: return go(flash_fwd_f32<16>);
    case 32: return go(flash_fwd_f32<32>);
    case 64: return go(flash_fwd_f32<64>);
    case 128: return go(flash_fwd_f32<128>);
    default: return cudaErrorInvalidValue;
  }
}

// [n_heads, S, HD] bf16 as a 3-D map whose box is one panel of `rows`
// rows of one head; rows past S read as zero.
template <int HD>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int n_heads,
            int S, int rows) {
  using T = wg::Tile<HD>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(n_heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(HD) * 2,
                                 static_cast<cuuint64_t>(S) * HD * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(T::kPanel),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int W>
cudaError_t launch_bf16(int B, int H, int Hk, int Sq, int Skv, int kv_len,
                        int causal, float scale, const void* q, const void* k,
                        const void* v, void* o, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!encode<HD>(fn, &tq, q, B * H, Sq, wg::kRows) ||
      !encode<HD>(fn, &tk, k, B * Hk, Skv, wg::kKeys) ||
      !encode<HD>(fn, &tv, v, B * Hk, Skv, wg::kKeys))
    return cudaErrorInvalidValue;
  auto kernel = wg::flash_fwd_bf16<HD, W>;
  constexpr int smem = wg::Smem<HD, W>::kBytes;
  static bool sized = false;
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((Sq + wg::kRows - 1) / wg::kRows, H / W, B);
  kernel<<<grid, W * 128 + 32, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hk, Sq, kv_len, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int W>
cudaError_t dispatch_bf16(int hd, int B, int H, int Hk, int Sq, int Skv,
                          int kv_len, int causal, float scale, const void* q,
                          const void* k, const void* v, void* o,
                          cudaStream_t s) {
  switch (hd) {
    case 16: return launch_bf16<16, W>(B, H, Hk, Sq, Skv, kv_len, causal,
                                       scale, q, k, v, o, s);
    case 32: return launch_bf16<32, W>(B, H, Hk, Sq, Skv, kv_len, causal,
                                       scale, q, k, v, o, s);
    case 64: return launch_bf16<64, W>(B, H, Hk, Sq, Skv, kv_len, causal,
                                       scale, q, k, v, o, s);
    case 128: return launch_bf16<128, W>(B, H, Hk, Sq, Skv, kv_len, causal,
                                         scale, q, k, v, o, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and o).  q [B, H, Sq, hd], k and v
// [B, Hk, Skv, hd], contiguous and 16-byte aligned; bk a power of two in
// [8, 128] that divides Skv (the float32 kernel's key tile; the bf16 kernel
// takes 128 keys a tile whatever bk is); 1 <= kv_len <= Skv; scale =
// hd^-1/2 rounded to float as the plain version rounds it.  Returns a
// cudaError_t (0 = launched).
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
    return launch_f32(hd, B, H, Hk, Sq, Skv, kv_len, causal, bk, scale, q,
                      k, v, o, s);
  // two query heads of a GQA group per block where the group is even
  if ((H / Hk) % 2 == 0)
    return dispatch_bf16<2>(hd, B, H, Hk, Sq, Skv, kv_len, causal, scale, q,
                            k, v, o, s);
  return dispatch_bf16<1>(hd, B, H, Hk, Sq, Skv, kv_len, causal, scale, q, k,
                          v, o, s);
}

}  // extern "C"
