// SSD intra-chunk pass of the Mamba2 mixer (state-space duality).
//
// Replaces the Pallas TPU kernel `ssd_intra_chunk`
// (src/repro/kernels/ssd_scan/kernel.py:52, body `_ssd_kernel`).  For one
// (batch, chunk, head), with Q steps in the chunk and acum the running sum
// of log_a over the chunk, it computes in float32
//   y[q]  = sum_{k<=q} (C_q . B_k) * exp(acum_q - acum_k) * xdt_k   [Q, hd]
//   h     = sum_k exp(acum_{Q-1} - acum_k) * xdt_k (x) B_k          [hd, st]
//   a     = exp(acum_{Q-1})
// and returns acum itself ([B, S, nh], chunk-local), reading xdt, B and C
// in the model's type (float or bfloat16).  The inter-chunk recurrence runs
// outside, in ops.py, on these prefix sums.
//
// Both kernels take the prefix sum serially and in order, one thread per
// head, and the library is built with -fmad=false and no fast math, so
// acum, every decay `expf(acum_q - acum_k)`, the tails and a are bitwise
// those of the plain versions (ref.py).
//
// bfloat16 (the Mamba2 serving path: Q 128, hd 64, st 128, 80 heads) runs on
// the tensor cores when hd is 16, 32, 64 or 128, st is 16, 32, 64, 128 or
// 256 and the tiles fit in shared memory (`tc_smem_bytes`); every other
// shape takes the CUDA-core kernel below, chosen by shape in
// `ssd_intra_chunk_launch` (kernel.py `uses_tensor_cores` says the same).
// * One block per (group of kHeads heads, chunk, batch): two consumer
//   warpgroups and a producer warp.  The producer's lane 0 loads the
//   chunk's C and B tiles once by TMA, then each head's xdt tile into a
//   ring of stages (`full` and `empty` mbarriers).  TMA boxes of [Qp rows,
//   one swizzle row]: rows past Q (the chunk padded to Qp, a multiple of
//   64) read as zero.  Tiles are stored as panels of one swizzle row (128 B
//   at 64 columns or more, else 64 or 32 B), 1024-B aligned: the layout the
//   TMA swizzle writes and the wgmma descriptors name.
// * C.B: wgmma m64n64k16, C and B both K-major (st the sum), one 64 x 64
//   tile of (query rows, keys) at a time on or below the diagonal.  B and C
//   are bf16, so every product is exact; only the order of the float32 sums
//   departs from the plain version.
// * y = W . xdt with W = (C.B) * decay masked to k <= q, formed in float32
//   in the C.B accumulator's registers, which are wgmma's A fragment.  W is
//   split into hi = bf16(W) and lo = bf16(W - hi) and both products add
//   into one float32 sum (wgmma m64n{hd}k16, xdt MN-major from shared
//   memory): hi + lo is W within 2^-16 of it, near float32, where one bf16
//   W would err by 2^-9 per term.
// * h = (tail * xdt)^T . B: the A fragment (hd rows, keys) is formed by each
//   thread from the xdt tile and the tails in float32 and split the same
//   way; B is read MN-major.  wgmma m64n{min(st,128)}k16, hd in tiles of 64
//   rows (rows past hd are zero).
// * A warpgroup owns whole row tiles of y and whole (hd, st) tiles of h:
//   per head, the units go costliest first to the warpgroup with less work
//   so far (at the serving shape: h and y's first row tile to one, y's
//   second row tile, twice the keys, to the other), and the two swap lists
//   from head to head.
// * What bounds it at the serving shape (S 1024): bytes.  53.6 MB (y and h
//   written in float32, 42 MB of it) is 16.0 us at 3.35 TB/s; the products,
//   the hi/lo split included, are ~4 GFLOP (~4 us at 989 TFLOP/s), and the
//   decays 7.9 M accurate expf on the CUDA cores (three 64 x 64 tiles per
//   head and chunk).  The block's two warpgroups run their products and
//   their CUDA-core work in turn, so it takes ~3x the bound.
//
// float32 (and bf16 shapes the tensor-core kernel does not take): the CUDA
// cores, bitwise the plain version `ref.reference_intra_chunk`.  One block
// of 256 threads per (batch, chunk, head).  The chunk's xdt (this head), B
// and C are staged in shared memory in their own type (the conversion to
// float is exact), with B and C rows padded to an odd number of words so
// that 32 lanes reading 32 rows hit 32 banks.  The y phase walks the keys
// in tiles of 32: the block writes W[q][k] = (C_q . B_k) * exp(acum_q -
// acum_k) for the tile into shared memory, then each thread adds W * xdt
// into the outputs it owns (rows q0, q0 + 256/hd, ...; one column d), held
// in registers.  Keys after q are skipped: the Pallas body's -1e9 mask
// gives exactly 0 there.  The h phase gives each thread columns s and rows
// d of h.  Every sum runs in a fixed order (C . B over the state index, y
// and h over the keys, each ascending), each step one IEEE float multiply
// or add, as the plain version's whole-tensor ops take them.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

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
                       float* __restrict__ a_out,        // [B, nC, nh]
                       float* __restrict__ acum_out) {   // [B, S, nh]
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
  for (int k = tid; k < Q; k += kThreads) {
    tail[k] = expf(last - acum[k]);
    acum_out[(row0 + k) * nh + head] = acum[k];
  }
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
                   const void* c, void* y, void* h, void* a, void* acum,
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
      static_cast<float*>(h), static_cast<float*>(a),
      static_cast<float*>(acum));
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// bfloat16 on the tensor cores: wgmma, tiles by TMA.

namespace tc {

// Heads per block: 80 heads x 8 chunks make 128 blocks, one wave on 132
// SMs (1, 2, 4 and 10 heads per block measured slower on the H100).
constexpr int kHeads = 5;
constexpr int kTile = 64;                     // rows and keys of a tile
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kBlock = kConsumers + 32;       // and the producer warp

// A [rows, N] bf16 tile is stored as panels of kPanel columns, one swizzle
// row each (32, 64 or 128 bytes), rows contiguous within a panel.
template <int N>
struct Panel {
  static constexpr int kPanel = N < 64 ? N : 64;
  static constexpr int kSwizzle = 2 * kPanel;                 // bytes
  static constexpr int kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  // byte offset of a swizzled 16-byte chunk: bits [4, 4 + log2(kSwizzle /
  // 16)) take the XOR of the bits 3 places above them (TMA's pattern)
  static constexpr uint32_t kMask = (kSwizzle / 16 - 1) << 4;
};

// Shared memory of one block: the C and B tiles, `stages` xdt tiles, then
// the prefix sums and tails of kHeads heads, then the mbarriers.
struct Smem {
  int c, b, x, stage_bytes, acum, tail, bar, bytes;
  __host__ __device__ Smem(int Qp, int hd, int st, int stages) {
    c = 0;
    b = c + Qp * st * 2;
    x = b + Qp * st * 2;
    stage_bytes = Qp * hd * 2;
    acum = x + stages * stage_bytes;
    tail = acum + kHeads * Qp * 4;
    bar = tail + kHeads * Qp * 4;
    bytes = bar + 8 * (1 + 2 * kHeads) + 1024;   // barriers, alignment
  }
};

// The consumer warpgroups only (named barrier 1).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// CB[64 x 64] = C[64 x 16] . B[64 x 16]^T, both K-major in shared memory:
// the first step, whose outputs are write-only.
__device__ __forceinline__ void wgmma_cb_first(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_W8(d, 0), HOPPER_W8(d, 8), HOPPER_W8(d, 16), HOPPER_W8(d, 24)
      : "l"(da), "l"(db), "r"(0));
}
// CB[64 x 64] += C[64 x 16] . B[64 x 16]^T: the later steps.
__device__ __forceinline__ void wgmma_cb(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F8(d, 0), HOPPER_F8(d, 8), HOPPER_F8(d, 16), HOPPER_F8(d, 24)
      : "l"(da), "l"(db), "r"(1));
}

// v in bf16 pairs: hi = bf16(v) (round to nearest even), lo = bf16(v - hi);
// v - hi is exact in float32.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Block (head group x, chunk y, batch z): consumer warpgroups 0 and 1, then
// the producer warp.  HD: head dim; NS: state columns per panel of the B
// and C tiles (st, or 64 for st >= 64); NH: state columns per h tile (st,
// or 128 for st >= 128).
template <int HD, int NS, int NH>
__global__ void __launch_bounds__(kBlock, 1)
ssd_intra_chunk_tc(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const float* __restrict__ log_a,   // [B, S, nh]
                   float* __restrict__ y,             // [B, S, nh, hd]
                   float* __restrict__ h_out,         // [B, nC, nh, hd, st]
                   float* __restrict__ a_out,         // [B, nC, nh]
                   float* __restrict__ acum_out,      // [B, S, nh]
                   int S, int nh, int st, int Q, int stages) {
  using PX = Panel<HD>;
  using PS = Panel<NS>;
  extern __shared__ uint8_t smem_raw[];
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  const int NT = Qp / kTile;
  const Smem L(Qp, HD, st, stages);
  uint8_t* base_ptr = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(base_ptr);
  float* acum = reinterpret_cast<float*>(base_ptr + L.acum);   // [kHeads][Qp]
  float* tail = reinterpret_cast<float*>(base_ptr + L.tail);   // [kHeads][Qp]
  const uint32_t cb_bar = base + L.bar;
  const uint32_t full = cb_bar + 8;                 // full[s]:  + 8 s
  const uint32_t empty = full + 8 * kHeads;         // empty[s]: + 8 s
  const int head0 = blockIdx.x * kHeads, chunk = blockIdx.y;
  const int batch = blockIdx.z, nC = gridDim.y;
  const int n_heads = min(kHeads, nh - head0);
  const int64_t row0 = static_cast<int64_t>(batch) * S +
                       static_cast<int64_t>(chunk) * Q;
  const int bc = batch * nC + chunk;                // TMA box coordinate
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(cb_bar, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {                          // the producer warp
    if (tid == kConsumers) {
      mbar_expect_tx(cb_bar, 2 * Qp * st * 2);
      for (int p = 0; p < st / NS; ++p) {
        tma_load_3d(base + L.c + p * Qp * PS::kSwizzle, &tm_c, cb_bar,
                    p * NS, 0, bc);
        tma_load_3d(base + L.b + p * Qp * PS::kSwizzle, &tm_b, cb_bar,
                    p * NS, 0, bc);
      }
      for (int i = 0; i < n_heads; ++i) {
        const int s = i % stages;
        if (i >= stages)                           // consumers freed it
          mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        mbar_expect_tx(full + 8 * s, L.stage_bytes);
        const uint32_t xt = base + L.x + s * L.stage_bytes;
        for (int p = 0; p < HD / PX::kPanel; ++p)
          tma_load_4d(xt + p * Qp * PX::kSwizzle, &tm_x, full + 8 * s,
                      p * PX::kPanel, head0 + i, 0, bc);
      }
    }
    return;
  }

  // ---- prefix sums of the group's heads: serial, in order, one thread
  // per head, as the plain version takes them
  for (int e = tid; e < n_heads * Q; e += kConsumers) {
    const int k = e / n_heads, i = e - k * n_heads;
    acum[i * Qp + k] = log_a[(row0 + k) * nh + head0 + i];
  }
  consumers_sync();
  if (tid < n_heads) {
    float* ac = acum + tid * Qp;
    float run = ac[0];
    for (int k = 1; k < Q; ++k) {
      run = run + ac[k];
      ac[k] = run;
    }
    a_out[static_cast<int64_t>(bc) * nh + head0 + tid] = expf(run);
  }
  consumers_sync();
  for (int e = tid; e < n_heads * Qp; e += kConsumers) {
    const int k = e / n_heads, i = e - k * n_heads;
    if (k < Q) {
      const float ak = acum[i * Qp + k];
      acum_out[(row0 + k) * nh + head0 + i] = ak;
      tail[i * Qp + k] = expf(acum[i * Qp + Q - 1] - ak);
    } else {                                      // padding: no weight
      acum[i * Qp + k] = 0.f;
      tail[i * Qp + k] = 0.f;
    }
  }
  consumers_sync();

  // A thread holds rows r and r + 8 (r = 16 * warp + lane / 4 of its
  // warpgroup) of every wgmma accumulator: element 4 j + e sits in row
  // r + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.  Packed in pairs, the
  // accumulator is the A fragment of a product over its columns: pairs
  // 4 kk .. 4 kk + 3 are step kk's.
  const int wgi = tid / 128, lane = tid % 32;
  const int r = (tid % 128) / 32 * 16 + lane / 4, t2 = 2 * (lane % 4);
  mbar_wait(cb_bar, 0);

  for (int i = 0; i < n_heads; ++i) {
    const int head = head0 + i, s = i % stages;
    const uint32_t xt = base + L.x + s * L.stage_bytes;
    const uint8_t* xt_ptr = base_ptr + L.x + s * L.stage_bytes;
    const float* ac = acum + i * Qp;
    const float* tl = tail + i * Qp;
    mbar_wait(full + 8 * s, (i / stages) & 1);

    // The head's units of work, costliest first: the h tiles (NT key tiles
    // each), then y's row tiles from the last (rt + 1 key tiles each).  Each
    // goes to the warpgroup with less work so far, and the two swap lists
    // from one head to the next.
    constexpr int kMt = (HD + kTile - 1) / kTile;
    const int n_items = kMt * (st / NH);
    const int me = wgi ^ (i & 1);
    int load0 = 0, load1 = 0;
    for (int u = 0; u < n_items + NT; ++u) {
      const bool is_h = u < n_items;
      const int rt = is_h ? 0 : NT - 1 - (u - n_items);
      const int who = load1 < load0 ? 1 : 0;
      (who ? load1 : load0) += is_h ? NT : rt + 1;
      if (who != me) continue;

      if (!is_h) {
        // ---- y, row tile rt: keys in tiles kt <= rt
        float yacc[HD / 2];
#pragma unroll
        for (int j = 0; j < HD / 2; ++j) yacc[j] = 0.f;
        const int q_lo = rt * kTile + r;
        const float aq[2] = {ac[q_lo], ac[q_lo + 8]};
        for (int kt = 0; kt <= rt; ++kt) {
          float cb[32];
          wgmma_fence();
          for (int kk = 0; kk < st / 16; ++kk) {
            const int p = kk * 16 / NS, c = kk * 16 % NS;
            const uint32_t off = p * Qp * PS::kSwizzle + 2 * c;
            const uint64_t da = smem_desc(
                base + L.c + off + rt * kTile * PS::kSwizzle, 16,
                8 * PS::kSwizzle, PS::kLayout);
            const uint64_t db = smem_desc(
                base + L.b + off + kt * kTile * PS::kSwizzle, 16,
                8 * PS::kSwizzle, PS::kLayout);
            if (kk == 0)
              wgmma_cb_first(cb, da, db);
            else
              wgmma_cb(cb, da, db);
          }
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(cb);

          // W = CB * exp(acum_q - acum_k) for k <= q < Q, else exactly 0
          uint32_t whi[16], wlo[16];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = kt * kTile + 8 * j + t2;
            const float2 ak = *reinterpret_cast<const float2*>(ac + k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = q_lo + 8 * (e / 2), kc = k + e % 2;
              const float akc = e % 2 ? ak.y : ak.x;
              float wv = 0.f;
              if (kc <= q && kc < Q)
                wv = cb[4 * j + e] * expf(aq[e / 2] - akc);
              cb[4 * j + e] = wv;
            }
          }
#pragma unroll
          for (int p = 0; p < 16; ++p)
            split2(cb[2 * p], cb[2 * p + 1], whi[p], wlo[p]);
          // y += W_hi . X + W_lo . X over the tile's 64 keys, 16 at a time
          reg_fence(yacc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = smem_desc(
                xt + (kt * kTile + kk * 16) * PX::kSwizzle, Qp * PX::kSwizzle,
                8 * PX::kSwizzle, PX::kLayout);
            wgmma_rs(yacc, whi + 4 * kk, db);
            wgmma_rs(yacc, wlo + 4 * kk, db);
          }
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(yacc);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = q_lo + 8 * hh;
          if (q >= Q) continue;
          float* yr = y + ((row0 + q) * nh + head) * HD + t2;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<float2*>(yr + 8 * j) =
                make_float2(yacc[4 * j + 2 * hh], yacc[4 * j + 2 * hh + 1]);
        }
        continue;
      }

      // ---- h, tile u: 64 rows of hd x NH columns of st, keys summed in
      // tiles of 64; the A fragment (tail * xdt)^T is built in registers
      const int mt = u % kMt, nt = u / kMt;
      float hacc[NH / 2];
#pragma unroll
      for (int j = 0; j < NH / 2; ++j) hacc[j] = 0.f;
      const int d_lo = mt * kTile + r;
      for (int kt = 0; kt < NT; ++kt) {
        uint32_t ahi[16], alo[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          // pair p: step p / 4, row d_lo + 8 (p % 2), keys k, k + 1
          const int d = d_lo + 8 * (p % 2);
          const int k = kt * kTile + (p / 4) * 16 + 8 * ((p / 2) % 2) + t2;
          float v0 = 0.f, v1 = 0.f;
          if (d < HD) {
            const uint32_t o = (d / PX::kPanel) * Qp * PX::kSwizzle +
                               (d % PX::kPanel) * 2;
            const uint32_t o0 = o + k * PX::kSwizzle;
            const uint32_t o1 = o0 + PX::kSwizzle;
            const float x0 = __bfloat162float(*reinterpret_cast<
                const __nv_bfloat16*>(xt_ptr + (o0 ^ ((o0 >> 3) & PX::kMask))));
            const float x1 = __bfloat162float(*reinterpret_cast<
                const __nv_bfloat16*>(xt_ptr + (o1 ^ ((o1 >> 3) & PX::kMask))));
            const float2 tk = *reinterpret_cast<const float2*>(tl + k);
            v0 = x0 * tk.x;
            v1 = x1 * tk.y;
          }
          split2(v0, v1, ahi[p], alo[p]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = smem_desc(
              base + L.b + nt * (NH / NS) * Qp * PS::kSwizzle +
                  (kt * kTile + kk * 16) * PS::kSwizzle,
              Qp * PS::kSwizzle, 8 * PS::kSwizzle, PS::kLayout);
          wgmma_rs(hacc, ahi + 4 * kk, db);
          wgmma_rs(hacc, alo + 4 * kk, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(hacc);
      }
      float* hb = h_out + (static_cast<int64_t>(bc) * nh + head) * HD * st +
                  nt * NH + t2;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int d = d_lo + 8 * hh;
        if (d >= HD) continue;
#pragma unroll
        for (int j = 0; j < NH / 8; ++j)
          *reinterpret_cast<float2*>(hb + static_cast<int64_t>(d) * st +
                                     8 * j) =
              make_float2(hacc[4 * j + 2 * hh], hacc[4 * j + 2 * hh + 1]);
      }
    }
    mbar_arrive(empty + 8 * s);                     // the stage may refill
  }
}

}  // namespace tc

// Stages of xdt a tensor-core block holds (at most kHeads), or 0 if not
// even one fits beside the C and B tiles.
int tc_stages(int Q, int hd, int st) {
  const int Qp = (Q + tc::kTile - 1) / tc::kTile * tc::kTile;
  for (int n = tc::kHeads; n >= 1; --n)
    if (tc::Smem(Qp, hd, st, n).bytes <= kMaxSmem) return n;
  return 0;
}

bool tc_takes(int Q, int hd, int st) {
  const bool hd_ok = hd == 16 || hd == 32 || hd == 64 || hd == 128;
  const bool st_ok = st == 16 || st == 32 || st == 64 || st == 128 ||
                     st == 256;
  return hd_ok && st_ok && Q >= 1 && Q <= kMaxChunk &&
         tc_stages(Q, hd, st) > 0;
}

// A bf16 tensor of `rank` dims (innermost first; `strides` in bytes for
// dims 1..) read in boxes whose inner extent is one swizzle row of `panel`
// elements; box entries outside the tensor read as zero.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box, int panel) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      panel == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : panel == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int NS, int NH>
cudaError_t launch_tc(int B, int S, int nh, int st, int Q, const void* xdt,
                      const void* log_a, const void* b, const void* c,
                      void* y, void* h, void* a, void* acum,
                      cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  for (const void* p : {xdt, b, c})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const int nC = S / Q;
  const int Qp = (Q + tc::kTile - 1) / tc::kTile * tc::kTile;
  constexpr int px = tc::Panel<HD>::kPanel;
  // xdt [B * nC, Q, nh, HD]: a box is one head's [Qp rows, px columns]
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(HD),
                            static_cast<cuuint64_t>(nh),
                            static_cast<cuuint64_t>(Q),
                            static_cast<cuuint64_t>(B) * nC};
  const cuuint64_t xs[3] = {static_cast<cuuint64_t>(HD) * 2,
                            static_cast<cuuint64_t>(nh) * HD * 2,
                            static_cast<cuuint64_t>(Q) * nh * HD * 2};
  const cuuint32_t xb[4] = {static_cast<cuuint32_t>(px), 1,
                            static_cast<cuuint32_t>(Qp), 1};
  // B and C [B * nC, Q, st]: a box is [Qp rows, NS columns]
  const cuuint64_t sd[3] = {static_cast<cuuint64_t>(st),
                            static_cast<cuuint64_t>(Q),
                            static_cast<cuuint64_t>(B) * nC};
  const cuuint64_t ss[2] = {static_cast<cuuint64_t>(st) * 2,
                            static_cast<cuuint64_t>(Q) * st * 2};
  const cuuint32_t sb[3] = {static_cast<cuuint32_t>(NS),
                            static_cast<cuuint32_t>(Qp), 1};
  CUtensorMap tx, tb, tcm;
  if (!encode(fn, &tx, xdt, 4, xd, xs, xb, px) ||
      !encode(fn, &tb, b, 3, sd, ss, sb, NS) ||
      !encode(fn, &tcm, c, 3, sd, ss, sb, NS))
    return cudaErrorInvalidValue;
  const int stages = tc_stages(Q, HD, st);
  const int smem = tc::Smem(Qp, HD, st, stages).bytes;
  auto kernel = tc::ssd_intra_chunk_tc<HD, NS, NH>;
  static bool sized = false;            // once per instance
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  dim3 grid((nh + tc::kHeads - 1) / tc::kHeads, nC, B);
  kernel<<<grid, tc::kBlock, smem, stream>>>(
      tx, tb, tcm, static_cast<const float*>(log_a), static_cast<float*>(y),
      static_cast<float*>(h), static_cast<float*>(a),
      static_cast<float*>(acum), S, nh, st, Q, stages);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_tc(int B, int S, int nh, int st, int Q, const void* xdt,
                        const void* log_a, const void* b, const void* c,
                        void* y, void* h, void* a, void* acum,
                        cudaStream_t s) {
  switch (st) {
    case 16: return launch_tc<HD, 16, 16>(B, S, nh, st, Q, xdt, log_a, b, c,
                                          y, h, a, acum, s);
    case 32: return launch_tc<HD, 32, 32>(B, S, nh, st, Q, xdt, log_a, b, c,
                                          y, h, a, acum, s);
    case 64: return launch_tc<HD, 64, 64>(B, S, nh, st, Q, xdt, log_a, b, c,
                                          y, h, a, acum, s);
    default: return launch_tc<HD, 64, 128>(B, S, nh, st, Q, xdt, log_a, b,
                                           c, y, h, a, acum, s);
  }
}

}  // namespace

extern "C" {

// Shared memory one CUDA-core block needs, in bytes (elem: 4 float, 2
// bfloat16).
long long ssd_intra_chunk_smem_bytes(int Q, int hd, int st, int elem) {
  return smem_bytes(Q, hd, st, elem);
}

// 1 if bfloat16 inputs of these sizes run on the tensor cores, else 0 (the
// CUDA-core kernel takes them).
int ssd_intra_chunk_uses_tensor_cores(int Q, int hd, int st) {
  return tc_takes(Q, hd, st) ? 1 : 0;
}

// dtype: 0 float32, 1 bfloat16 (xdt, b, c); log_a and the outputs are
// float32.  S is a multiple of Q.  Returns a cudaError_t (0 = launched).
int ssd_intra_chunk_launch(int dtype, int B, int S, int nh, int hd, int st,
                           int Q, const void* xdt, const void* log_a,
                           const void* b, const void* c, void* y, void* h,
                           void* a, void* acum, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  // outputs a thread holds: rows of y, then rows of h
  const int per_thread =
      (std::max(Q * hd, hd * st) + kThreads - 1) / kThreads;
  if ((dtype != 0 && dtype != 1) || Q < 1 || Q > kMaxChunk || S % Q ||
      kThreads % hd || kThreads % st || per_thread > 64 ||
      smem_bytes(Q, hd, st, elem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && tc_takes(Q, hd, st)) {
    switch (hd) {
      case 16: return dispatch_tc<16>(B, S, nh, st, Q, xdt, log_a, b, c, y,
                                      h, a, acum, s);
      case 32: return dispatch_tc<32>(B, S, nh, st, Q, xdt, log_a, b, c, y,
                                      h, a, acum, s);
      case 64: return dispatch_tc<64>(B, S, nh, st, Q, xdt, log_a, b, c, y,
                                      h, a, acum, s);
      default: return dispatch_tc<128>(B, S, nh, st, Q, xdt, log_a, b, c, y,
                                       h, a, acum, s);
    }
  }
  if (dtype == 0)
    return per_thread <= 32
        ? launch<float, 32>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y, h, a,
                            acum, s)
        : launch<float, 64>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y, h, a,
                            acum, s);
  return per_thread <= 32
      ? launch<__nv_bfloat16, 32>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y,
                                  h, a, acum, s)
      : launch<__nv_bfloat16, 64>(B, S, nh, hd, st, Q, xdt, log_a, b, c, y,
                                  h, a, acum, s);
}

}  // extern "C"
