// Placement feasibility + variance-min score for a whole sweep batch.
//
// Replaces the Pallas TPU kernel `placement_score`
// (src/repro/kernels/placement_score/kernel.py, body `_score_kernel`) and
// the feed gather its wrapper `score_rows` left to XLA.
//
// One thread scores one (configuration n, row r); the grid covers
// N x ceil(R / 256).  Each thread reads its row's feed ids and gathers the
// per-line-up HA load, total load and rating of its <= 4 feeds itself, so
// one launch per event step covers every configuration of the batch.
//
// What bounds it: bytes.  A thread does ~60 float operations on ~40 bytes
// of row data plus 12 bytes per feed gathered from [N, X] line-up arrays
// that stay in L2.  The design reads each row's data once, coalesced
// across neighbouring rows, and writes 5 bytes per row; nothing else
// touches device memory.  At sweep sizes (~10^5 rows) a launch is a few
// microseconds, so the event loop around it, not the kernel, sets the pace.
//
// Numerics follow the plain version (ref.py) operation for operation:
// build with -fmad=false (no contraction of a*b+c), IEEE division (the
// nvcc default) and no fast math, and sum the four feed terms as
// ((t0 + t1) + t2) + t3.  Then `feas` is bitwise and the score is bitwise
// at feasible rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFeeds = 4;
constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr float kSlack = 1e-4f;

__global__ void placement_score_kernel(
    int n_rows, int n_lineups,
    const int32_t* __restrict__ row_feeds,   // [N, R, 4], -1 padded
    const int32_t* __restrict__ row_nfeeds,  // [N, R]
    const float* __restrict__ row_cap,       // [N, R, 4]; power column read
    const float* __restrict__ row_load,      // [N, R, 4]; power column read
    const float* __restrict__ lineup_ha,     // [N, X]
    const float* __restrict__ lineup_tot,    // [N, X]
    const float* __restrict__ lineup_cap,    // [N, X]
    const float* __restrict__ p_dep,         // [N]
    const float* __restrict__ ha_frac,       // [N]
    const uint8_t* __restrict__ is_ha,       // [N]
    const uint8_t* __restrict__ is_block,    // [N]
    uint8_t* __restrict__ feas,              // [N, R]
    float* __restrict__ score) {             // [N, R]
  const int n = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const int64_t row = static_cast<int64_t>(n) * n_rows + r;
  const int64_t lu0 = static_cast<int64_t>(n) * n_lineups;

  const float p = p_dep[n];
  const float hf = ha_frac[n];
  const bool ha_tier = is_ha[n] != 0;
  const bool block = is_block[n] != 0;

  const float nf = static_cast<float>(row_nfeeds[row]);
  const float share = p / fmaxf(nf, 1.0f);         // balanced share P/k
  const float delta = p / fmaxf(nf - 1.0f, 1.0f);  // failover (Eq. 1)

  bool power_ok = true;
  float term[kMaxFeeds];
#pragma unroll
  for (int j = 0; j < kMaxFeeds; ++j) {
    const int32_t x = row_feeds[row * kMaxFeeds + j];
    const bool valid = x >= 0;
    const int64_t safe = lu0 + (valid ? x : 0);
    const float cap = lineup_cap[safe];
    const float ha = lineup_ha[safe];
    const float tot = lineup_tot[safe];
    const bool tot_ok = tot + share <= cap + kSlack;
    const bool ha_ok = (ha + delta <= hf * cap + kSlack) && tot_ok;
    const bool block_ok = tot + p <= cap + kSlack;   // quantization (Eq. 2)
    const bool per_feed = block ? block_ok : (ha_tier ? ha_ok : tot_ok);
    power_ok = power_ok && (per_feed || !valid);
    const float capm = fmaxf(cap, 1.0f);
    const float s = share / capm;
    const float lhat = (ha_tier ? ha : tot) / capm;
    const float t = 2.0f * lhat * s + s * s;
    term[j] = valid ? t : 0.0f;
  }
  const bool fits = row_load[row * kMaxFeeds] + p <= row_cap[row * kMaxFeeds] + kSlack;
  const bool f = power_ok && fits;
  const float var = ((term[0] + term[1]) + term[2]) + term[3];
  feas[row] = f ? 1 : 0;
  score[row] = f ? var : kBig;
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError() after the launch.
extern "C" int placement_score_launch(
    int n_configs, int n_rows, int n_lineups,
    const void* row_feeds, const void* row_nfeeds, const void* row_cap,
    const void* row_load, const void* lineup_ha, const void* lineup_tot,
    const void* lineup_cap, const void* p_dep, const void* ha_frac,
    const void* is_ha, const void* is_block, void* feas, void* score,
    void* stream) {
  const dim3 grid((n_rows + kThreads - 1) / kThreads, n_configs);
  placement_score_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_lineups, static_cast<const int32_t*>(row_feeds),
      static_cast<const int32_t*>(row_nfeeds),
      static_cast<const float*>(row_cap), static_cast<const float*>(row_load),
      static_cast<const float*>(lineup_ha),
      static_cast<const float*>(lineup_tot),
      static_cast<const float*>(lineup_cap), static_cast<const float*>(p_dep),
      static_cast<const float*>(ha_frac), static_cast<const uint8_t*>(is_ha),
      static_cast<const uint8_t*>(is_block), static_cast<uint8_t*>(feas),
      static_cast<float*>(score));
  return static_cast<int>(cudaGetLastError());
}
