// K2's fold, shared by K2 (softmin_combine_kernel, mppi_solve.cu) and by K2
// with the solve's tail as its epilogue (combine_tail_kernel, combine_tail.cu),
// so the two compute the same β, η and ΔU bit for bit.
//
// K2 replaces the cross-tile fold of the TPU one-pass kernels (single-robot
// and fleet), mppi_gpu_tpu/ops/pallas_rollout.py:_online_softmin_step (:1847)
// and the two-pass fleet kernel's _softmin_phase (:2257), which
// rescales a running (β, η, ΔŨ) tile by tile; it is the same associative
// combine the sharded path applies across devices
// (mppi_gpu_tpu/controller.py:488-500):
//   β = min_b β_b,  f_b = exp((β − β_b)/λ),  η = Σ f_b η_b,
//   ΔU = Σ f_b ΔŨ_b / η,
// or Σ f_b ΔŨ_b without the division (`normalize` 0): a rank's unnormalized
// share for the one-pass sharded combine, and K5's fold, whose partials have
// β_b = η_b = 0 and so f_b = 1.
// What bounds it: reading a robot's nb·(2 + T·A) partial floats (0.75 MB at
// K = 10⁴ in 32-rollout blocks, 1.9 MB at K = 10⁵ in 128-rollout blocks, T =
// 200, A = 3): bytes, and in practice the latency of each load, since the
// data are small. Design: grid (column tiles, R). Block (c, r) folds robot
// r's columns 32·c .. 32·c + 31 of ΔU, lane i one column, with its eight
// warps each owning a fixed range of the nb rows and keeping eight row loads
// in flight per lane (coalesced: a row's 32 columns are 128 B); the warps'
// sums are added in shared memory in warp order. Every tile first computes
// β, the factors f_b and η over all nb rows by the same threads in the same
// order, so the tiles agree on them bit for bit. No atomics: every sum has
// a fixed order and a run repeats bit for bit. Tile 0 writes beta_eta[r].

#pragma once

#include "mppi_solve.cuh"

namespace {

// Block (blockIdx.x, r)'s part of K2 for robot r = blockIdx.y: β, f_b, η
// over all nb rows, its 32 columns of ΔU, and β, η from tile 0.
__device__ __forceinline__ void combine_fold(const float* __restrict__ partials, int nb, int TA,
                                             float lam, int normalize,
                                             float* __restrict__ beta_eta,
                                             float* __restrict__ dU) {
  extern __shared__ float f_s[];  // (nb,) rescale factors f_b, then the warps' sums
  __shared__ float scratch[kCombineWarps];
  float* red = f_s + nb;          // (kCombineWarps, kCombineCols)
  const size_t stride = 2 + (size_t)TA;
  const size_t r = blockIdx.y;
  partials += r * nb * stride;
  beta_eta += 2 * r;
  dU += r * TA;
  float m = INFINITY;
  for (int b = threadIdx.x; b < nb; b += kCombineThreads) m = nan_min(m, partials[b * stride]);
  const float beta = block_nan_min<kCombineWarps>(m, scratch);
  float eta_part = 0.0f;
  for (int b = threadIdx.x; b < nb; b += kCombineThreads) {
    const float f = expf((beta - partials[b * stride]) / lam);
    f_s[b] = f;
    eta_part += f * partials[b * stride + 1];
  }
  const float eta = block_sum<kCombineWarps>(eta_part, scratch);  // syncs: f_s visible
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCombineCols + lane;
  const int per = (nb + kCombineWarps - 1) / kCombineWarps;
  const int b_end = min(nb, (warp + 1) * per);
  float s = 0.0f;
  if (col < TA) {
    const float* p = partials + 2 + col;
    for (int b = warp * per; b < b_end; b += kCombineUnroll) {
      float v[kCombineUnroll];
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) v[u] = b + u < b_end ? p[(b + u) * stride] : 0.0f;
#pragma unroll
      for (int u = 0; u < kCombineUnroll; ++u) {
        if (b + u < b_end) s += f_s[b + u] * v[u];
      }
    }
  }
  red[warp * kCombineCols + lane] = s;
  __syncthreads();
  if (warp == 0 && col < TA) {
    float t = red[lane];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) t += red[w * kCombineCols + lane];
    dU[col] = normalize ? t / eta : t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    beta_eta[0] = beta;
    beta_eta[1] = eta;
  }
}

}  // namespace
