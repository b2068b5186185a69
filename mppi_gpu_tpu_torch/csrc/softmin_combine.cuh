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
//
// What bounds it: reading a robot's nb·(2 + T·A) partial floats (0.75 MB at
// K = 10⁴ in 32-rollout blocks, 1.9 MB at K = 10⁵ in 128-rollout blocks, T =
// 200, A = 3) is 0.2-0.6 µs of the card's bandwidth; what it waits on is the
// latency of each round trip to L2, since the data are small. So every load
// of the fold goes out at once: each thread reads its β_b and η_b once into
// registers (b = thread, thread + 256, …; the first kBetaRegs rows, which is
// every row up to nb = 1024), and the block's ΔŨ loads are issued right
// after them, before the β reduction, as 4-byte cp.async copies into shared
// memory (a partial row is 2 + T·A floats, so its columns are 16-byte
// aligned only by chance: no 16-byte copy, no TMA tensor map). The sums then
// run from shared memory.
//
// Two forms: K2 folds in tiles, which measured faster alone at every shape;
// K2' in one block per robot where ops/fused_solve.combine_one_block(nb, T·A)
// says so, as its tail then needs no ticket, and in tiles elsewhere.
// * tiles (combine_tile): grid (column tiles, R). Block (c, r) folds robot
//   r's columns 32·c .. 32·c + 31 of ΔU, lane i one column; warp w owns rows
//   [w·per, (w + 1)·per), per = ⌈nb/8⌉, and stages up to `staged` of them
//   per lane (every one, unless the shared memory cannot hold them; the rest
//   are streamed through registers eight rows at a time after the staged
//   ones). Every tile computes β, the factors f_b and η over all nb rows.
// * one block per robot (combine_block): grid (1, R). The block copies the
//   robot's whole partials, nb·(2 + T·A) floats, contiguous, into shared
//   memory and folds every column tile itself; K2''s tail then reads ΔU from
//   there, with no ticket.
// Both forms keep the arithmetic and its order: a column's sum over warp w's
// rows in row order (one fused multiply-add per row), the warps' sums added
// in warp order, η per thread over b = thread, thread + 256, … and then the
// block_sum tree, β a min (order-free but for NaN payloads, kept too). So
// the two forms, and the fold before this design, give the same floats bit
// for bit. No atomics: a run repeats bit for bit.

#pragma once

#include "mppi_solve.cuh"

namespace {

// shared memory a block may take, less its static use (ops/fused_solve._SMEM_BYTES)
constexpr int kCombineSmemFloats = (232448 - 1024) / 4;
// rows of β_b and η_b each thread of the fold holds in registers
constexpr int kBetaRegs = 4;

// β, η and f_s[b] = f_b for every row of robot r's partials p (nb rows of
// `stride` = 2 + T·A floats), by every thread of the block. Each thread
// loads its β_b and η_b, then calls issue() (the block's ΔŨ copies go out
// behind those loads), then reduces. Syncs: f_s is visible after it.
template <class Issue>
__device__ __forceinline__ float2 fold_weights(const float* p, size_t stride, int nb, float lam,
                                               float* f_s, float* scratch, Issue issue) {
  float bb[kBetaRegs], eb[kBetaRegs];
#pragma unroll
  for (int i = 0; i < kBetaRegs; ++i) {
    const int b = (int)threadIdx.x + i * kCombineThreads;
    bb[i] = b < nb ? p[b * stride] : 0.0f;
    eb[i] = b < nb ? p[b * stride + 1] : 0.0f;
  }
  issue();
  float m = INFINITY;
#pragma unroll
  for (int i = 0; i < kBetaRegs; ++i) {
    if ((int)threadIdx.x + i * kCombineThreads < nb) m = nan_min(m, bb[i]);
  }
  for (int b = (int)threadIdx.x + kBetaRegs * kCombineThreads; b < nb; b += kCombineThreads)
    m = nan_min(m, p[b * stride]);
  const float beta = block_nan_min<kCombineWarps>(m, scratch);
  float eta_part = 0.0f;
#pragma unroll
  for (int i = 0; i < kBetaRegs; ++i) {
    const int b = (int)threadIdx.x + i * kCombineThreads;
    if (b < nb) {
      const float f = expf((beta - bb[i]) / lam);
      f_s[b] = f;
      eta_part += f * eb[i];
    }
  }
  for (int b = (int)threadIdx.x + kBetaRegs * kCombineThreads; b < nb; b += kCombineThreads) {
    const float f = expf((beta - p[b * stride]) / lam);
    f_s[b] = f;
    eta_part += f * p[b * stride + 1];
  }
  const float eta = block_sum<kCombineWarps>(eta_part, scratch);  // syncs: f_s visible
  return make_float2(beta, eta);
}

// Rows a warp folds: warp w's are [w·per, (w + 1)·per), per = ⌈nb/8⌉.
__device__ __forceinline__ int fold_per(int nb) {
  return (nb + kCombineWarps - 1) / kCombineWarps;
}

// Rows each lane of the tiled form stages in shared memory: all of its
// warp's, or as many as fit beside f_s and the warps' sums.
__host__ __device__ __forceinline__ int tile_staged(int nb) {
  const int per = (nb + kCombineWarps - 1) / kCombineWarps;
  const int room = (kCombineSmemFloats - nb - kCombineThreads) / kCombineThreads;
  return room < 0 ? 0 : (per < room ? per : room);
}

// Shared floats of each form: the tiled f_s, the warps' sums and the staged
// rows; one block's partials, f_s and the warps' sums of every column.
__host__ __device__ __forceinline__ size_t tile_smem_floats(int nb) {
  return (size_t)nb + kCombineThreads + (size_t)kCombineThreads * tile_staged(nb);
}
__host__ __device__ __forceinline__ size_t block_smem_floats(int nb, int TA) {
  return 4 + (size_t)nb * (2 + (size_t)TA) + nb + (size_t)kCombineWarps * TA;
}

// A 16-byte copy into shared memory, around L1: both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// Block (blockIdx.x, r)'s part of K2 in the tiled form for robot r =
// blockIdx.y: β, f_b, η over all nb rows, its 32 columns of ΔU, and β, η
// from tile 0.
__device__ __forceinline__ void combine_tile(const float* __restrict__ partials, int nb, int TA,
                                             float lam, int normalize,
                                             float* __restrict__ beta_eta,
                                             float* __restrict__ dU) {
  extern __shared__ float f_s[];  // (nb,) f_b, the warps' sums, the staged rows
  __shared__ float scratch[kCombineWarps];
  float* red = f_s + nb;           // (kCombineWarps, kCombineCols)
  const int staged = tile_staged(nb);
  const size_t stride = 2 + (size_t)TA;
  const size_t r = blockIdx.y;
  partials += r * nb * stride;
  beta_eta += 2 * r;
  dU += r * TA;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * kCombineCols + lane;
  const int per = fold_per(nb);
  const int b0 = warp * per, b_end = min(nb, b0 + per);
  const int n_staged = max(0, min(b_end - b0, staged));
  // lane's rows b0 + j at mine[32·j]
  float* mine = red + kCombineWarps * kCombineCols + (size_t)warp * staged * kCombineCols + lane;
  const float* p = partials + 2 + col;
  const float2 be = fold_weights(partials, stride, nb, lam, f_s, scratch, [&] {
    if (col < TA) {
      for (int j = 0; j < n_staged; ++j) cp_async4(mine + j * kCombineCols, p + (b0 + j) * stride);
    }
  });
  float s = 0.0f;
  if (col < TA) {
    cp_async_wait_all();  // this lane's own copies: no other thread reads them
    for (int j = 0; j < n_staged; ++j) s += f_s[b0 + j] * mine[j * kCombineCols];
    for (int b = b0 + n_staged; b < b_end; b += kCombineUnroll) {  // past what shared memory holds
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
    dU[col] = normalize ? t / be.y : t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    beta_eta[0] = be.x;
    beta_eta[1] = be.y;
  }
}

// Robot r = blockIdx.y's fold in the one-block form (K2''s): its partials copied into
// shared memory, β, f_b, η, every column of ΔU and β, η. Returns ΔU in
// shared memory (T·A floats past the partials' copy, whose first
// 4 + nb·(2 + T·A) floats are free for the caller after a __syncthreads()).
__device__ __forceinline__ const float* combine_block(const float* __restrict__ partials, int nb,
                                                      int TA, float lam, int normalize,
                                                      float* __restrict__ beta_eta,
                                                      float* __restrict__ dU) {
  // 4 floats of slack, the partials from `o` on (o: the floats src lies past
  // a 16-byte boundary, so src + i and slab + i share their alignment), then
  // f_s (nb,), then the warps' sums (kCombineWarps, T·A)
  extern __shared__ __align__(16) float block_smem[];
  __shared__ float scratch[kCombineWarps];
  const int stride = 2 + TA;
  const int n = nb * stride;
  const size_t r = blockIdx.y;
  partials += r * n;
  beta_eta += 2 * r;
  dU += r * TA;
  float* slab = block_smem + ((reinterpret_cast<size_t>(partials) >> 2) & 3);
  float* f_s = block_smem + 4 + n;
  float* red = f_s + nb;
  const float2 be = fold_weights(partials, stride, nb, lam, f_s, scratch, [&] {
    // the head to the first 16-byte boundary and the tail 4 bytes at a time,
    // the rest 16 bytes at a time
    const int head = min(n, (int)((16 - (reinterpret_cast<size_t>(partials) & 15)) & 15) >> 2);
    const int body = (n - head) >> 2;
    for (int i = threadIdx.x; i < head; i += kCombineThreads) cp_async4(slab + i, partials + i);
    for (int v = threadIdx.x; v < body; v += kCombineThreads) {
      cp_async16(slab + head + 4 * v, partials + head + 4 * v);
    }
    for (int i = head + 4 * body + threadIdx.x; i < n; i += kCombineThreads) {
      cp_async4(slab + i, partials + i);
    }
  });
  cp_async_wait_all();
  __syncthreads();  // every thread's copies visible
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = fold_per(nb);
  const int b0 = warp * per, b_end = min(nb, b0 + per);
  // warp w's sum of every column, four tiles of 32 at a time (four
  // independent chains, each over the rows in row order)
  constexpr int kTiles = 4;
  for (int c0 = 0; c0 < TA; c0 += kTiles * kCombineCols) {
    float s[kTiles];
#pragma unroll
    for (int u = 0; u < kTiles; ++u) s[u] = 0.0f;
    for (int b = b0; b < b_end; ++b) {
      const float f = f_s[b];
      const float* row = slab + b * stride + 2 + c0 + lane;
#pragma unroll
      for (int u = 0; u < kTiles; ++u) {
        if (c0 + u * kCombineCols + lane < TA) s[u] += f * row[u * kCombineCols];
      }
    }
#pragma unroll
    for (int u = 0; u < kTiles; ++u) {
      const int col = c0 + u * kCombineCols + lane;
      if (col < TA) red[warp * TA + col] = s[u];
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < TA; col += kCombineThreads) {
    float t = red[col];
#pragma unroll
    for (int w = 1; w < kCombineWarps; ++w) t += red[w * TA + col];
    const float d = normalize ? t / be.y : t;
    dU[col] = d;
    red[col] = d;  // only this thread reads column col's sums
  }
  if (threadIdx.x == 0) {
    beta_eta[0] = be.x;
    beta_eta[1] = be.y;
  }
  return red;
}

// Shared bytes of the fold in either form.
inline size_t fold_smem_bytes(int nb, int TA, int one_block) {
  return (one_block ? block_smem_floats(nb, TA) : tile_smem_floats(nb)) * sizeof(float);
}

}  // namespace
