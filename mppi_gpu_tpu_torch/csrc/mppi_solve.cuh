// The shared machinery of K1 and K4, the fused solve's rollout kernels
// (ops/_build.py, ops/fused_solve.py): everything a family instance needs,
// included by mppi_solve.cu (the built-in families, K2, K3, K5 and the C
// entries) and by the one-file library that ops/_build.build_family
// generates for a family registered from user code (ops/families.py).
//
//   NoiseParams, make_noise     the Philox key, counter words and noise mode
//   draw_normals, shape_eps     the draw of one (rollout, step) and its shaping
//   rollout_step                one horizon step: control cost, family step,
//                               state cost, Kahan sum
//   solve_partials_kernel       K1's and K4's per-rollout body (128 per block)
//   slab_partials_kernel        K1's and K4's slab body (32 per block)
//   SolveArgs, launch_partials, launch_mode
//                               the launch of one body for a family struct F
//
// A family is a struct F with
//   static constexpr int kS;        its state dimension, the floats of x
//   static constexpr bool kGoal;    whether it reads robot r's goal (kS floats)
//   __device__ void load(const float* fp, const float* goal, float dt);
//                                   fp: the family part of the pack, past σ
//                                   and Σ⁻¹; goal null unless kGoal
//   __device__ void step(float x[kS], const float ue[A]) const;
//                                   x ← x' under the action u + ε
//   __device__ float cost(const float x[kS]) const;
//                                   the state cost of x
// whose arithmetic repeats its plain version's (explicitly rounded
// __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn in the eager model's order,
// full-precision sinf/cosf), as the built-in structs in mppi_solve.cu do.
// K1 is launch_mode<F, A, true>, K4 launch_mode<F, A, false>.
//
// Everything here lives in an anonymous namespace: each translation unit
// that includes the header compiles its own copy, and the two libraries
// export nothing of it.

#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // threads = rollouts per block of K1's per-rollout body;
                             // ops/fused_solve.BLOCK
constexpr int kWarps = kBlock / 32;
constexpr int kSlabRollouts = 32;  // rollouts per block of K1's slab body; ops/fused_solve.SLAB_WIDTH
constexpr int kSlabWarps = 8;      // warp 0 rolls out, warps 1-7 draw
constexpr int kSlabThreads = 32 * kSlabWarps;
constexpr int kDrawWarps = kSlabWarps - 1;
constexpr int kChunk = kDrawWarps;  // horizon steps per pipeline stage: one per draw warp
constexpr int kCombineThreads = 256;
constexpr int kMaxRobots = 65535;  // gridDim.y of K1 and K2; ops/fused_solve.MAX_ROBOTS
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr int kCombineCols = 32;   // columns of ΔU per K2 block, one per lane
constexpr int kCombineUnroll = 8;  // partial rows each K2 lane has in flight
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.28318530717958647692f;    // rounds to float(2π)

struct NoiseParams {
  unsigned key0, key1, step, it;  // Philox key and counter words 2, 3
  unsigned k0;                    // draw offset: counter word 0 = k0 + draw index
  int K, K_draw;                  // K_draw = K/2 under antithetic, else K
  int antithetic;
  float ou_beta, ou_c;            // OU recursion; ou_beta == 0 → iid
};

__device__ __forceinline__ void philox4x32_10(unsigned c[4], unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned lo0 = 0xD2511F53u * c[0], hi0 = __umulhi(0xD2511F53u, c[0]);
    const unsigned lo1 = 0xCD9E8D57u * c[2], hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const unsigned n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The draw part of the noise: draw kd's Box-Muller normals n at step t from
// its Philox words, which `w` returns. It depends on (kd, t) alone, so the
// slab body draws every step of the horizon in parallel.
template <int A>
__device__ __forceinline__ void draw_normals(const NoiseParams& np, int kd, int t, float n[A],
                                             unsigned w[4]) {
  w[0] = np.k0 + (unsigned)kd;
  w[1] = (unsigned)t;
  w[2] = np.step;
  w[3] = np.it;
  philox4x32_10(w, np.key0, np.key1);
#pragma unroll
  for (int p = 0; p < (A + 1) / 2; ++p) {
    const float u1 = __fmul_rn(__uint2float_rn(w[2 * p] >> 8), kInv2p24);
    const float u2 = __fmul_rn(__uint2float_rn(w[2 * p + 1] >> 8), kInv2p24);
    const float r = sqrtf(__fmul_rn(-2.0f, log1pf(-u1)));
    const float th = __fmul_rn(u2, kTwoPi);
    n[2 * p] = __fmul_rn(r, cosf(th));
    if (2 * p + 1 < A) n[2 * p + 1] = __fmul_rn(r, sinf(th));
  }
}

// The shaping part, sequential in t: normals n → OU → σ → antithetic sign.
// `e` carries the unit-variance OU state across t.
template <int A>
__device__ __forceinline__ void shape_eps(const NoiseParams& np, const float* sig, bool mirror,
                                          int t, const float n[A], float e[A], float eps[A]) {
  const bool ou = np.ou_beta > 0.0f && t > 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    e[a] = ou ? __fadd_rn(__fmul_rn(np.ou_beta, e[a]), __fmul_rn(np.ou_c, n[a])) : n[a];
    const float s = __fmul_rn(sig[a], e[a]);
    eps[a] = mirror ? -s : s;
  }
}

// Rollout k's ε at step t: both parts in one thread; `w` returns the four
// Philox words of the draw.
template <int A>
__device__ __forceinline__ void next_eps(const NoiseParams& np, const float* sig, int kd,
                                         bool mirror, int t, float e[A], float eps[A],
                                         unsigned w[4]) {
  float n[A];
  draw_normals<A>(np, kd, t, n, w);
  shape_eps<A>(np, sig, mirror, t, n, e, eps);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;  // NaN propagates, like torch.min
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_nan_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions in a fixed order (deterministic run to run).
// `scratch` holds one float per warp; every thread gets the result.
template <int NW>
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = scratch[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) s += scratch[i];
  __syncthreads();
  return s;
}

template <int NW>
__device__ __forceinline__ float block_nan_min(float v, float* scratch) {
  v = warp_nan_min(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = scratch[0];
#pragma unroll
  for (int i = 1; i < NW; ++i) m = nan_min(m, scratch[i]);
  __syncthreads();
  return m;
}

// ---- shared-memory barriers and asynchronous copies (the slab body) --------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// one arrival, with release semantics: the caller's shared-memory writes
// before it are visible to a thread whose wait on the phase returns
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];" : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}

// wait (acquire) until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::: "memory");
}

// One horizon step of a rollout from its ε: the control cost u·Σ⁻¹·ε, the
// family's step and state cost, added to the Kahan-compensated sum (acc,
// comp). Explicitly rounded, in the plain version's order (models/,
// ops/cost): both bodies and both modes of K1 and K4 step bit-identical
// states and costs from bit-identical ε.
template <class F, int A>
__device__ __forceinline__ void rollout_step(const F& fam, float* x, const float* u_t,
                                             const float* lis, const float* eps, float lam_cost,
                                             float& acc, float& comp) {
  float ue[A], ctrl = 0.0f;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float u = u_t[a];
    ue[a] = __fadd_rn(u, eps[a]);
    ctrl = __fadd_rn(ctrl, __fmul_rn(__fmul_rn(u, lis[a]), eps[a]));
  }
  fam.step(x, ue);
  const float step_cost = __fadd_rn(__fmul_rn(lam_cost, ctrl), fam.cost(x));
  const float y = __fsub_rn(step_cost, comp);
  const float sum = __fadd_rn(acc, y);
  // an infinite sum stays infinite (a diverged rollout costs +inf, never NaN)
  comp = isfinite(sum) ? __fsub_rn(__fsub_rn(sum, acc), y) : 0.0f;
  acc = sum;
}

// K1. Replaces the TPU solve kernels of mppi_gpu_tpu/ops/pallas_rollout.py:
// _onepass_solve_kernel (:2342), _planar_onepass_kernel (:2686) and
// _fused_solve_kernel (:2287), and their fleet forms
// _fleet_onepass_solve_kernel (:3121), _fleet_fused_solve_kernel (:2973) and
// _planar_fleet_onepass_kernel (:3078), whose grid (R, tiles) runs the same
// per-tile bodies robot after robot; for the families of
// _LTIQuadFamily (:490), _PendulumFamily (:614), _CartPoleFamily (:700),
// _LTIObstacleFamily (:805), _QuadrotorFamily (:930), _UnicycleFamily
// (:1101), _ArmFamily (:1264) and _Quadrotor3DFamily (:1468). The TPU plans
// the coupled families (unicycle, quadrotor, arm, 3-D quadrotor) on the
// state-planar kernels only; here every family takes the one layout.
//
// What bounds it: arithmetic, not memory. Per rollout and step it does one
// Philox call (10 rounds of two 32-bit multiply-high), one or two Box-Muller
// pairs (log1p, sqrt, cos, sin) and the family's step and cost: ~10 flops for
// LTI; two sinf, one cosf and two divides for the pendulum; two sinf, three
// cosf and eight divides for the cart-pole; one Box-Muller pair at A = 2 and,
// for the unicycle, three sinf, two cosf and one rsqrtf; the quadrotor, two
// sinf, three cosf and five divides; the arm, two stages of one sinf, three
// cosf and one divide, and two sinf and two cosf in its cost; the obstacle
// cost, LTI's plus A multiply-adds and a compare per obstacle; the 3-D
// quadrotor, no trigonometry but eight divides, one rsqrtf and ~120 other
// flops on its 13 states. K4 does the rollout alone. The only traffic is U
// and the parameters (read once into shared memory/registers), S (4 B per
// rollout) and one (2 + T·A)-float partial per block. In the injected-ε mode
// it instead streams T·A·4 B per rollout (twice in the per-rollout body).
//
// Design: the TPU kernels stage the tile's ε in VMEM for the ΔU pass. The
// cross-tile online softmin of the TPU kernel, which relies on the grid
// running in order, becomes an associative per-block partial (β_b, η_b,
// ΔŨ_b) folded by K2, the same combine the sharded path uses across devices.
// The TPU kernels' trig carry (_sincos_small :455) is not used: it saves TPU
// transcendentals and holds only for small angle steps. Two bodies, one per
// regime (ops/fused_solve.block_width picks by the grid's size):
//
// * The per-rollout body (solve_partials_kernel, 128 rollouts per block)
//   fills the card when R·K is large. One thread per rollout walks the
//   horizon twice: pass 1 rolls out, pass 2 regenerates ε from the counter
//   (Philox is stateless; a thread's ε for a whole horizon fits neither its
//   registers nor, at 2048 rollouts per SM, shared memory) and reduces
//   Σ_k e_k ε_k[t, a] by warp shuffles into shared memory, summed over the
//   warps in a fixed order. The second draw costs about half its
//   instructions.
// * The slab body (slab_partials_kernel, 32 rollouts per block) is for the
//   main path's K, where 128-rollout blocks leave most SMs empty and one
//   warp per SM sub-partition runs the serial chain of Philox, Box-Muller,
//   step, cost and Kahan sum with nothing to hide its latency. The draw of
//   (k, t) depends on nothing before it, so seven draw warps fill a
//   shared-memory slab with the block's normals for every step, in parallel
//   over t, and only what is sequential in t stays in the rollout warp: the
//   OU recursion, σ and the mirror (shape_eps, in next_eps's order of
//   rounded operations, so S is the per-rollout body's bit for bit), the
//   step, the cost and the Kahan sum. The rollout warp writes the final ε
//   back into the slab. The two phases are pipelined over chunks of seven
//   steps, one mbarrier per chunk: the draw warps never wait (the slab holds
//   the whole horizon, no slot is reused), the rollout warp waits for each
//   chunk's seven arrivals. ΔŨ_b[t, a] = Σ_j e_j ε_j[t, a] is then a
//   32-long dot product per (t, a) read from the slab, one warp per row, in a
//   fixed order: no second draw. Tensor cores do not serve this reduction:
//   it is a matrix-vector product (no reuse to feed them), and the replay
//   checks need exact float32 products. The slab is 32·T·A floats (76.8 KB
//   at T = 200, A = 3), so an SM holds two such blocks: past about a full
//   card of per-rollout blocks, 64 rollout threads per SM cannot hide the
//   family's step latency and the per-rollout body is faster. In the
//   injected-ε mode the draw warps fill the slab with coalesced 4-byte
//   cp.async copies of each step's contiguous 32·A floats.
//
// Fleet: block (b, r) is block b of robot r; robots run side by side on the
// SMs, not in turn as on the TPU. All robot offsets are size_t: at R = 64,
// K = 10⁵ the partials alone are 30 M floats, and an injected (R, T, K, A) ε
// passes 2³¹ elements. `keys` holds every robot's (R,) int64 seed, whose low
// and high words are its Philox key; null means every robot uses
// np.key0/np.key1, which is how the single-robot solve runs without a seed
// tensor on the device. `step_ptr`, when set, points at the control step (a
// 0-dim int64 on the device) whose low word replaces np.step: a CUDA graph
// that captured the launch replays each cycle's step, where a step passed by
// value would be frozen at the captured one. Every thread reads it once,
// before its first draw, as it reads its robot's seed. `params` is [σ (A), Σ⁻¹ (A), family part]; `goal`
// (R, kS) is read by families with kGoal only.
//
// K4, the costs-only sweep (PASS2 = false), replaces _rollout_cost_kernel
// (:1952) and _planar_costs_kernel (:2813): pass 1 alone, writing S and no
// partials (`partials` may be null). It is the floor of a solve, the work
// every solve does before its softmin and ΔU pass.
template <class F, int A, bool INJ, bool PASS2>
__global__ void __launch_bounds__(kBlock) solve_partials_kernel(
    const float* __restrict__ x0, const float* __restrict__ U,
    const float* __restrict__ params, const float* __restrict__ goal,
    const long long* __restrict__ keys, const long long* __restrict__ step_ptr,
    const float* __restrict__ eps_in, float* __restrict__ S_out, float* __restrict__ partials,
    int T, float dt, float lam_cost, float lam_softmin, NoiseParams np) {
  constexpr int S_DIM = F::kS;
  extern __shared__ float smem[];
  __shared__ float scratch[kWarps];
  const int TA = T * A;
  const size_t r = blockIdx.y;
  x0 += r * S_DIM;
  U += r * TA;
  if (F::kGoal) goal += r * S_DIM;
  S_out += r * np.K;
  if (INJ) eps_in += r * TA * (size_t)np.K;
  if (keys != nullptr) {
    const unsigned long long seed = (unsigned long long)keys[r];
    np.key0 = (unsigned)(seed & 0xFFFFFFFFull);
    np.key1 = (unsigned)(seed >> 32);
  }
  if (step_ptr != nullptr) np.step = (unsigned)(unsigned long long)*step_ptr;
  float* u_s = smem;         // (T, A) nominal sequence
  float* red = smem + TA;    // (kWarps, T, A) per-warp Σ e·ε
  for (int i = threadIdx.x; i < TA; i += kBlock) u_s[i] = U[i];

  float sig[A], lis[A], x[S_DIM], e[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    sig[a] = params[a];
    lis[a] = params[A + a];
  }
  F fam;
  fam.load(params + 2 * A, goal, dt);
  __syncthreads();

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < np.K;
  const bool mirror = np.antithetic && k >= np.K_draw;
  const int kd = mirror ? k - np.K_draw : k;
  unsigned words[4];

  // ---- pass 1: rollout and cost -------------------------------------------
  float S = INFINITY;
  if (valid) {
#pragma unroll
    for (int i = 0; i < S_DIM; ++i) x[i] = x0[i];
#pragma unroll
    for (int a = 0; a < A; ++a) e[a] = 0.0f;
    float acc = 0.0f, comp = 0.0f;  // Kahan-compensated Σ_t step cost
    for (int t = 0; t < T; ++t) {
      float eps[A];
      if (INJ) {
#pragma unroll
        for (int a = 0; a < A; ++a) eps[a] = eps_in[((size_t)t * np.K + k) * A + a];
      } else {
        next_eps<A>(np, sig, kd, mirror, t, e, eps, words);
      }
      rollout_step<F, A>(fam, x, u_s + t * A, lis, eps, lam_cost, acc, comp);
    }
    // terminal cost: x_T's state cost counted again (reference parity)
    S = __fadd_rn(acc, fam.cost(x));
    S_out[k] = S;
  }
  if (!PASS2) return;

  // ---- block softmin partial ----------------------------------------------
  const float beta_b = block_nan_min<kWarps>(valid ? S : INFINITY, scratch);
  const bool all_inf = beta_b == INFINITY;
  const float ek = (valid && !all_inf) ? expf(-(S - beta_b) / lam_softmin) : 0.0f;
  const float eta_b = block_sum<kWarps>(ek, scratch);

  // ---- pass 2: ΔŨ_b[t, a] = Σ_k e_k ε_k[t, a], ε regenerated ---------------
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int a = 0; a < A; ++a) e[a] = 0.0f;
  for (int t = 0; t < T; ++t) {
    float eps[A];
#pragma unroll
    for (int a = 0; a < A; ++a) eps[a] = 0.0f;
    if (valid) {
      if (INJ) {
#pragma unroll
        for (int a = 0; a < A; ++a) eps[a] = eps_in[((size_t)t * np.K + k) * A + a];
      } else {
        next_eps<A>(np, sig, kd, mirror, t, e, eps, words);
      }
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float v = warp_sum(ek * eps[a]);
      if (lane == 0) red[warp * TA + t * A + a] = v;
    }
  }
  __syncthreads();
  float* part = partials + (r * gridDim.x + blockIdx.x) * (2 + (size_t)TA);
  for (int i = threadIdx.x; i < TA; i += kBlock) {
    float s = red[i];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) s += red[wi * TA + i];
    part[2 + i] = s;
  }
  if (threadIdx.x == 0) {
    part[0] = beta_b;
    part[1] = eta_b;
  }
}

// Dynamic shared memory of the slab body: one mbarrier per chunk, U, the
// block's softmin weights e_j and the slab (ops/fused_solve.slab_bytes).
size_t slab_smem(int T, int A) {
  const size_t chunks = (T + kChunk - 1) / kChunk;
  return 8 * chunks + sizeof(float) * ((size_t)(kSlabRollouts + 1) * T * A + kSlabRollouts);
}

// K1's and K4's slab body (see K1's note above): block (b, r) rolls out
// robot r's rollouts 32·b .. 32·b + 31, lane j of every warp standing for
// rollout 32·b + j. Warps 1-7 draw (or, injected, copy) step c·7 + w − 1 of
// every chunk c into the slab, (T, A, 32) floats at (t·A + a)·32 + j, and
// arrive on chunk c's mbarrier; warp 0 waits for each chunk, shapes and
// writes back ε, and steps the family. Lanes past K draw nothing, hold ε = 0
// and never enter β, η or ΔŨ.
// Two blocks per SM (the shared memory holds two slabs at T = 200): up to
// 128 registers a thread, room for the 3-D quadrotor's state and its
// midpoint without spilling.
template <class F, int A, bool INJ, bool PASS2>
__global__ void __launch_bounds__(kSlabThreads, 2) slab_partials_kernel(
    const float* __restrict__ x0, const float* __restrict__ U,
    const float* __restrict__ params, const float* __restrict__ goal,
    const long long* __restrict__ keys, const long long* __restrict__ step_ptr,
    const float* __restrict__ eps_in, float* __restrict__ S_out, float* __restrict__ partials,
    int T, float dt, float lam_cost, float lam_softmin, NoiseParams np) {
  constexpr int S_DIM = F::kS;
  constexpr int G = kSlabRollouts;
  extern __shared__ __align__(16) unsigned long long slab_raw[];
  const int TA = T * A;
  const int chunks = (T + kChunk - 1) / kChunk;
  unsigned long long* bars = slab_raw;                      // (chunks,)
  float* u_s = reinterpret_cast<float*>(slab_raw + chunks);  // (T, A) nominal sequence
  float* e_s = u_s + TA;                                     // (G,) softmin weights e_j
  float* slab = e_s + G;                                     // (T, A, G) normals, then ε
  const size_t r = blockIdx.y;
  x0 += r * S_DIM;
  U += r * TA;
  if (F::kGoal) goal += r * S_DIM;
  S_out += r * np.K;
  if (INJ) eps_in += r * TA * (size_t)np.K;
  if (keys != nullptr) {
    const unsigned long long seed = (unsigned long long)keys[r];
    np.key0 = (unsigned)(seed & 0xFFFFFFFFull);
    np.key1 = (unsigned)(seed >> 32);
  }
  if (step_ptr != nullptr) np.step = (unsigned)(unsigned long long)*step_ptr;
  for (int i = threadIdx.x; i < TA; i += kSlabThreads) u_s[i] = U[i];
  for (int c = threadIdx.x; c < chunks; c += kSlabThreads) mbar_init(bars + c, kDrawWarps);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = blockIdx.x * G;
  const int k = kb + lane;
  const bool valid = k < np.K;
  const bool mirror = np.antithetic && k >= np.K_draw;
  const int kd = mirror ? k - np.K_draw : k;
  float* part = PASS2 ? partials + (r * gridDim.x + blockIdx.x) * (2 + (size_t)TA) : nullptr;

  if (warp > 0) {
    // ---- draw warps: step t = c·7 + warp − 1 of chunk c, in parallel over t --
    for (int c = 0; c < chunks; ++c) {
      const int t = c * kChunk + warp - 1;
      if (t < T) {
        float* row = slab + (size_t)t * A * G;
        if (INJ) {
          // step t's G·A floats are contiguous in eps_in (rollout-major); the
          // slab holds them action-major
          const float* src = eps_in + ((size_t)t * np.K + kb) * A;
          for (int i = lane; i < G * A; i += 32) {
            const int j = i / A, a = i - j * A;
            if (kb + j < np.K) {
              cp_async4(row + a * G + j, src + i);
            } else {
              row[a * G + j] = 0.0f;
            }
          }
          cp_async_wait_all();
        } else {
          float n[A];
          unsigned w[4];
          if (valid) draw_normals<A>(np, kd, t, n, w);
#pragma unroll
          for (int a = 0; a < A; ++a) row[a * G + lane] = valid ? n[a] : 0.0f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + c);
    }
  } else {
    // ---- rollout warp: shape ε, step, cost, chunk by chunk ---------------------
    float sig[A], lis[A], x[S_DIM], e[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      sig[a] = params[a];
      lis[a] = params[A + a];
      e[a] = 0.0f;
    }
    F fam;
    fam.load(params + 2 * A, goal, dt);
#pragma unroll
    for (int i = 0; i < S_DIM; ++i) x[i] = x0[i];
    float acc = 0.0f, comp = 0.0f;  // Kahan-compensated Σ_t step cost
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(bars + c, 0);
      if (!valid) continue;
      const int t_end = min(T, (c + 1) * kChunk);
      float* cell = slab + (size_t)c * kChunk * A * G + lane;
      float next[A];  // the next step's normals (or injected ε), loaded a step
                      // ahead: no shared-memory load sits on the step's chain
#pragma unroll
      for (int a = 0; a < A; ++a) next[a] = cell[a * G];
      // not unrolled: a family's step inlined seven times would overflow the
      // instruction cache (the arm's twelve sinf/cosf calls per step)
#pragma unroll 1
      for (int t = c * kChunk; t < t_end; ++t, cell += A * G) {
        float n[A], eps[A];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          n[a] = next[a];
          if (t + 1 < t_end) next[a] = cell[(A + a) * G];
        }
        if (INJ) {
#pragma unroll
          for (int a = 0; a < A; ++a) eps[a] = n[a];
        } else {
          shape_eps<A>(np, sig, mirror, t, n, e, eps);
          if (PASS2) {
#pragma unroll
            for (int a = 0; a < A; ++a) cell[a * G] = eps[a];
          }
        }
        rollout_step<F, A>(fam, x, u_s + t * A, lis, eps, lam_cost, acc, comp);
      }
    }
    float S = INFINITY;
    if (valid) {
      // terminal cost: x_T's state cost counted again (reference parity)
      S = __fadd_rn(acc, fam.cost(x));
      S_out[k] = S;
    }
    if (PASS2) {
      // ---- block softmin partial: the warp's 32 rollouts ---------------------
      const float beta_b = warp_nan_min(valid ? S : INFINITY);
      const bool all_inf = beta_b == INFINITY;
      const float ek = (valid && !all_inf) ? expf(-(S - beta_b) / lam_softmin) : 0.0f;
      const float eta_b = warp_sum(ek);
      e_s[lane] = ek;
      if (lane == 0) {
        part[0] = beta_b;
        part[1] = eta_b;
      }
    }
  }
  if (!PASS2) return;
  __syncthreads();
  // ---- ΔŨ_b[t, a] = Σ_j e_j ε_j[t, a]: slab row t·A + a, one warp per row -----
  const float ej = e_s[lane];
  for (int i = warp; i < TA; i += kSlabWarps) {
    const float v = warp_sum(ej * slab[(size_t)i * G + lane]);
    if (lane == 0) u_s[i] = v;  // U is spent: its buffer gathers the row sums
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TA; i += kSlabThreads) part[2 + i] = u_s[i];
}

NoiseParams make_noise(unsigned key0, unsigned key1, unsigned step, unsigned it, unsigned k0,
                       int K, int antithetic, float ou_beta, float ou_c) {
  NoiseParams np;
  np.key0 = key0;
  np.key1 = key1;
  np.step = step;
  np.it = it;
  np.k0 = k0;
  np.K = K;
  np.antithetic = antithetic;
  np.K_draw = antithetic ? K / 2 : K;
  np.ou_beta = ou_beta;
  np.ou_c = ou_c;
  return np;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 40 * 1024) return cudaSuccess;  // leaves room for static smem under 48 KB
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// K1's pointers and scalars, passed through the dispatch below unchanged.
struct SolveArgs {
  const float *x0, *U, *params, *goal;
  const long long *keys, *step_ptr;
  const float* eps_in;
  float *S, *partials;
  int R, T, A;
  float dt, lam_cost, lam_softmin;
  int width;  // rollouts per block: kBlock (per-rollout body) or kSlabRollouts (slab body)
};

template <class F, int A, bool INJ, bool PASS2>
cudaError_t launch_partials(const SolveArgs& a, const NoiseParams& np, cudaStream_t stream) {
  if (a.width == kSlabRollouts) {
    const dim3 grid((np.K + kSlabRollouts - 1) / kSlabRollouts, a.R);
    const size_t smem = slab_smem(a.T, A);
    cudaError_t err = set_smem(slab_partials_kernel<F, A, INJ, PASS2>, smem);
    if (err != cudaSuccess) return err;
    slab_partials_kernel<F, A, INJ, PASS2><<<grid, kSlabThreads, smem, stream>>>(
        a.x0, a.U, a.params, a.goal, a.keys, a.step_ptr, a.eps_in, a.S, a.partials, a.T, a.dt,
        a.lam_cost,
        a.lam_softmin, np);
    return cudaGetLastError();
  }
  if (a.width != kBlock) return cudaErrorInvalidValue;
  const dim3 grid((np.K + kBlock - 1) / kBlock, a.R);
  const size_t smem = (size_t)(PASS2 ? 1 + kWarps : 1) * a.T * A * sizeof(float);
  cudaError_t err = set_smem(solve_partials_kernel<F, A, INJ, PASS2>, smem);
  if (err != cudaSuccess) return err;
  solve_partials_kernel<F, A, INJ, PASS2><<<grid, kBlock, smem, stream>>>(
      a.x0, a.U, a.params, a.goal, a.keys, a.step_ptr, a.eps_in, a.S, a.partials, a.T, a.dt,
        a.lam_cost,
      a.lam_softmin, np);
  return cudaGetLastError();
}

template <class F, int A, bool PASS2>
cudaError_t launch_mode(const SolveArgs& a, const NoiseParams& np, cudaStream_t s) {
  return a.eps_in != nullptr ? launch_partials<F, A, true, PASS2>(a, np, s)
                             : launch_partials<F, A, false, PASS2>(a, np, s);
}

}  // namespace
