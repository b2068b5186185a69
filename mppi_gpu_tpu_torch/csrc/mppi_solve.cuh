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
//   rollout_smem                its dynamic shared memory
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
// floats per action of the slab of the per-rollout body's second pass: eight
// steps of a block whose every rollout weighs, each row of 128 slots padded
// to 136 (ops/fused_solve.DELTA_CELLS)
constexpr int kDeltaCells = 8 * (kBlock + 8);
constexpr int kSlabRollouts = 32;  // rollouts per block of K1's slab body; ops/fused_solve.SLAB_WIDTH
constexpr int kSlabWarps = 8;      // warp 0 rolls out, warps 1-7 draw
constexpr int kSlabThreads = 32 * kSlabWarps;  // ops/fused_solve.SLAB_THREADS
constexpr int kDrawWarps = kSlabWarps - 1;
constexpr int kChunk = kDrawWarps;  // horizon steps per ring slot: one per draw warp
constexpr int kRing = 4;  // least slots of the slab body's ring; ops/fused_solve.SLAB_RING
// floats per action of kRing slots, the slab of the slab body's second pass
constexpr int kRingCells = kRing * kChunk * kSlabRollouts;
// blocks per SM that the slab body's launch bounds hold registers for and
// its ring leaves shared memory for, so that the flagship's 313 blocks
// (K = 10⁴) fit in one wave on 132 SMs; ops/fused_solve.SLAB_MIN_BLOCKS
constexpr int kSlabMinBlocks = 3;
// states up to which a family's slab body takes kSlabMinBlocks' registers
// (up to 80 a thread); a larger state (the 3-D quadrotor's 13, whose step
// spills at 80) keeps 2 blocks' (up to 128); ops/fused_solve.SLAB_LEAN_STATE
constexpr int kSlabLeanState = 8;
constexpr int kSmSmem = 233472;    // shared memory of one Hopper SM
constexpr int kSmBlockSmem = 1024;  // of it, the runtime's own per block
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
// it instead streams T·A·4 B per rollout (again for each rollout that
// weighs). Both bodies draw the noise of every rollout that weighs twice: its
// second draw costs what pass 1's draw costs (~250 instructions per step at
// A = 3, Philox and two Box-Muller pairs), more than the step, cost and
// reduction of the LTI family together; a rollout whose weight e_k is 0 is
// not drawn again. Tensor cores serve neither body's reduction: it is a
// matrix-vector product (no reuse to feed them), and the replay checks need
// exact float32 products.
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
//   fills the card when R·K is large. Pass 1: one thread per rollout rolls
//   out, and the block's softmin gives each rollout its weight e_k. Pass 2
//   regenerates ε from the counter (Philox is stateless; a rollout's ε for a
//   whole horizon fits neither its thread's registers nor, at 2048 rollouts
//   per SM, shared memory) for the n rollouts of the block that weigh
//   (e_k ≠ 0; the others add exact zeros: in chip_smoke.py's K = 10⁵, T = 200
//   problems at the configs' λ, 94-99 % of the weights underflow to 0),
//   packed in rollout order into n slots; a block where none weighs writes
//   ΔŨ_b = 0 and draws nothing. It takes the horizon in chunks, eight steps
//   when every rollout weighs, more for fewer slots: (i) the chunk's cells
//   (step, slot) are drawn over all the block's threads, two Philox chains in
//   flight per lane (injected ε: copied), shaped with shape_eps's rounded
//   operations and weighed, e_k·ε, into a shared-memory slab (steps, A,
//   slots). When every rollout weighs, thread j draws its own rollout's steps
//   in order, so it also carries its OU state; under OU with fewer slots (ii)
//   the thread of slot i shapes its normals in t order after the draws, the
//   OU state carried across chunks in its registers. (iii) Each row (t, a) is
//   summed over its slots by G lanes (up to 16 slots each, in two running
//   sums, then a shuffle tree; rows padded so one warp's rows start on
//   different banks), in one order that both modes share, straight into the
//   partial row. No atomics: a run repeats bit for bit, and the injected-ε
//   solve on K3's dump equals the Philox one. The slab is 4.25 KB per action
//   whatever T, so apart from U shared memory does not grow with T, and at
//   T = 200 no instance has fewer blocks per SM for its shared memory than
//   for its registers. The design replaced a second walk of each rollout's
//   horizon by its own thread, one Philox chain in flight and A warp_sums per
//   step into a (warps, T, A) buffer; with every rollout weighing it is about
//   as fast, since the draws, not the reduction, hold that pass back (pass 2
//   runs in pass 1's grid, ~6 blocks of 4 warps per SM at K = 10⁵).
// * The slab body (slab_partials_kernel, 32 rollouts per block) is for the
//   main path's K, where 128-rollout blocks leave most SMs empty and one
//   warp per SM sub-partition runs the serial chain of Philox, Box-Muller,
//   step, cost and Kahan sum with nothing to hide its latency. The draw of
//   (k, t) depends on nothing before it, so seven draw warps fill a ring of
//   shared-memory chunks with the block's normals ahead of the rollout warp,
//   in parallel over t, and only what is sequential in t stays in the
//   rollout warp: the OU recursion, σ and the mirror (shape_eps, in
//   next_eps's order of rounded operations, so S is the per-rollout body's
//   bit for bit), the step, the cost and the Kahan sum. Each slot of the
//   ring (a chunk of seven steps) has a full mbarrier, on which the seven
//   draw warps arrive, and an empty one, on which the rollout warp arrives
//   once it has read the chunk (and, in K1, written its ε back); a draw
//   warp waits for its slot to be empty. The ring holds as many chunks as a
//   third of an SM's shared memory allows (slab_ring: 27 of the flagship's
//   29, every chunk of the configs' shorter horizons), so the draw warps
//   run far ahead, their work done early and the rollout warp's chain left
//   alone after it, while three blocks fit an SM: the flagship's 313 blocks
//   (K = 10⁴) run in one wave on 132 SMs. ΔŨ_b is the per-rollout body's
//   second pass at 32 slots over all eight warps, in its order: the rows of
//   the chunks still in the ring summed from their ε there, those before
//   them with ε drawn again for the rollouts that weigh (weigh_chunks, the
//   ring its slab); at least one rollout of a block weighs, its least-cost
//   one (e = 1). The whole horizon's ε, 76.8 KB at T = 200, A = 3, would
//   leave room for two blocks per SM: the flagship in two waves of the
//   200-step chain. Past about a full card of per-rollout blocks, 96
//   rollout threads per SM cannot hide the family's step latency and the
//   per-rollout body is faster. In the injected-ε mode
//   the draw warps fill the ring with coalesced 4-byte cp.async copies of
//   each step's contiguous 32·A floats.
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
  float* part = partials + (r * gridDim.x + blockIdx.x) * (2 + (size_t)TA);
  if (threadIdx.x == 0) {
    part[0] = beta_b;
    part[1] = eta_b;
  }

  // ---- pass 2: ΔŨ_b[t, a] = Σ_k e_k ε_k[t, a] over the rollouts that weigh --
  // (weigh_slots.cuh, weigh_chunks.cuh: the slab body runs the same text)
  float* e_s = u_s + TA;                                     // (kBlock,) slot weights
  int* slot = reinterpret_cast<int*>(e_s + kBlock);          // (kBlock,) slot draws
  int* counts = slot + kBlock;                               // (kWarps,) per warp
  float* cells = reinterpret_cast<float*>(counts + kWarps);  // (steps, A, ld)
  constexpr int kWeighThreads = kBlock, kWeighAll = kBlock, kWeighCells = kDeltaCells;
  const int t_end = T;
#include "weigh_slots.cuh"
#include "weigh_chunks.cuh"
}

// Dynamic shared memory of the per-rollout body (ops/fused_solve.rollout_bytes):
// U; K1 also the slot weights and draws, the per-warp counts and the slab of
// kDeltaCells floats per action.
size_t rollout_smem(int T, int A, bool pass2) {
  return sizeof(float) * ((size_t)T * A + (pass2 ? 2 * kBlock + kWarps + kDeltaCells * A : 0));
}

// Slots of the slab body's ring at T, A (ops/fused_solve.slab_ring): every
// chunk of the horizon where the shared memory of kSlabMinBlocks blocks per
// SM holds them all, else as many as it holds; at least kRing.
__host__ __device__ inline int slab_ring(int T, int A) {
  const int chunks = (T + kChunk - 1) / kChunk;
  const int room = kSmSmem / kSlabMinBlocks - kSmBlockSmem -
                   4 * (T * A + 3 * kSlabRollouts + kSlabWarps);
  const int fit = room > 0 ? room / (16 + 4 * kChunk * A * kSlabRollouts) : 0;
  const int slots = chunks < fit ? chunks : fit;
  return slots > kRing ? slots : kRing;
}

// Dynamic shared memory of the slab body (ops/fused_solve.slab_bytes): a full
// and an empty mbarrier per slot of the ring, U, the second pass's slot
// weights, draws and places and its count per warp, and the ring of chunks
// of normals.
size_t slab_smem(int T, int A) {
  const size_t ring = slab_ring(T, A);
  return 16 * ring + sizeof(float) * ((size_t)T * A + 3 * kSlabRollouts + kSlabWarps +
                                      ring * kChunk * A * kSlabRollouts);
}

// Blocks per SM that the slab body's launch bounds hold registers for, by
// the family's state (kSlabLeanState).
template <class F>
constexpr int slab_min_blocks() {
  return F::kS <= kSlabLeanState ? kSlabMinBlocks : 2;
}

// K1's and K4's slab body (see K1's note above): block (b, r) rolls out
// robot r's rollouts 32·b .. 32·b + 31, lane j of every warp standing for
// rollout 32·b + j. Warp 0 rolls out, warps 1-7 draw. The horizon runs
// through a ring of `ring` slots (slab_ring), a chunk of kChunk = 7 steps
// each: for chunk c, the draw warps wait until slot c mod ring is empty
// (its chunk c − ring consumed), draw (or, injected, copy) step c·7 + w − 1
// into it, (kChunk, A, 32) floats at (s·A + a)·32 + j, and arrive on the
// slot's full mbarrier; warp 0 waits for it, shapes ε (K1: and writes it
// back), steps the family, and arrives on the slot's empty mbarrier. Lanes
// past K draw nothing, hold ε = 0 and never enter β, η or ΔŨ. K1's second
// pass then sums the rows of the last `ring` chunks, still in the ring,
// from their ε there, and draws ε again for the steps before them
// (weigh_chunks, the ring its slab), in one order.
template <class F, int A, bool INJ, bool PASS2>
__global__ void __launch_bounds__(kSlabThreads, slab_min_blocks<F>()) slab_partials_kernel(
    const float* __restrict__ x0, const float* __restrict__ U,
    const float* __restrict__ params, const float* __restrict__ goal,
    const long long* __restrict__ keys, const long long* __restrict__ step_ptr,
    const float* __restrict__ eps_in, float* __restrict__ S_out, float* __restrict__ partials,
    int T, float dt, float lam_cost, float lam_softmin, NoiseParams np) {
  constexpr int S_DIM = F::kS;
  constexpr int W = kSlabRollouts;
  extern __shared__ __align__(16) unsigned long long slab_raw[];
  const int TA = T * A;
  const int chunks = (T + kChunk - 1) / kChunk;
  const int ring_slots = slab_ring(T, A);
  unsigned long long* full = slab_raw;                   // (ring_slots,) slot drawn
  unsigned long long* empty = full + ring_slots;         // (ring_slots,) slot consumed
  float* u_s = reinterpret_cast<float*>(empty + ring_slots);  // (T, A) nominal sequence
  float* e_s = u_s + TA;                                 // (W,) second pass: slot weights
  int* slot = reinterpret_cast<int*>(e_s + W);           // (W,) slot draws
  int* pos = slot + W;                                   // (W,) slot places j
  int* counts = pos + W;                                 // (kSlabWarps,) per warp
  float* ring = reinterpret_cast<float*>(counts + kSlabWarps);  // (ring_slots, kChunk, A, W)
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
  for (int i = threadIdx.x; i < ring_slots; i += kSlabThreads) {
    mbar_init(full + i, kDrawWarps);
    mbar_init(empty + i, 1);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = blockIdx.x * W;
  const int k = kb + lane;
  const bool valid = k < np.K;
  const bool mirror = np.antithetic && k >= np.K_draw;
  const int kd = mirror ? k - np.K_draw : k;
  float* part = PASS2 ? partials + (r * gridDim.x + blockIdx.x) * (2 + (size_t)TA) : nullptr;
  float sig[A], e[A];  // σ; the OU state (warp 0's rollout, then the second pass's slot)
#pragma unroll
  for (int a = 0; a < A; ++a) {
    sig[a] = params[a];
    e[a] = 0.0f;
  }
  float ek = 0.0f;  // warp 0: the rollout's softmin weight

  if (warp > 0) {
    // ---- draw warps: step c·7 + warp − 1 of chunk c into slot c mod ring ----
    for (int c = 0, s = 0, lap = 0; c < chunks; ++c) {
      mbar_wait(empty + s, (lap & 1) ^ 1);  // free: never filled, or consumed
      const int t = c * kChunk + warp - 1;
      if (t < T) {
        float* row = ring + (size_t)(s * kChunk + warp - 1) * A * W;
        if (INJ) {
          // step t's W·A floats are contiguous in eps_in (rollout-major); the
          // ring holds them action-major
          const float* src = eps_in + ((size_t)t * np.K + kb) * A;
          for (int i = lane; i < W * A; i += 32) {
            const int j = i / A, a = i - j * A;
            if (kb + j < np.K) {
              cp_async4(row + a * W + j, src + i);
            } else {
              row[a * W + j] = 0.0f;
            }
          }
          cp_async_wait_all();
        } else {
          float n[A];
          unsigned w[4];
          if (valid) draw_normals<A>(np, kd, t, n, w);
#pragma unroll
          for (int a = 0; a < A; ++a) row[a * W + lane] = valid ? n[a] : 0.0f;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full + s);
      if (++s == ring_slots) s = 0, ++lap;
    }
  } else {
    // ---- rollout warp: shape ε, step, cost, chunk by chunk ---------------------
    float lis[A], x[S_DIM];
#pragma unroll
    for (int a = 0; a < A; ++a) lis[a] = params[A + a];
    F fam;
    fam.load(params + 2 * A, goal, dt);
#pragma unroll
    for (int i = 0; i < S_DIM; ++i) x[i] = x0[i];
    float acc = 0.0f, comp = 0.0f;  // Kahan-compensated Σ_t step cost
    for (int c = 0, s = 0, lap = 0; c < chunks; ++c) {
      mbar_wait(full + s, lap & 1);
      if (valid) {
        const int t_end = min(T, (c + 1) * kChunk);
        float* cell = ring + (size_t)s * kChunk * A * W + lane;
        float next[A];  // the next step's normals (or injected ε), loaded a step
                        // ahead: no shared-memory load sits on the step's chain
#pragma unroll
        for (int a = 0; a < A; ++a) next[a] = cell[a * W];
        // not unrolled: a family's step inlined seven times would overflow the
        // instruction cache (the arm's twelve sinf/cosf calls per step)
#pragma unroll 1
        for (int t = c * kChunk; t < t_end; ++t, cell += A * W) {
          float n[A], eps[A];
#pragma unroll
          for (int a = 0; a < A; ++a) {
            n[a] = next[a];
            if (t + 1 < t_end) next[a] = cell[(A + a) * W];
          }
          if (INJ) {
#pragma unroll
            for (int a = 0; a < A; ++a) eps[a] = n[a];
          } else {
            shape_eps<A>(np, sig, mirror, t, n, e, eps);
            if (PASS2) {
#pragma unroll
              for (int a = 0; a < A; ++a) cell[a * W] = eps[a];
            }
          }
          rollout_step<F, A>(fam, x, u_s + t * A, lis, eps, lam_cost, acc, comp);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);  // read, and (K1) ε written back
      if (++s == ring_slots) s = 0, ++lap;
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
      ek = (valid && !all_inf) ? expf(-(S - beta_b) / lam_softmin) : 0.0f;
      const float eta_b = warp_sum(ek);
      if (lane == 0) {
        part[0] = beta_b;
        part[1] = eta_b;
      }
    }
  }
  if (!PASS2) return;
  {
    // ---- ΔŨ_b over the rollouts that weigh: the per-rollout body's second
    // pass at 32 slots, every warp (warp 0's lanes hold the rollouts; its
    // first barrier passes once every warp is done with the ring)
    constexpr int kWeighThreads = kSlabThreads, kWeighAll = 0, kWeighCells = kRingCells;
    float* cells = ring;
#include "weigh_slots.cuh"
    if (threadIdx.x < n) {  // slot i's place j in the block, from its draw
      const int d = slot[threadIdx.x];
      pos[threadIdx.x] = (INJ ? d : d < 0 ? ~d + np.K_draw : d) - kb;
    }
    __syncthreads();
    // the steps from t_ring on are still in the ring, chunk c in slot c mod
    // ring: each row (t, a) of them summed as weigh_chunks.cuh's (iii) sums
    // a row of its slab, the products e·ε formed as it forms them
    const int t_ring = max(0, chunks - ring_slots) * kChunk;
    int lg = 0;
    while ((16 << lg) < n) ++lg;
    const int G = 1 << lg;  // a row's lanes
    const int rows = (T - t_ring) * A;
    for (int r0 = warp << (5 - lg); r0 < rows; r0 += kSlabWarps << (5 - lg)) {
      const int row = r0 + (lane >> lg);
      float sum = 0.0f;
      if (row < rows) {
        const int t = t_ring + row / A, a = row - (row / A) * A;
        const int at = (t / kChunk) % ring_slots * kChunk + t % kChunk;  // its row in the ring
        const float* c = ring + ((size_t)at * A + a) * W;
        float odd = 0.0f;
        int i = lane & (G - 1);
        for (; i + G < n; i += 2 * G) {
          sum += __fmul_rn(e_s[i], c[pos[i]]);
          odd += __fmul_rn(e_s[i + G], c[pos[i + G]]);
        }
        if (i < n) sum += __fmul_rn(e_s[i], c[pos[i]]);
        sum += odd;
      }
      for (int o = G >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if ((lane & (G - 1)) == 0 && row < rows) part[2 + t_ring * A + row] = sum;
    }
    if (t_ring == 0) return;
    __syncthreads();  // the ring is free: the steps before t_ring are drawn again into it
    const int t_end = t_ring;
    {
#include "weigh_chunks.cuh"
    }
  }
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
  // null: launch. Else nothing is launched, and (2,) ints receive the blocks
  // of the instance a launch would run that an SM holds, and the SMs of the
  // current device
  int* resident;
};

// `kernel`'s blocks per SM at `threads` threads and `smem` bytes of dynamic
// shared memory, and the current device's SMs, into out[0], out[1].
template <typename Kernel>
cudaError_t residency(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(out + 1, cudaDevAttrMultiProcessorCount, device);
}

template <class F, int A, bool INJ, bool PASS2>
cudaError_t launch_partials(const SolveArgs& a, const NoiseParams& np, cudaStream_t stream) {
  if (a.width == kSlabRollouts) {
    const dim3 grid((np.K + kSlabRollouts - 1) / kSlabRollouts, a.R);
    const size_t smem = slab_smem(a.T, A);
    if (a.resident != nullptr)
      return residency(slab_partials_kernel<F, A, INJ, PASS2>, kSlabThreads, smem, a.resident);
    cudaError_t err = set_smem(slab_partials_kernel<F, A, INJ, PASS2>, smem);
    if (err != cudaSuccess) return err;
    slab_partials_kernel<F, A, INJ, PASS2><<<grid, kSlabThreads, smem, stream>>>(
        a.x0, a.U, a.params, a.goal, a.keys, a.step_ptr, a.eps_in, a.S, a.partials, a.T, a.dt,
        a.lam_cost, a.lam_softmin, np);
    return cudaGetLastError();
  }
  if (a.width != kBlock) return cudaErrorInvalidValue;
  const dim3 grid((np.K + kBlock - 1) / kBlock, a.R);
  const size_t smem = rollout_smem(a.T, A, PASS2);
  if (a.resident != nullptr)
    return residency(solve_partials_kernel<F, A, INJ, PASS2>, kBlock, smem, a.resident);
  cudaError_t err = set_smem(solve_partials_kernel<F, A, INJ, PASS2>, smem);
  if (err != cudaSuccess) return err;
  solve_partials_kernel<F, A, INJ, PASS2><<<grid, kBlock, smem, stream>>>(
      a.x0, a.U, a.params, a.goal, a.keys, a.step_ptr, a.eps_in, a.S, a.partials, a.T, a.dt,
      a.lam_cost, a.lam_softmin, np);
  return cudaGetLastError();
}

template <class F, int A, bool PASS2>
cudaError_t launch_mode(const SolveArgs& a, const NoiseParams& np, cudaStream_t s) {
  return a.eps_in != nullptr ? launch_partials<F, A, true, PASS2>(a, np, s)
                             : launch_partials<F, A, false, PASS2>(a, np, s);
}

}  // namespace
