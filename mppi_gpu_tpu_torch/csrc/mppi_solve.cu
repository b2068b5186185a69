// Hopper (sm_90a) kernels of the MPPI solve, bound to Python with ctypes
// (mppi_gpu_tpu_torch/ops/_build.py, ops/fused_solve.py).
//
//   K1 solve_partials   rollout + cost + per-block softmin partial + ΔŨ
//   K2 softmin_combine  fold of the per-block partials into β, η, ΔU
//   K3 noise_dump       the ε stream K1 consumed, written as (T, K, A)
//
// K1 is a template over the fused family, the (dynamics, cost) pair it steps
// (ops/families.py): the point-mass LTI model with the quadratic cost, the
// pendulum with its swing-up cost, the cart-pole with its balance cost. A
// family is a struct below: its state is kS floats in registers, initialised
// from x0; `load` reads its parameters, `step` (x, u + ε) → x' and `cost`
// (x) → state cost. Everything else in K1 (noise, control cost, Kahan sum,
// partials) is shared, and K2 and K3 do not depend on the family.
//
// One thread per rollout k carries its state in registers through a
// sequential loop over the horizon. K1 and K2 take a fleet of R independent
// robots in one launch: grid axis y of K1 and grid axis x of K2 is the robot
// r, which reads its own x0, U, goal (LTI), noise key and (injected) ε and
// writes its own S, partials, β, η and ΔU; the family's parameters, dt, both
// λ, the counter words (step, it), antithetic and OU are shared. The
// single-robot solve is the R = 1 launch. The noise stream is Philox4x32-10
// keyed by the seed, counter (k, t, step, it), with Box-Muller normals; its
// plain torch twin is ops/philox.py and the words must match it bit for bit.
// The noise, state-update and cost arithmetic uses explicitly rounded
// operations (__fmul_rn/__fadd_rn/__fdiv_rn, never contracted into FMAs), in
// the plain version's order (the port's eager models and costs), so K3's dump
// reproduces K1's ε exactly and the replay of a dump through the injected-ε
// mode reproduces the Philox-mode solve. The families' trigonometry is full
// precision sinf/cosf; no fast-math flags.
//
// Rollouts past K (the idle threads of the last block) never enter β, η or
// ΔU. A block whose real rollouts all have S = +inf contributes η_b = 0 and
// ΔŨ_b = 0 (its weights are exactly 0 against any finite β); if every block
// is like that, K2's β is +inf and β − β_b = NaN reaches η and ΔU, so the
// action comes out NaN and the divergence guard fires, as on the eager path.
// A NaN S (a rollout whose state overflowed into inf − inf) makes its block's
// β_b NaN, and K2's β with it, as torch.min does on the eager path.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // threads = rollouts per K1/K3 block; ops/fused_solve.BLOCK
constexpr int kWarps = kBlock / 32;
constexpr int kCombineThreads = 256;
constexpr int kMaxRobots = 65535;  // gridDim.y of K1; ops/fused_solve.MAX_ROBOTS
constexpr int kCombineWarps = kCombineThreads / 32;
constexpr float kInv2p24 = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.28318530717958647692f;    // rounds to float(2π)

struct NoiseParams {
  unsigned key0, key1, step, it;  // Philox key and counter words 2, 3
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

// Rollout k's ε at step t: Philox words → Box-Muller normals → OU → σ →
// antithetic sign. `e` carries the unit-variance OU state across t; `w`
// returns the four Philox words of the draw.
template <int A>
__device__ __forceinline__ void next_eps(const NoiseParams& np, const float* sig, int kd,
                                         bool mirror, int t, float e[A], float eps[A],
                                         unsigned w[4]) {
  w[0] = (unsigned)kd;
  w[1] = (unsigned)t;
  w[2] = np.step;
  w[3] = np.it;
  philox4x32_10(w, np.key0, np.key1);
  float n[A];
#pragma unroll
  for (int p = 0; p < (A + 1) / 2; ++p) {
    const float u1 = __fmul_rn(__uint2float_rn(w[2 * p] >> 8), kInv2p24);
    const float u2 = __fmul_rn(__uint2float_rn(w[2 * p + 1] >> 8), kInv2p24);
    const float r = sqrtf(__fmul_rn(-2.0f, log1pf(-u1)));
    const float th = __fmul_rn(u2, kTwoPi);
    n[2 * p] = __fmul_rn(r, cosf(th));
    if (2 * p + 1 < A) n[2 * p + 1] = __fmul_rn(r, sinf(th));
  }
  const bool ou = np.ou_beta > 0.0f && t > 0;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    e[a] = ou ? __fadd_rn(__fmul_rn(np.ou_beta, e[a]), __fmul_rn(np.ou_c, n[a])) : n[a];
    const float s = __fmul_rn(sig[a], e[a]);
    eps[a] = mirror ? -s : s;
  }
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

// ---- families -------------------------------------------------------------
// Each reads its parameters from the family part of the packed vector (past
// σ and Σ⁻¹; layouts in ops/families.py) and steps in the order of the
// port's eager model and cost, whose float32 arithmetic it repeats.

enum FamilyId { kLtiFamily = 0, kPendulumFamily = 1, kCartPoleFamily = 2 };  // ops/families.py

// Point-mass double integrator per axis, quadratic cost towards robot r's
// goal (models/point_mass.py, ops/cost.QuadraticCost).
template <int A>
struct Lti {
  static constexpr int kS = 2 * A;
  static constexpr bool kGoal = true;
  float wq[A], wqd[A], gq[A], gqd[A], dt, hdt2;

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt_) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      wq[a] = fp[a];
      wqd[a] = fp[A + a];
      gq[a] = goal[a];
      gqd[a] = goal[A + a];
    }
    dt = dt_;
    hdt2 = 0.5f * dt_ * dt_;
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[A]) const {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      x[a] = __fadd_rn(__fadd_rn(x[a], __fmul_rn(dt, x[A + a])), __fmul_rn(hdt2, ue[a]));
      x[A + a] = __fadd_rn(x[A + a], __fmul_rn(dt, ue[a]));
    }
  }

  // Σ_j w_j (x_j − g_j)² over x = (q, qd)
  __device__ __forceinline__ float cost(const float x[kS]) const {
    float c = 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float d = __fsub_rn(x[a], gq[a]);
      c = __fadd_rn(c, __fmul_rn(__fmul_rn(d, wq[a]), d));
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float d = __fsub_rn(x[A + a], gqd[a]);
      c = __fadd_rn(c, __fmul_rn(__fmul_rn(d, wqd[a]), d));
    }
    return c;
  }
};

// Pendulum, x = (θ, θ̇), θ from upright: RK2 midpoint of
// θ̈ = (g/l) sin θ + u/(m l²) − b θ̇ (models/pendulum.py); swing-up cost
// w_angle (1 − cos θ) + w_vel θ̇² (ops/cost.PendulumSwingupCost).
struct Pendulum {
  static constexpr int kS = 2;
  static constexpr bool kGoal = false;
  float w_angle, w_vel, gl, ml2, b, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float*, float dt) {
    w_angle = fp[0];
    w_vel = fp[1];
    gl = fp[2];   // g / l
    ml2 = fp[3];  // m l², divided by as the model does
    b = fp[4];
    h = dt;
    hh = 0.5f * dt;
  }

  __device__ __forceinline__ float accel(float th, float thd, float u) const {
    return __fsub_rn(__fadd_rn(__fmul_rn(gl, sinf(th)), __fdiv_rn(u, ml2)), __fmul_rn(b, thd));
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[1]) const {
    const float th = x[0], thd = x[1];
    const float k1 = accel(th, thd, ue[0]);
    const float th_m = __fadd_rn(th, __fmul_rn(hh, thd));
    const float thd_m = __fadd_rn(thd, __fmul_rn(hh, k1));
    const float k2 = accel(th_m, thd_m, ue[0]);
    x[0] = __fadd_rn(th, __fmul_rn(h, thd_m));
    x[1] = __fadd_rn(thd, __fmul_rn(h, k2));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    return __fadd_rn(__fmul_rn(w_angle, __fsub_rn(1.0f, cosf(x[0]))),
                     __fmul_rn(w_vel, __fmul_rn(x[1], x[1])));
  }
};

// Cart-pole, x = (p, θ, ṗ, θ̇), θ from upright: RK2 midpoint of the
// frictionless cart-pole (models/cartpole.py), with its four divides;
// balance cost w0 p² + w1 (1 − cos θ) + w2 ṗ² + w3 θ̇²
// (ops/cost.CartPoleBalanceCost).
struct CartPole {
  static constexpr int kS = 4;
  static constexpr bool kGoal = false;
  float w0, w1, w2, w3, mpl, mp, total, l, g, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float*, float dt) {
    w0 = fp[0];
    w1 = fp[1];
    w2 = fp[2];
    w3 = fp[3];
    mpl = fp[4];    // m_p l
    mp = fp[5];     // m_p
    total = fp[6];  // m_c + m_p
    l = fp[7];
    g = fp[8];
    h = dt;
    hh = 0.5f * dt;
  }

  // (p̈, θ̈) at (θ, θ̇) under force u
  __device__ __forceinline__ void accel(float th, float thd, float u, float& pdd,
                                        float& thdd) const {
    const float s = sinf(th), c = cosf(th);
    const float a = __fdiv_rn(__fadd_rn(u, __fmul_rn(__fmul_rn(mpl, __fmul_rn(thd, thd)), s)), total);
    const float den = __fmul_rn(
        l, __fsub_rn(4.0f / 3.0f, __fdiv_rn(__fmul_rn(mp, __fmul_rn(c, c)), total)));
    thdd = __fdiv_rn(__fsub_rn(__fmul_rn(g, s), __fmul_rn(c, a)), den);
    pdd = __fsub_rn(a, __fdiv_rn(__fmul_rn(__fmul_rn(mpl, thdd), c), total));
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[1]) const {
    const float p = x[0], th = x[1], pd = x[2], thd = x[3];
    float pdd1, thdd1, pdd2, thdd2;
    accel(th, thd, ue[0], pdd1, thdd1);
    const float th_m = __fadd_rn(th, __fmul_rn(hh, thd));
    const float thd_m = __fadd_rn(thd, __fmul_rn(hh, thdd1));
    accel(th_m, thd_m, ue[0], pdd2, thdd2);
    const float pd_m = __fadd_rn(pd, __fmul_rn(hh, pdd1));
    x[0] = __fadd_rn(p, __fmul_rn(h, pd_m));
    x[1] = __fadd_rn(th, __fmul_rn(h, thd_m));
    x[2] = __fadd_rn(pd, __fmul_rn(h, pdd2));
    x[3] = __fadd_rn(thd, __fmul_rn(h, thdd2));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    float c = __fmul_rn(w0, __fmul_rn(x[0], x[0]));
    c = __fadd_rn(c, __fmul_rn(w1, __fsub_rn(1.0f, cosf(x[1]))));
    c = __fadd_rn(c, __fmul_rn(w2, __fmul_rn(x[2], x[2])));
    return __fadd_rn(c, __fmul_rn(w3, __fmul_rn(x[3], x[3])));
  }
};

// K1. Replaces the TPU solve kernels of mppi_gpu_tpu/ops/pallas_rollout.py:
// _onepass_solve_kernel (:2342), _planar_onepass_kernel (:2686) and
// _fused_solve_kernel (:2287), and their fleet forms
// _fleet_onepass_solve_kernel (:3121), _fleet_fused_solve_kernel (:2973) and
// _planar_fleet_onepass_kernel (:3078), whose grid (R, tiles) runs the same
// per-tile bodies robot after robot; for the families of
// _LTIQuadFamily (:490), _PendulumFamily (:614) and _CartPoleFamily (:700).
//
// What bounds it: arithmetic, not memory. Per rollout and step it does one
// Philox call (10 rounds of two 32-bit multiply-high), one or two Box-Muller
// pairs (log1p, sqrt, cos, sin) and the family's step and cost: ~10 flops for
// LTI; two sinf, one cosf and two divides for the pendulum; two sinf, three
// cosf and eight divides for the cart-pole. The only traffic is U and the
// parameters (read once into shared memory/registers), S (4 B per rollout)
// and one (2 + T·A)-float partial per block. In the injected-ε mode it
// instead streams 2·T·A·4 B per rollout.
//
// Design: the TPU kernels stage the tile's ε in VMEM for the ΔU pass; here a
// thread's ε for a whole horizon does not fit in registers and staging it in
// shared memory would cap the block at a few rollouts, so pass 2
// regenerates ε from the counter (Philox is stateless), which costs a second
// round of noise arithmetic and no memory; pass 2 needs no dynamics, so it is
// the same for every family. The cross-tile online softmin of the TPU
// kernel, which relies on the grid running in order, becomes an associative
// per-block partial (β_b, η_b, ΔŨ_b) folded by K2, the same combine the
// sharded path uses across devices. Σ_k e_k ε_k[t, a] is a warp shuffle
// reduction per (t, a) into shared memory, summed over the warps in a fixed
// order. The TPU kernels' trig carry (_sincos_small :455) is not used: it
// saves TPU transcendentals and holds only for small angle steps.
//
// Fleet: block (b, r) is block b of robot r; robots run side by side on the
// SMs, not in turn as on the TPU. All robot offsets are size_t: at R = 64,
// K = 10⁵ the partials alone are 30 M floats, and an injected (R, T, K, A) ε
// passes 2³¹ elements. `keys` holds every robot's (R,) int64 seed, whose low
// and high words are its Philox key; null means every robot uses
// np.key0/np.key1, which is how the single-robot solve runs without a seed
// tensor on the device. `params` is [σ (A), Σ⁻¹ (A), family part]; `goal`
// (R, kS) is read by families with kGoal only.
template <class F, int A, bool INJ>
__global__ void __launch_bounds__(kBlock) solve_partials_kernel(
    const float* __restrict__ x0, const float* __restrict__ U,
    const float* __restrict__ params, const float* __restrict__ goal,
    const long long* __restrict__ keys, const float* __restrict__ eps_in,
    float* __restrict__ S_out, float* __restrict__ partials, int T, float dt,
    float lam_cost, float lam_softmin, NoiseParams np) {
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
      float eps[A], ue[A];
      if (INJ) {
#pragma unroll
        for (int a = 0; a < A; ++a) eps[a] = eps_in[((size_t)t * np.K + k) * A + a];
      } else {
        next_eps<A>(np, sig, kd, mirror, t, e, eps, words);
      }
      // explicitly rounded, in the plain version's order (models/, ops/cost):
      // both modes of this kernel step bit-identical states and costs from
      // bit-identical ε
      float ctrl = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float u = u_s[t * A + a];
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
    // terminal cost: x_T's state cost counted again (reference parity)
    S = __fadd_rn(acc, fam.cost(x));
    S_out[k] = S;
  }

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

// K2. Replaces the cross-tile fold of the TPU one-pass kernels (single-robot
// and fleet), mppi_gpu_tpu/ops/pallas_rollout.py:_online_softmin_step (:1847)
// and the two-pass fleet kernel's _softmin_phase (:2257), which
// rescales a running (β, η, ΔŨ) tile by tile; it is the same associative
// combine the sharded path applies across devices
// (mppi_gpu_tpu/controller.py:488-500):
//   β = min_b β_b,  f_b = exp((β − β_b)/λ),  η = Σ f_b η_b,
//   ΔU = Σ f_b ΔŨ_b / η.
// What bounds it: reading a robot's nb·(2 + T·A) partial floats (1.9 MB at
// K = 10⁵, T = 200, A = 3) with one block; the ΔU loop reads them coalesced
// (thread i walks column i). One block per robot keeps the order of every
// sum fixed; block r folds robot r's nb partials into beta_eta[r] and ΔU[r].
__global__ void __launch_bounds__(kCombineThreads) softmin_combine_kernel(
    const float* __restrict__ partials, int nb, int TA, float lam,
    float* __restrict__ beta_eta, float* __restrict__ dU) {
  extern __shared__ float f_s[];  // (nb,) rescale factors f_b
  __shared__ float scratch[kCombineWarps];
  const size_t stride = 2 + (size_t)TA;
  const size_t r = blockIdx.x;
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
  for (int i = threadIdx.x; i < TA; i += kCombineThreads) {
    float s = 0.0f;
    for (int b = 0; b < nb; ++b) s += f_s[b] * partials[b * stride + 2 + i];
    dU[i] = s / eta;
  }
  if (threadIdx.x == 0) {
    beta_eta[0] = beta;
    beta_eta[1] = eta;
  }
}

// K3. Replaces mppi_gpu_tpu/ops/pallas_rollout.py:_noise_dump_kernel (:2140)
// and _planar_noise_dump_kernel (:2872): the ε stream the solve consumed,
// written to memory for the debug dump and the replay check.
// What bounds it: the T·K·A·4-byte store (plus 16 B per draw for the
// optional words); each thread walks its rollout's horizon, so a warp's
// stores for one t cover 32·A consecutive floats.
template <int A>
__global__ void __launch_bounds__(kBlock) noise_dump_kernel(
    const float* __restrict__ sigma, float* __restrict__ eps_out,
    unsigned* __restrict__ words_out, int T, NoiseParams np) {
  const int k = blockIdx.x * kBlock + threadIdx.x;
  if (k >= np.K) return;
  const bool mirror = np.antithetic && k >= np.K_draw;
  const int kd = mirror ? k - np.K_draw : k;
  float sig[A], e[A], eps[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    sig[a] = sigma[a];
    e[a] = 0.0f;
  }
  unsigned w[4];
  for (int t = 0; t < T; ++t) {
    next_eps<A>(np, sig, kd, mirror, t, e, eps, w);
#pragma unroll
    for (int a = 0; a < A; ++a) eps_out[((size_t)t * np.K + k) * A + a] = eps[a];
    if (words_out != nullptr && !mirror) {
#pragma unroll
      for (int i = 0; i < 4; ++i) words_out[((size_t)t * np.K_draw + kd) * 4 + i] = w[i];
    }
  }
}

NoiseParams make_noise(unsigned key0, unsigned key1, unsigned step, unsigned it, int K,
                       int antithetic, float ou_beta, float ou_c) {
  NoiseParams np;
  np.key0 = key0;
  np.key1 = key1;
  np.step = step;
  np.it = it;
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
  const long long* keys;
  const float* eps_in;
  float *S, *partials;
  int R, T;
  float dt, lam_cost, lam_softmin;
};

template <class F, int A, bool INJ>
cudaError_t launch_partials(const SolveArgs& a, const NoiseParams& np, cudaStream_t stream) {
  const dim3 grid((np.K + kBlock - 1) / kBlock, a.R);
  const size_t smem = (size_t)(1 + kWarps) * a.T * A * sizeof(float);
  cudaError_t err = set_smem(solve_partials_kernel<F, A, INJ>, smem);
  if (err != cudaSuccess) return err;
  solve_partials_kernel<F, A, INJ><<<grid, kBlock, smem, stream>>>(
      a.x0, a.U, a.params, a.goal, a.keys, a.eps_in, a.S, a.partials, a.T, a.dt, a.lam_cost,
      a.lam_softmin, np);
  return cudaGetLastError();
}

template <class F, int A>
cudaError_t launch_partials_mode(const SolveArgs& a, const NoiseParams& np, cudaStream_t s) {
  return a.eps_in != nullptr ? launch_partials<F, A, true>(a, np, s)
                             : launch_partials<F, A, false>(a, np, s);
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t as int: 0 on a launched kernel.

// family (FamilyId), x0 (R, S), U (R, T, A), params [σ (A), Σ⁻¹ (A), family
// part], goal (R, S) for LTI (else unused, may be null), keys (R,) int64 or
// null, eps_in (R, T, K, A) or null → S (R, K), partials (R, nb, 2 + T·A).
// S is 2A for LTI (A ≤ 4), 2 for the pendulum and 4 for the cart-pole (A = 1).
int mppi_solve_partials(int family, const float* x0, const float* U, const float* params,
                        const float* goal, const long long* keys, const float* eps_in, float* S,
                        float* partials, int R, int K, int T, int A, float dt, float lam_cost,
                        float lam_softmin, unsigned key0, unsigned key1, unsigned step,
                        unsigned it, int antithetic, float ou_beta, float ou_c, void* stream) {
  if (R < 1 || R > kMaxRobots) return (int)cudaErrorInvalidValue;
  const NoiseParams np = make_noise(key0, key1, step, it, K, antithetic, ou_beta, ou_c);
  const SolveArgs a{x0, U, params, goal, keys, eps_in, S, partials, R, T, dt, lam_cost,
                    lam_softmin};
  cudaStream_t s = (cudaStream_t)stream;
  switch (family) {
    case kLtiFamily:
      if (goal == nullptr) return (int)cudaErrorInvalidValue;
      switch (A) {
        case 1: return launch_partials_mode<Lti<1>, 1>(a, np, s);
        case 2: return launch_partials_mode<Lti<2>, 2>(a, np, s);
        case 3: return launch_partials_mode<Lti<3>, 3>(a, np, s);
        case 4: return launch_partials_mode<Lti<4>, 4>(a, np, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case kPendulumFamily:
      return A == 1 ? launch_partials_mode<Pendulum, 1>(a, np, s) : (int)cudaErrorInvalidValue;
    case kCartPoleFamily:
      return A == 1 ? launch_partials_mode<CartPole, 1>(a, np, s) : (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// partials (R, nb, 2 + TA) → beta_eta (R, 2), dU (R, TA).
int mppi_softmin_combine(const float* partials, int R, int nb, int TA, float lam,
                         float* beta_eta, float* dU, void* stream) {
  if (R < 1 || R > kMaxRobots) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)nb * sizeof(float);
  cudaError_t err = set_smem(softmin_combine_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  softmin_combine_kernel<<<R, kCombineThreads, smem, (cudaStream_t)stream>>>(
      partials, nb, TA, lam, beta_eta, dU);
  return (int)cudaGetLastError();
}

int mppi_noise_dump(const float* sigma, float* eps_out, unsigned* words_out, int K, int T,
                    int A, unsigned key0, unsigned key1, unsigned step, unsigned it,
                    int antithetic, float ou_beta, float ou_c, void* stream) {
  const NoiseParams np = make_noise(key0, key1, step, it, K, antithetic, ou_beta, ou_c);
  const int nb = (K + kBlock - 1) / kBlock;
  cudaStream_t s = (cudaStream_t)stream;
  switch (A) {
    case 1: noise_dump_kernel<1><<<nb, kBlock, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 2: noise_dump_kernel<2><<<nb, kBlock, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 3: noise_dump_kernel<3><<<nb, kBlock, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 4: noise_dump_kernel<4><<<nb, kBlock, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
