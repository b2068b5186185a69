// Hopper (sm_90a) kernels of the MPPI solve, bound to Python with ctypes
// (mppi_gpu_tpu_torch/ops/_build.py, ops/fused_solve.py).
//
//   K1 solve_partials   rollout + cost + per-block softmin partial + ΔŨ
//   K2 softmin_combine  fold of the per-block partials into β, η, ΔU
//   K3 noise_dump       the ε stream K1 consumed, written as (T, K, A)
//   K4 rollout_costs    K1's pass 1 alone: the costs-only sweep → S
//   K5 weighted_update  per-block Σ_k w_k ε_k for given weights w, ε regenerated
//
// K1 is a template over the fused family, the (dynamics, cost) pair it steps
// (ops/families.py): the point-mass LTI model with the quadratic cost and
// with the obstacle cost, the pendulum with its swing-up cost, the cart-pole
// with its balance cost, the unicycle with its waypoint cost, the planar and
// the 3-D quadrotor with their hover costs and the two-link arm with its
// reaching cost. A family is a struct below:
// its state is kS floats in registers, initialised from x0; `load` reads its
// parameters (and robot r's goal), `step` (x, u + ε) → x' and `cost` (x) →
// state cost. Everything else in K1 (noise, control cost, Kahan sum,
// partials) is shared, and K2 and K3 do not depend on the family. K4 is K1's
// template with its second flag off.
//
// One thread per rollout k carries its state in registers through a
// sequential loop over the horizon. K1 and K4 have two bodies that compute
// the same S bit for bit: the per-rollout body (128 rollouts per block, ε
// drawn in the rollout's own loop) and the slab body (32 rollouts per block,
// ε drawn in parallel over the horizon into shared memory); the wrapper
// picks one by the width it passes (ops/fused_solve.block_width). K1 and K2
// take a fleet of R independent robots in one launch: grid axis y of K1 and
// K2 is the robot r, which reads its own x0, U, goal (LTI), noise key and
// (injected) ε and
// writes its own S, partials, β, η and ΔU; the family's parameters, dt, both
// λ, the counter words (step, it), antithetic and OU are shared. The
// single-robot solve is the R = 1 launch. The noise stream is Philox4x32-10
// keyed by the seed, counter (k0 + k, t, step, it), with Box-Muller normals;
// its plain torch twin is ops/philox.py and the words must match it bit for
// bit. The draw offset k0 is 0 on one GPU; a rank of the sharded solve draws
// its rollouts at its own offset (parallel/sharded.py), so the ranks together
// draw exactly the single-GPU stream.
// The noise, state-update and cost arithmetic uses explicitly rounded
// operations (__fmul_rn/__fadd_rn/__fdiv_rn, never contracted into FMAs), in
// the plain version's order (the port's eager models and costs), so K3's dump
// reproduces K1's ε exactly and the replay of a dump through the injected-ε
// mode reproduces the Philox-mode solve. The families' trigonometry is full
// precision sinf/cosf; no fast-math flags. The unicycle's cost and the 3-D
// quadrotor's quaternion renormalisation take rsqrtf, which is what torch's
// CUDA rsqrt computes (chip_smoke.py phase 13 checks torch.rsqrt on the card
// against 1/sqrt and K1's S against the plain one).
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

// ---- families -------------------------------------------------------------
// Each reads its parameters from the family part of the packed vector (past
// σ and Σ⁻¹; layouts in ops/families.py) and steps in the order of the
// port's eager model and cost, whose float32 arithmetic it repeats.

enum FamilyId {  // ops/families.py
  kLtiFamily = 0,
  kPendulumFamily = 1,
  kCartPoleFamily = 2,
  kUnicycleFamily = 3,
  kQuadrotorFamily = 4,
  kArmFamily = 5,
  kLtiObstacleFamily = 6,
  kQuadrotor3DFamily = 7,
};

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

// Unicycle, x = (px, py, θ), u = (v, ω): RK2 midpoint, the heading advanced
// half a step first (models/unicycle.py); waypoint cost
// w_pos d² + w_head (1 − (d·(cos θ, sin θ))/√(d² + 1e-3)) towards robot r's
// goal[0:2] (ops/cost.UnicycleWaypointCost).
struct Unicycle {
  static constexpr int kS = 3;
  static constexpr bool kGoal = true;
  float w_pos, w_head, gx, gy, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt) {
    w_pos = fp[0];
    w_head = fp[1];
    gx = goal[0];
    gy = goal[1];
    h = dt;
    hh = 0.5f * dt;
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[2]) const {
    const float th = x[2], hv = __fmul_rn(h, ue[0]);
    const float th_m = __fadd_rn(th, __fmul_rn(hh, ue[1]));
    x[0] = __fadd_rn(x[0], __fmul_rn(hv, cosf(th_m)));
    x[1] = __fadd_rn(x[1], __fmul_rn(hv, sinf(th_m)));
    x[2] = __fadd_rn(th, __fmul_rn(h, ue[1]));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    const float dx = __fsub_rn(gx, x[0]), dy = __fsub_rn(gy, x[1]);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float dot = __fadd_rn(__fmul_rn(dx, cosf(x[2])), __fmul_rn(dy, sinf(x[2])));
    const float align = __fmul_rn(dot, rsqrtf(__fadd_rn(d2, 1e-3f)));
    return __fadd_rn(__fmul_rn(w_pos, d2), __fmul_rn(w_head, __fsub_rn(1.0f, align)));
  }
};

// Planar quadrotor, x = (px, pz, θ, vx, vz, ω), u = (F, D) in mixer space:
// RK2 midpoint of ẍ = F sin θ / m, z̈ = F cos θ / m − g, θ̈ = r D / I with
// the model's divides (models/quadrotor.py); hover cost, quadratic on the
// position towards robot r's goal[0:2] and on the velocities, 1 − cos θ on
// the tilt (ops/cost.QuadrotorHoverCost).
struct Quadrotor {
  static constexpr int kS = 6;
  static constexpr bool kGoal = true;
  float w[6], m, inertia, r, g, gx, gz, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt) {
#pragma unroll
    for (int i = 0; i < 6; ++i) w[i] = fp[i];
    m = fp[6];
    inertia = fp[7];
    r = fp[8];
    g = fp[9];
    gx = goal[0];
    gz = goal[1];
    h = dt;
    hh = 0.5f * dt;
  }

  // (ẍ, z̈) at tilt th under collective thrust F
  __device__ __forceinline__ void accel(float th, float F, float& ax, float& az) const {
    ax = __fdiv_rn(__fmul_rn(F, sinf(th)), m);
    az = __fsub_rn(__fdiv_rn(__fmul_rn(F, cosf(th)), m), g);
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[2]) const {
    const float th = x[2], om = x[5];
    const float al = __fdiv_rn(__fmul_rn(r, ue[1]), inertia);  // the same at both stages
    float ax1, az1, ax2, az2;
    accel(th, ue[0], ax1, az1);
    accel(__fadd_rn(th, __fmul_rn(hh, om)), ue[0], ax2, az2);
    const float vx_m = __fadd_rn(x[3], __fmul_rn(hh, ax1));
    const float vz_m = __fadd_rn(x[4], __fmul_rn(hh, az1));
    const float om_m = __fadd_rn(om, __fmul_rn(hh, al));
    x[0] = __fadd_rn(x[0], __fmul_rn(h, vx_m));
    x[1] = __fadd_rn(x[1], __fmul_rn(h, vz_m));
    x[2] = __fadd_rn(th, __fmul_rn(h, om_m));
    x[3] = __fadd_rn(x[3], __fmul_rn(h, ax2));
    x[4] = __fadd_rn(x[4], __fmul_rn(h, az2));
    x[5] = __fadd_rn(om, __fmul_rn(h, al));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    const float dx = __fsub_rn(x[0], gx), dz = __fsub_rn(x[1], gz);
    float c = __fmul_rn(__fmul_rn(w[0], dx), dx);
    c = __fadd_rn(c, __fmul_rn(__fmul_rn(w[1], dz), dz));
    c = __fadd_rn(c, __fmul_rn(w[2], __fsub_rn(1.0f, cosf(x[2]))));
    c = __fadd_rn(c, __fmul_rn(w[3], __fmul_rn(x[3], x[3])));
    c = __fadd_rn(c, __fmul_rn(w[4], __fmul_rn(x[4], x[4])));
    return __fadd_rn(c, __fmul_rn(w[5], __fmul_rn(x[5], x[5])));
  }
};

// Two-link arm, x = (q1, q2, q̇1, q̇2), u = (τ1, τ2): RK2 midpoint of the
// manipulator equations with the closed-form inverse of the 2×2 mass matrix
// (one divide for 1/det, as the model), the joint rates saturated at
// ±max_rate after each stage (models/arm.py); reaching cost, the squared
// distance of the end effector (the cost's link lengths) to robot r's
// goal[0:2] plus w_vel (q̇1² + q̇2²) (ops/cost.ArmReachCost).
struct Arm {
  static constexpr int kS = 4;
  static constexpr bool kGoal = true;
  float w_pos, w_vel, A_, B_, D_, G1, G2, damp, maxr, l1, l2, tx, ty, twoB, h, hh;

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt) {
    w_pos = fp[0];
    w_vel = fp[1];
    A_ = fp[2];
    B_ = fp[3];
    D_ = fp[4];
    G1 = fp[5];
    G2 = fp[6];
    damp = fp[7];
    maxr = fp[8];
    l1 = fp[9];
    l2 = fp[10];
    tx = goal[0];
    ty = goal[1];
    twoB = 2.0f * B_;
    h = dt;
    hh = 0.5f * dt;
  }

  // (q̈1, q̈2) at (q, q̇) under torques (t1, t2)
  __device__ __forceinline__ void accel(float q1, float q2, float qd1, float qd2, float t1,
                                        float t2, float& qdd1, float& qdd2) const {
    const float s2 = sinf(q2), c2 = cosf(q2), c1 = cosf(q1), c12 = cosf(__fadd_rn(q1, q2));
    const float d11 = __fadd_rn(A_, __fmul_rn(twoB, c2));
    const float d12 = __fadd_rn(D_, __fmul_rn(B_, c2));
    const float hs = __fmul_rn(B_, s2);
    const float cq = __fadd_rn(__fmul_rn(__fmul_rn(2.0f, qd1), qd2), __fmul_rn(qd2, qd2));
    const float r1 = __fsub_rn(
        __fsub_rn(__fadd_rn(t1, __fmul_rn(hs, cq)),
                  __fadd_rn(__fmul_rn(G1, c1), __fmul_rn(G2, c12))),
        __fmul_rn(damp, qd1));
    const float r2 = __fsub_rn(
        __fsub_rn(__fsub_rn(t2, __fmul_rn(__fmul_rn(hs, qd1), qd1)), __fmul_rn(G2, c12)),
        __fmul_rn(damp, qd2));
    const float inv_det = __fdiv_rn(1.0f, __fsub_rn(__fmul_rn(d11, D_), __fmul_rn(d12, d12)));
    qdd1 = __fmul_rn(__fsub_rn(__fmul_rn(D_, r1), __fmul_rn(d12, r2)), inv_det);
    qdd2 = __fmul_rn(__fsub_rn(__fmul_rn(d11, r2), __fmul_rn(d12, r1)), inv_det);
  }

  // clamp to ±max_rate; NaN stays NaN, as torch.clamp keeps it (fminf and
  // fmaxf would drop it and leave a diverged rollout finite)
  __device__ __forceinline__ float sat(float v) const {
    return v != v ? v : fminf(fmaxf(v, -maxr), maxr);
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[2]) const {
    const float q1 = x[0], q2 = x[1], qd1 = x[2], qd2 = x[3];
    float a1, a2;
    accel(q1, q2, qd1, qd2, ue[0], ue[1], a1, a2);
    const float m0 = __fadd_rn(q1, __fmul_rn(hh, qd1)), m1 = __fadd_rn(q2, __fmul_rn(hh, qd2));
    const float m2 = sat(__fadd_rn(qd1, __fmul_rn(hh, a1)));
    const float m3 = sat(__fadd_rn(qd2, __fmul_rn(hh, a2)));
    accel(m0, m1, m2, m3, ue[0], ue[1], a1, a2);
    x[0] = __fadd_rn(q1, __fmul_rn(h, m2));
    x[1] = __fadd_rn(q2, __fmul_rn(h, m3));
    x[2] = sat(__fadd_rn(qd1, __fmul_rn(h, a1)));
    x[3] = sat(__fadd_rn(qd2, __fmul_rn(h, a2)));
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    const float q12 = __fadd_rn(x[0], x[1]);
    const float ex = __fadd_rn(__fmul_rn(l1, cosf(x[0])), __fmul_rn(l2, cosf(q12)));
    const float ey = __fadd_rn(__fmul_rn(l1, sinf(x[0])), __fmul_rn(l2, sinf(q12)));
    const float dx = __fsub_rn(ex, tx), dy = __fsub_rn(ey, ty);
    const float vel = __fadd_rn(__fmul_rn(x[2], x[2]), __fmul_rn(x[3], x[3]));
    return __fadd_rn(__fmul_rn(w_pos, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))),
                     __fmul_rn(w_vel, vel));
  }
};

// Point mass with the obstacle cost: Lti<A>'s step and quadratic cost plus
// `penalty` for each spherical obstacle the position q = x[0:A] lies inside
// (ops/cost.ObstacleCost): penalty · #{m : Σ_a (q_a − c_ma)² < r_m²}, the
// squared distance summed left to right as the eager cost sums it, so the
// count is the plain version's bit for bit; `<` is strict and false for a
// NaN distance, which is never inside. The terminal cost repeats it (K1's
// final fam.cost). The obstacle count M arrives at run time in the pack,
// [w (2A), penalty, M, centres (M, A), r² (M)], so the obstacles are not
// sized at compile time: `obs` points at them in global memory, and every
// thread of a warp reads the same address (one broadcast load).
template <int A>
struct LtiObstacle {
  static constexpr int kS = 2 * A;
  static constexpr bool kGoal = true;
  Lti<A> lti;
  float pen;
  int M;
  const float* obs;  // centres (M, A), then r² (M)

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt) {
    lti.load(fp, goal, dt);
    pen = fp[2 * A];
    M = (int)fp[2 * A + 1];
    obs = fp + 2 * A + 2;
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[A]) const { lti.step(x, ue); }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    int hits = 0;
    for (int m = 0; m < M; ++m) {
      const float* c = obs + m * A;
      float d2 = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float d = __fsub_rn(x[a], c[a]);
        d2 = a == 0 ? __fmul_rn(d, d) : __fadd_rn(d2, __fmul_rn(d, d));
      }
      hits += d2 < obs[M * A + m];
    }
    return __fadd_rn(lti.cost(x), __fmul_rn(pen, (float)hits));
  }
};

// 3-D quadrotor, x = (p (3), q (4; w, x, y, z), v (3), ω (3; body)), u =
// (F, τx, τy, τz) in mixer space: RK2 midpoint of ṗ = v, v̇ = R(q)ẑ F/m − gẑ,
// q̇ = ½ q ⊗ (0, ω), ω̇ = J⁻¹(τ − ω × Jω) with derivs evaluated twice (at the
// unnormalised midpoint), the model's divides by m, Jx, Jy, Jz, and one
// rsqrtf renormalisation of the quaternion at the end of the step, its
// squared norm summed left to right (models/quadrotor3d.py); hover cost,
// quadratic on the position towards robot r's goal[0:3] and on the velocity
// towards goal[7:10], w_tilt · 2(qx² + qy²) and w_om |ω|², in the eager
// cost's order (ops/cost.Quadrotor3DHoverCost). The widest state of the
// families: 13 floats in registers, 10 more at the midpoint.
struct Quadrotor3D {
  static constexpr int kS = 13;
  static constexpr bool kGoal = true;
  float w[8], m, jx, jy, jz, jzy, jxz, jyx, g, gp[3], gv[3], h, hh;

  __device__ __forceinline__ void load(const float* fp, const float* goal, float dt) {
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = fp[i];
    m = fp[8];
    jx = fp[9];
    jy = fp[10];
    jz = fp[11];
    jzy = fp[12];  // Jz − Jy
    jxz = fp[13];  // Jx − Jz
    jyx = fp[14];  // Jy − Jx
    g = fp[15];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      gp[i] = goal[i];
      gv[i] = goal[7 + i];
    }
    h = dt;
    hh = 0.5f * dt;
  }

  // (q̇, v̇, ω̇) at quaternion q (not necessarily unit) and body rates om
  // under u (models/quadrotor3d.Quadrotor3DDynamics.derivs)
  __device__ __forceinline__ void derivs(const float q[4], const float om[3], const float u[4],
                                         float qd[4], float acc[3], float wd[3]) const {
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float wx = om[0], wy = om[1], wz = om[2];
    const float fm = __fdiv_rn(u[0], m);
    acc[0] = __fmul_rn(__fmul_rn(2.0f, __fadd_rn(__fmul_rn(qx, qz), __fmul_rn(qw, qy))), fm);
    acc[1] = __fmul_rn(__fmul_rn(2.0f, __fsub_rn(__fmul_rn(qy, qz), __fmul_rn(qw, qx))), fm);
    acc[2] = __fsub_rn(
        __fmul_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)))),
                  fm),
        g);
    qd[0] = __fmul_rn(0.5f, -__fadd_rn(__fadd_rn(__fmul_rn(qx, wx), __fmul_rn(qy, wy)),
                                       __fmul_rn(qz, wz)));
    qd[1] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(__fmul_rn(qw, wx), __fmul_rn(qy, wz)),
                                      __fmul_rn(qz, wy)));
    qd[2] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(__fmul_rn(qw, wy), __fmul_rn(qz, wx)),
                                      __fmul_rn(qx, wz)));
    qd[3] = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(__fmul_rn(qw, wz), __fmul_rn(qx, wy)),
                                      __fmul_rn(qy, wx)));
    wd[0] = __fdiv_rn(__fsub_rn(u[1], __fmul_rn(__fmul_rn(jzy, wy), wz)), jx);
    wd[1] = __fdiv_rn(__fsub_rn(u[2], __fmul_rn(__fmul_rn(jxz, wz), wx)), jy);
    wd[2] = __fdiv_rn(__fsub_rn(u[3], __fmul_rn(__fmul_rn(jyx, wx), wy)), jz);
  }

  __device__ __forceinline__ void step(float x[kS], const float ue[4]) const {
    float qd[4], acc[3], wd[3], qm[4], vm[3], omm[3];
    derivs(x + 3, x + 10, ue, qd, acc, wd);
#pragma unroll
    for (int i = 0; i < 4; ++i) qm[i] = __fadd_rn(x[3 + i], __fmul_rn(hh, qd[i]));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vm[i] = __fadd_rn(x[7 + i], __fmul_rn(hh, acc[i]));
      omm[i] = __fadd_rn(x[10 + i], __fmul_rn(hh, wd[i]));
    }
    derivs(qm, omm, ue, qd, acc, wd);
    float qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qn[i] = __fadd_rn(x[3 + i], __fmul_rn(h, qd[i]));
    const float n2 = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(qn[0], qn[0]), __fmul_rn(qn[1], qn[1])), __fmul_rn(qn[2], qn[2])),
        __fmul_rn(qn[3], qn[3]));
    const float rn = rsqrtf(n2);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = __fadd_rn(x[i], __fmul_rn(h, vm[i]));
      x[7 + i] = __fadd_rn(x[7 + i], __fmul_rn(h, acc[i]));
      x[10 + i] = __fadd_rn(x[10 + i], __fmul_rn(h, wd[i]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) x[3 + i] = __fmul_rn(qn[i], rn);
  }

  __device__ __forceinline__ float cost(const float x[kS]) const {
    float pos = 0.0f, vel = 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float dp = __fsub_rn(x[i], gp[i]), dv = __fsub_rn(x[7 + i], gv[i]);
      const float cp = __fmul_rn(__fmul_rn(dp, w[i]), dp);
      const float cv = __fmul_rn(__fmul_rn(dv, w[4 + i]), dv);
      pos = i == 0 ? cp : __fadd_rn(pos, cp);
      vel = i == 0 ? cv : __fadd_rn(vel, cv);
    }
    const float tilt = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(x[4], x[4]), __fmul_rn(x[5], x[5])));
    const float om = __fadd_rn(__fadd_rn(__fmul_rn(x[10], x[10]), __fmul_rn(x[11], x[11])),
                               __fmul_rn(x[12], x[12]));
    return __fadd_rn(__fadd_rn(__fadd_rn(pos, __fmul_rn(w[3], tilt)), vel), __fmul_rn(w[7], om));
  }
};

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

// K2. Replaces the cross-tile fold of the TPU one-pass kernels (single-robot
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
__global__ void __launch_bounds__(kCombineThreads) softmin_combine_kernel(
    const float* __restrict__ partials, int nb, int TA, float lam, int normalize,
    float* __restrict__ beta_eta, float* __restrict__ dU) {
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

// K3 and K5 draw without stepping a model, so every (draw kd, step t) is
// independent: both spread their draws over (kd, t). A block covers kGroup
// draws and every step: lane j of each of its eight warps stands for draws
// kb + j and kb + 32 + j (two Philox chains in flight per lane), and warp w
// takes steps w, w + 8, w + 16, … (of each chunk, in K3); no warp steps
// anything, every warp draws. At most 64 registers a thread (four blocks
// per SM).
constexpr int kGroup = 64;  // draws per block of K3 and K5; ops/fused_solve.DRAW_GROUP
constexpr int kGroupThreads = 256;
constexpr int kGroupWarps = kGroupThreads / 32;

// K3. Replaces mppi_gpu_tpu/ops/pallas_rollout.py:_noise_dump_kernel (:2140)
// and _planar_noise_dump_kernel (:2872): the ε stream the solve consumed,
// written to memory for the debug dump and the replay check.
// What bounds it: the draw, ~300 dependent instructions per (kd, t) (one
// Philox block and A/2 Box-Muller pairs); the T·K·A·4-byte store (and 16 B
// per draw for the optional words) is ~7 µs at K = 10⁴, T = 200 and overlaps
// it. The per-rollout design it replaces walked each rollout's horizon in
// one thread, 79 blocks of 4 warps at K = 10⁴: a latency-bound chain on
// three-fifths of the SMs.
// Design: the horizon in chunks of kDumpChunk steps. Stage 1 draws the
// chunk's normals in parallel over (kd, t) as above into a shared-memory
// slab, (kDumpChunk, kGroup, A) floats, and writes the words (one 16-byte
// store per lane). Stage 2 gives one thread to each (draw, action) of the
// block, which walks the chunk's steps in order and shapes the normals with
// shape_eps's rounded operations in its order (OU: e = β·e + c·n, carried
// across chunks in a register; then ε = σ·e), so the output is bit-equal to
// the stream K1 consumes and ops/philox.sample_eps draws, in every mode. A
// step's writes are the block's 64·A consecutive floats (and the mirror
// rows, −ε, as many): coalesced, each byte of ε written once, with no
// re-read of the output, so OU costs the short in-order sweep over the slab
// and nothing in memory. The slab is small (24 KB at A = 3): four blocks
// per SM, and no limit on T.
constexpr int kDumpChunk = 32;  // horizon steps per stage of K3

template <int A>
__global__ void __launch_bounds__(kGroupThreads, 4) noise_dump_kernel(
    const float* __restrict__ sigma, float* __restrict__ eps_out,
    unsigned* __restrict__ words_out, int T, NoiseParams np) {
  __shared__ float slab[kDumpChunk * kGroup * A];  // (step in chunk, draw, action) normals
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = blockIdx.x * kGroup;
  // stage 2's thread: action a of draw kb + j (i = j·A + a: a step's writes
  // and slab reads are consecutive across the warp)
  const int i = threadIdx.x, j = i / A, a = i - j * A;
  const bool shaper = i < kGroup * A && kb + j < np.K_draw;
  const float sig = shaper ? sigma[a] : 0.0f;
  float* out = eps_out + (size_t)(kb + j) * A + a;
  const size_t stride = (size_t)np.K * A;
  const size_t mirror_off = (size_t)np.K_draw * A;
  float e = 0.0f;  // the unit-variance OU state of (kd, a)
  for (int c0 = 0; c0 < T; c0 += kDumpChunk) {
    const int c1 = min(T, c0 + kDumpChunk);
    // ---- stage 1: the chunk's draws, in parallel over (kd, t) --------------
    for (int t = c0 + warp; t < c1; t += kGroupWarps) {
      float n[2][A];
      unsigned q[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) draw_normals<A>(np, kb + 32 * h + lane, t, n[h], q[h]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* cell = slab + ((t - c0) * kGroup + 32 * h + lane) * A;
#pragma unroll
        for (int b = 0; b < A; ++b) cell[b] = n[h][b];
        const int kd = kb + 32 * h + lane;
        if (words_out != nullptr && kd < np.K_draw)
          *reinterpret_cast<uint4*>(words_out + ((size_t)t * np.K_draw + kd) * 4) =
              make_uint4(q[h][0], q[h][1], q[h][2], q[h][3]);
      }
    }
    __syncthreads();
    // ---- stage 2: shape in t order, write ε (and the mirror's −ε) -----------
    if (shaper) {
      for (int t = c0; t < c1; ++t) {
        const float nt = slab[(t - c0) * kGroup * A + i];
        e = np.ou_beta > 0.0f && t > 0
                ? __fadd_rn(__fmul_rn(np.ou_beta, e), __fmul_rn(np.ou_c, nt))
                : nt;  // shape_eps's operations, in its order
        const float s = __fmul_rn(sig, e);
        out[(size_t)t * stride] = s;
        if (np.antithetic) out[(size_t)t * stride + mirror_off] = -s;
      }
    }
    __syncthreads();  // the slab is free for the next chunk
  }
}

// K5. Replaces mppi_gpu_tpu/ops/pallas_rollout.py:_weighted_update_kernel
// (:1966), launched by pallas_weighted_update (:2079): ΔU[t, a] = Σ_k w_k
// ε_k[t, a] for given softmin weights w (K,), already normalized. It is
// kernel B of the two-kernel sharded solve: K4, the softmin across the ranks,
// then K5 on each rank's slice of w at the rank's draw offset.
// What bounds it: the draw, as K3 (ε is regenerated from the stateless
// counter, never stored), plus a multiply-add per action and draw and the
// reduction. Its traffic is w (4 B per rollout) and one (2 + T·A)-float
// partial per block; in the injected-ε mode (INJ) it streams T·A·4 B per
// rollout instead and is bytes-bound. The per-rollout design it replaces
// walked each rollout's horizon in one thread (79 blocks of 4 warps at K =
// 10⁴) and paid five shuffles and five adds per action and step for every
// rollout.
// Design: draws spread over (kd, t) as K3's. Each lane weighs its two draws
// at step t in registers (Σ of two w̃·n per action) before one warp_sum per
// action, so a partial row covers 64 draws. Antithetic (Philox mode): draw
// kd stands for rollout kd and its mirror K_draw + kd, whose ε is −ε_kd, so
// it is weighed once by w̃ = w[kd] − w[K_draw + kd] (the TPU's fold,
// pallas_rollout.py:1904-1906) and half the noise is drawn. The block sums
// N[t, a] = Σ w̃·n over its draws into shared memory, each (t, a) by one
// warp, and writes σ·N. OU mode, route (b): ε_k[t] = σ·e_k[t] with e_k[0] =
// n_k[0], e_k[t] = β·e_k[t−1] + c·n_k[t] is linear in the normals, so Σ_k
// w̃_k e_k[t] = E[t] with E[0] = N[0], E[t] = β·E[t−1] + c·N[t]: A threads
// run that filter once over the block's (T, A) sums and write σ·E. Exact in
// real arithmetic; the rounding differs from shaping each rollout's ε
// (route (a) would keep every rollout's normals for its horizon in shared
// memory, 153 KB for 64 draws at T = 200, one block per SM), and the result
// is held, as in every mode, to 1e-5 of Σ|w ε| of the plain version. Each
// row covers the whole horizon of its draws: β_b = η_b = 0, and K2 folds the
// rows with f_b = 1 and no division by η (`normalize` 0). Every sum has a
// fixed order, no atomics: a run repeats bit for bit. Injected ε: the two
// rollouts' A floats at step t, read coalesced (a step's K·A floats are
// contiguous), weighed by w, no fold, no σ.
template <int A, bool INJ>
__global__ void __launch_bounds__(kGroupThreads, 4) weighted_update_kernel(
    const float* __restrict__ sigma, const float* __restrict__ w,
    const float* __restrict__ eps_in, float* __restrict__ partials, int T, NoiseParams np) {
  extern __shared__ float red[];  // (T, A) Σ over the block's draws of w̃·n (INJ: w·ε)
  const int TA = T * A;
  const bool fold = !INJ && np.antithetic;
  const int n = fold ? np.K_draw : np.K;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kb = blockIdx.x * kGroup;
  int k[2];
  float wk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    k[h] = kb + 32 * h + lane;
    wk[h] = k[h] < n ? (fold ? w[k[h]] - w[np.K_draw + k[h]] : w[k[h]]) : 0.0f;
  }
  for (int t = warp; t < T; t += kGroupWarps) {
    float acc[A];
    if (INJ) {
      const float* row = eps_in + (size_t)t * np.K * A;
      float v[2][A];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int a = 0; a < A; ++a) v[h][a] = k[h] < n ? row[(size_t)k[h] * A + a] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < A; ++a) acc[a] = wk[0] * v[0][a] + wk[1] * v[1][a];
    } else {
      // draws past n are drawn too (their normals are finite) and weigh 0:
      // both chains stay free of branches
      float nn[2][A];
      unsigned q[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) draw_normals<A>(np, k[h], t, nn[h], q[h]);
#pragma unroll
      for (int a = 0; a < A; ++a) acc[a] = wk[0] * nn[0][a] + wk[1] * nn[1][a];
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const float v = warp_sum(acc[a]);
      if (lane == 0) red[t * A + a] = v;
    }
  }
  __syncthreads();
  float* part = partials + (size_t)blockIdx.x * (2 + (size_t)TA);
  if (!INJ && np.ou_beta > 0.0f) {
    if (threadIdx.x < A) {  // the OU filter over the block's sums, action a
      const int a = threadIdx.x;
      const float s = sigma[a];
      float e = 0.0f;
      for (int t = 0; t < T; ++t) {
        const float nt = red[t * A + a];
        e = t > 0 ? __fadd_rn(__fmul_rn(np.ou_beta, e), __fmul_rn(np.ou_c, nt)) : nt;
        part[2 + t * A + a] = __fmul_rn(s, e);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TA; i += kGroupThreads)
      part[2 + i] = INJ ? red[i] : __fmul_rn(sigma[i % A], red[i]);
  }
  if (threadIdx.x == 0) {
    part[0] = 0.0f;
    part[1] = 0.0f;
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
};

template <int A, bool INJ>
cudaError_t launch_weighted_update(const float* sigma, const float* w, const float* eps_in,
                                   float* partials, int T, const NoiseParams& np,
                                   cudaStream_t stream) {
  const int n = (!INJ && np.antithetic) ? np.K_draw : np.K;
  const size_t smem = (size_t)T * A * sizeof(float);
  cudaError_t err = set_smem(weighted_update_kernel<A, INJ>, smem);
  if (err != cudaSuccess) return err;
  weighted_update_kernel<A, INJ><<<(n + kGroup - 1) / kGroup, kGroupThreads, smem, stream>>>(
      sigma, w, eps_in, partials, T, np);
  return cudaGetLastError();
}

template <int A>
cudaError_t launch_weighted_update_mode(const float* sigma, const float* w, const float* eps_in,
                                        float* partials, int T, const NoiseParams& np,
                                        cudaStream_t stream) {
  return eps_in != nullptr
             ? launch_weighted_update<A, true>(sigma, w, eps_in, partials, T, np, stream)
             : launch_weighted_update<A, false>(sigma, w, eps_in, partials, T, np, stream);
}

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

// K1 (PASS2) or K4 for the family id and A: the instances that exist.
template <bool PASS2>
int launch_family(int family, const SolveArgs& a, const NoiseParams& np, cudaStream_t s) {
  const int A = a.A;
  if (a.R < 1 || a.R > kMaxRobots) return (int)cudaErrorInvalidValue;
  switch (family) {
    case kLtiFamily:
      if (a.goal == nullptr) return (int)cudaErrorInvalidValue;
      switch (A) {
        case 1: return launch_mode<Lti<1>, 1, PASS2>(a, np, s);
        case 2: return launch_mode<Lti<2>, 2, PASS2>(a, np, s);
        case 3: return launch_mode<Lti<3>, 3, PASS2>(a, np, s);
        case 4: return launch_mode<Lti<4>, 4, PASS2>(a, np, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case kPendulumFamily:
      return A == 1 ? launch_mode<Pendulum, 1, PASS2>(a, np, s) : (int)cudaErrorInvalidValue;
    case kCartPoleFamily:
      return A == 1 ? launch_mode<CartPole, 1, PASS2>(a, np, s) : (int)cudaErrorInvalidValue;
    case kUnicycleFamily:
      if (a.goal == nullptr || A != 2) return (int)cudaErrorInvalidValue;
      return launch_mode<Unicycle, 2, PASS2>(a, np, s);
    case kQuadrotorFamily:
      if (a.goal == nullptr || A != 2) return (int)cudaErrorInvalidValue;
      return launch_mode<Quadrotor, 2, PASS2>(a, np, s);
    case kArmFamily:
      if (a.goal == nullptr || A != 2) return (int)cudaErrorInvalidValue;
      return launch_mode<Arm, 2, PASS2>(a, np, s);
    case kLtiObstacleFamily:
      if (a.goal == nullptr) return (int)cudaErrorInvalidValue;
      switch (A) {
        case 1: return launch_mode<LtiObstacle<1>, 1, PASS2>(a, np, s);
        case 2: return launch_mode<LtiObstacle<2>, 2, PASS2>(a, np, s);
        case 3: return launch_mode<LtiObstacle<3>, 3, PASS2>(a, np, s);
        case 4: return launch_mode<LtiObstacle<4>, 4, PASS2>(a, np, s);
        default: return (int)cudaErrorInvalidValue;
      }
    case kQuadrotor3DFamily:
      if (a.goal == nullptr || A != 4) return (int)cudaErrorInvalidValue;
      return launch_mode<Quadrotor3D, 4, PASS2>(a, np, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t as int: 0 on a launched kernel.

// family (FamilyId), x0 (R, S), U (R, T, A), params [σ (A), Σ⁻¹ (A), family
// part], goal (R, S) for a family with a goal (all but the pendulum and the
// cart-pole; else unused, may be null), keys (R,) int64 or null, step_ptr
// (a 0-dim int64 control step on the device, read in place of `step`) or
// null, eps_in (R, T, K, A) or null → S (R, K), partials (R, nb, 2 + T·A);
// the draws start at counter word k0 (0 on one GPU). S is 2A for LTI
// and LTI with obstacles (A ≤ 4), 2 for the pendulum and 4 for the
// cart-pole (A = 1), 3 for the unicycle, 6 for the quadrotor and 4 for the
// arm (A = 2), 13 for the 3-D quadrotor (A = 4). With partials null it
// launches K4 instead (S alone; λ_softmin unused). `width` is the rollouts
// per block, which selects the body: 128 the per-rollout body, 32 the slab
// body (nb = ceil(K / width)); any other width is refused.
int mppi_solve_partials(int family, const float* x0, const float* U, const float* params,
                        const float* goal, const long long* keys, const long long* step_ptr,
                        const float* eps_in, float* S, float* partials, int R, int K, int T,
                        int A, float dt, float lam_cost, float lam_softmin, unsigned key0,
                        unsigned key1, unsigned step, unsigned it, unsigned k0, int antithetic,
                        float ou_beta, float ou_c, int width, void* stream) {
  const NoiseParams np = make_noise(key0, key1, step, it, k0, K, antithetic, ou_beta, ou_c);
  const SolveArgs a{x0, U, params, goal, keys, step_ptr, eps_in, S, partials, R, T, A, dt,
                    lam_cost, lam_softmin, width};
  return partials != nullptr ? launch_family<true>(family, a, np, (cudaStream_t)stream)
                             : launch_family<false>(family, a, np, (cudaStream_t)stream);
}

// partials (R, nb, 2 + TA) → beta_eta (R, 2), dU (R, TA); divided by η
// unless `normalize` is 0.
int mppi_softmin_combine(const float* partials, int R, int nb, int TA, float lam, int normalize,
                         float* beta_eta, float* dU, void* stream) {
  if (R < 1 || R > kMaxRobots) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)nb + kCombineWarps * kCombineCols) * sizeof(float);
  cudaError_t err = set_smem(softmin_combine_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((TA + kCombineCols - 1) / kCombineCols, R);
  softmin_combine_kernel<<<grid, kCombineThreads, smem, (cudaStream_t)stream>>>(
      partials, nb, TA, lam, normalize, beta_eta, dU);
  return (int)cudaGetLastError();
}

// K3: sigma (A,) → eps_out (T, K, A) and, unless null, words_out (T, K_draw,
// 4); nb = ceil(K_draw / 64) blocks. The draws start at counter word k0.
int mppi_noise_dump(const float* sigma, float* eps_out, unsigned* words_out, int K, int T,
                    int A, unsigned key0, unsigned key1, unsigned step, unsigned it,
                    unsigned k0, int antithetic, float ou_beta, float ou_c, void* stream) {
  const NoiseParams np = make_noise(key0, key1, step, it, k0, K, antithetic, ou_beta, ou_c);
  const int nb = (np.K_draw + kGroup - 1) / kGroup;
  cudaStream_t s = (cudaStream_t)stream;
  switch (A) {
    case 1: noise_dump_kernel<1><<<nb, kGroupThreads, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 2: noise_dump_kernel<2><<<nb, kGroupThreads, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 3: noise_dump_kernel<3><<<nb, kGroupThreads, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    case 4: noise_dump_kernel<4><<<nb, kGroupThreads, 0, s>>>(sigma, eps_out, words_out, T, np); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5: sigma (A,), w (K,) normalized weights, eps_in (T, K, A) or null →
// partials (nb, 2 + T·A) for K2 to fold (normalize 0), nb = ceil(n / 64)
// with n = K/2 under antithetic in Philox mode, else K. The draws start at
// counter word k0.
int mppi_weighted_update(const float* sigma, const float* w, const float* eps_in,
                         float* partials, int K, int T, int A, unsigned key0, unsigned key1,
                         unsigned step, unsigned it, unsigned k0, int antithetic, float ou_beta,
                         float ou_c, void* stream) {
  const NoiseParams np = make_noise(key0, key1, step, it, k0, K, antithetic, ou_beta, ou_c);
  cudaStream_t s = (cudaStream_t)stream;
  switch (A) {
    case 1: return (int)launch_weighted_update_mode<1>(sigma, w, eps_in, partials, T, np, s);
    case 2: return (int)launch_weighted_update_mode<2>(sigma, w, eps_in, partials, T, np, s);
    case 3: return (int)launch_weighted_update_mode<3>(sigma, w, eps_in, partials, T, np, s);
    case 4: return (int)launch_weighted_update_mode<4>(sigma, w, eps_in, partials, T, np, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
