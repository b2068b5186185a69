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
// template with its second flag off. K1's and K4's bodies, the noise and the
// launch of a body for a struct are in mppi_solve.cuh, which a family
// registered from user code is compiled against into a library of its own
// (ops/_build.build_family); this file holds the eight built-in structs, K2,
// K3, K5 and the C entries.
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

#include "mppi_solve.cuh"
#include "softmin_combine.cuh"

namespace {

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

// K2: the fold of softmin_combine.cuh in column tiles (what it replaces of
// the TPU kernels, what bounds it and its design are described there).
__global__ void __launch_bounds__(kCombineThreads) softmin_combine_kernel(
    const float* __restrict__ partials, int nb, int TA, float lam, int normalize,
    float* __restrict__ beta_eta, float* __restrict__ dU) {
  combine_tile(partials, nb, TA, lam, normalize, beta_eta, dU);
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
// contiguous), weighed by w, no fold, no σ. `step_ptr`, when set, points at
// the control step (a 0-dim int64 on the device) whose low word replaces
// np.step, as in K1: a CUDA graph that captured the launch replays each
// cycle's step.
// Two forms share the body: weighted_update_kernel reads the weights w;
// softmin_update_kernel, the two-kernel sharded solve's, reads the rank's
// costs S, β and η after the collectives and λ, and forms each weight in its
// prologue as w_k = e_k/η, e_k = expf(−(S_k − β)·float32(1/λ)), each torch op
// rounded once (__fsub_rn, __fmul_rn, __fdiv_rn), as K9's weight blocks and
// K11 (sharded_combine.cu) form e_k: bit-equal to torch's exp(−(S − β)/λ)/η on
// the card, and no w is written. Under antithetic it forms w̃ = w[kd] −
// w[K_draw + kd] from the two costs.

// the weight of a rollout from what the form reads: w itself, or its cost
struct GivenWeight {
  __device__ __forceinline__ float operator()(float w) const { return w; }
};
struct SoftminWeight {
  float beta, eta, inv_lam;  // β and η after the collectives, float32(1/λ)
  __device__ __forceinline__ float operator()(float s) const {
    return __fdiv_rn(expf(__fmul_rn(-__fsub_rn(s, beta), inv_lam)), eta);
  }
};

// K5's body: `src` holds w (GivenWeight) or S (SoftminWeight), one per rollout
template <int A, bool INJ, class Weight>
__device__ __forceinline__ void weighted_update_body(
    const float* __restrict__ sigma, const float* __restrict__ src, const Weight weight,
    const float* __restrict__ eps_in, float* __restrict__ partials, int T, const NoiseParams& np) {
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
    wk[h] = k[h] < n ? (fold ? weight(src[k[h]]) - weight(src[np.K_draw + k[h]])
                              : weight(src[k[h]]))
                     : 0.0f;
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

template <int A, bool INJ>
__global__ void __launch_bounds__(kGroupThreads, 4) weighted_update_kernel(
    const float* __restrict__ sigma, const float* __restrict__ w,
    const float* __restrict__ eps_in, float* __restrict__ partials, int T, NoiseParams np,
    const long long* __restrict__ step_ptr) {
  if (step_ptr != nullptr) np.step = (unsigned)(unsigned long long)*step_ptr;
  weighted_update_body<A, INJ>(sigma, w, GivenWeight{}, eps_in, partials, T, np);
}

template <int A, bool INJ>
__global__ void __launch_bounds__(kGroupThreads, 4) softmin_update_kernel(
    const float* __restrict__ sigma, const float* __restrict__ S,
    const float* __restrict__ beta, const float* __restrict__ eta, float inv_lam,
    const float* __restrict__ eps_in, float* __restrict__ partials, int T, NoiseParams np,
    const long long* __restrict__ step_ptr) {
  if (step_ptr != nullptr) np.step = (unsigned)(unsigned long long)*step_ptr;
  weighted_update_body<A, INJ>(sigma, S, SoftminWeight{*beta, *eta, inv_lam}, eps_in, partials,
                               T, np);
}

// the softmin K5 forms its weights from, when it is not given w
struct SoftminArgs {
  const float* S;     // the rank's costs (K,)
  const float* beta;  // 0-dim, after the MIN collective
  const float* eta;   // 0-dim, after the SUM collective
  float inv_lam;      // float32(1/λ)
};

template <int A, bool INJ>
cudaError_t launch_weighted_update(const float* sigma, const float* w, const SoftminArgs& sm,
                                   const float* eps_in, float* partials, int T,
                                   const NoiseParams& np, const long long* step_ptr,
                                   cudaStream_t stream) {
  const int n = (!INJ && np.antithetic) ? np.K_draw : np.K;
  const int nb = (n + kGroup - 1) / kGroup;
  const size_t smem = (size_t)T * A * sizeof(float);
  if (w != nullptr) {
    cudaError_t err = set_smem(weighted_update_kernel<A, INJ>, smem);
    if (err != cudaSuccess) return err;
    weighted_update_kernel<A, INJ><<<nb, kGroupThreads, smem, stream>>>(sigma, w, eps_in,
                                                                        partials, T, np, step_ptr);
  } else {
    cudaError_t err = set_smem(softmin_update_kernel<A, INJ>, smem);
    if (err != cudaSuccess) return err;
    softmin_update_kernel<A, INJ><<<nb, kGroupThreads, smem, stream>>>(
        sigma, sm.S, sm.beta, sm.eta, sm.inv_lam, eps_in, partials, T, np, step_ptr);
  }
  return cudaGetLastError();
}

template <int A>
cudaError_t launch_weighted_update_mode(const float* sigma, const float* w, const SoftminArgs& sm,
                                        const float* eps_in, float* partials, int T,
                                        const NoiseParams& np, const long long* step_ptr,
                                        cudaStream_t stream) {
  return eps_in != nullptr
             ? launch_weighted_update<A, true>(sigma, w, sm, eps_in, partials, T, np, step_ptr,
                                               stream)
             : launch_weighted_update<A, false>(sigma, w, sm, eps_in, partials, T, np, step_ptr,
                                                stream);
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
                    lam_cost, lam_softmin, width, nullptr};
  return partials != nullptr ? launch_family<true>(family, a, np, (cudaStream_t)stream)
                             : launch_family<false>(family, a, np, (cudaStream_t)stream);
}

// The residency of the K1 (`pass2`) or K4 instance that mppi_solve_partials
// would launch for `family`, `goal` and `eps_in` (null or not), T, A and
// `width`: out (2,) receives its blocks per SM and the current device's
// SMs. Launches nothing; `stream` is unused.
int mppi_solve_residency(int family, const float* goal, const float* eps_in, int T, int A,
                         int pass2, int width, int* out, void* stream) {
  (void)stream;
  const NoiseParams np = make_noise(0, 0, 0, 0, 0, 1, 0, 0.0f, 0.0f);
  const SolveArgs a{nullptr, nullptr, nullptr, goal, nullptr, nullptr, eps_in, nullptr, nullptr,
                    1, T, A, 0.0f, 0.0f, 0.0f, width, out};
  return pass2 ? launch_family<true>(family, a, np, nullptr)
               : launch_family<false>(family, a, np, nullptr);
}

// partials (R, nb, 2 + TA) → beta_eta (R, 2), dU (R, TA); divided by η
// unless `normalize` is 0; a block per 32-column tile. Refuses
// (cudaErrorInvalidValue) R outside [1, 65535], nb or TA below 1, and more
// rows than a block's shared memory holds.
int mppi_softmin_combine(const float* partials, int R, int nb, int TA, float lam, int normalize,
                         float* beta_eta, float* dU, void* stream) {
  if (R < 1 || R > kMaxRobots || nb < 1 || TA < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_floats(nb) * sizeof(float);
  if (smem > kCombineSmemFloats * sizeof(float)) return (int)cudaErrorInvalidValue;
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
// counter word k0. step_ptr (a 0-dim int64 control step on the device, read
// in place of `step`) or null, as K1's. With w null, the softmin form: the
// weights formed from S (K,), beta and eta (one float each on the device)
// and inv_lam = float32(1/λ) as expf(−(S − β)·inv_lam)/η. Refuses
// (cudaErrorInvalidValue) both w and S given or neither, and the softmin
// form without beta or eta.
int mppi_weighted_update(const float* sigma, const float* w, const float* eps_in,
                         float* partials, int K, int T, int A, unsigned key0, unsigned key1,
                         unsigned step, unsigned it, unsigned k0, int antithetic, float ou_beta,
                         float ou_c, const long long* step_ptr, const float* S, const float* beta,
                         const float* eta, float inv_lam, void* stream) {
  if ((w == nullptr) == (S == nullptr) || (S != nullptr && (beta == nullptr || eta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const NoiseParams np = make_noise(key0, key1, step, it, k0, K, antithetic, ou_beta, ou_c);
  const SoftminArgs sm{S, beta, eta, inv_lam};
  cudaStream_t s = (cudaStream_t)stream;
  switch (A) {
    case 1: return (int)launch_weighted_update_mode<1>(sigma, w, sm, eps_in, partials, T, np, step_ptr, s);
    case 2: return (int)launch_weighted_update_mode<2>(sigma, w, sm, eps_in, partials, T, np, step_ptr, s);
    case 3: return (int)launch_weighted_update_mode<3>(sigma, w, sm, eps_in, partials, T, np, step_ptr, s);
    case 4: return (int)launch_weighted_update_mode<4>(sigma, w, sm, eps_in, partials, T, np, step_ptr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
