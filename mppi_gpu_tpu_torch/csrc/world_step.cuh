// K6's world bodies and one robot's control cycle, shared by K6
// (world_step.cu), which runs robots r, r + blockDim, … in the threads of
// one block, by K2's epilogue (combine_tail.cu), which runs robot r in
// thread 0 of the last of K2's blocks to finish for that robot, and by the
// sharded controller's tail (sharded_combine.cu), in thread 0 of its row's
// block. All run one robot's cycle as a `Robot`: its loads, then its
// arithmetic and stores, so all compute the same floats. The arithmetic, the
// packs and their order are described in world_step.cu.
//
// Two device functions give a float by a shorter sequence than the one the
// plain version's expression names, and the same float for every input:
// `rcp` (1/x correctly rounded, the arm's inverse determinant: the
// reciprocal's sequence in place of the general division's) and `sin_cos`
// (sinf and cosf of one argument from one call). Each is held bit for bit
// against __fdiv_rn(1, x), sinf and cosf over all 2³² float inputs on the
// card (mppi_world_identities in world_step.cu, chip_smoke.py phase 21).
//
// Everything lives in the namespace `world` inside an anonymous namespace, so
// a translation unit may include it beside mppi_solve.cuh and solve_tail.cuh,
// and no library exports any of it.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace world {

constexpr int kMaxLeaves = 6;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// 1/x rounded once: IEEE 754 rounds the reciprocal and the division 1/x to
// the same float
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }
// sinf(x) and cosf(x), their argument reduced once
__device__ __forceinline__ void sin_cos(float x, float* s, float* c) { sincosf(x, s, c); }

// torch.clamp(v, lo, hi) on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum / torch.minimum with a bound that is not NaN
__device__ __forceinline__ float nan_max(float a, float b) { return isnan(a) ? a : fmaxf(a, b); }
__device__ __forceinline__ float nan_min(float a, float b) { return isnan(a) ? a : fminf(a, b); }

// y + c·k over n components (the RK4 stages' arguments)
template <int N>
__device__ __forceinline__ void axpy(float* out, const float* y, float c, const float* k) {
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = add(y[i], mul(c, k[i]));
}

// y + (h/6)·(k1 + 2·k2 + 2·k3 + k4), left to right
template <int N>
__device__ __forceinline__ void rk4_sum(float* y, float h6, const float* k1, const float* k2,
                                        const float* k3, const float* k4) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    y[i] = add(y[i], mul(h6, add(add(add(k1[i], mul(2.0f, k2[i])), mul(2.0f, k3[i])), k4[i])));
}

// One RK4 step of W's derivative at `w` (h, h/2 and h/6 from the pack).
template <class W>
__device__ __forceinline__ void rk4(const W& w, float* y, const float* u) {
  constexpr int S = W::kS;
  float k1[S], k2[S], k3[S], k4[S], t[S];
  w.deriv(y, u, k1);
  axpy<S>(t, y, w.hh, k1);
  w.deriv(t, u, k2);
  axpy<S>(t, y, w.hh, k2);
  w.deriv(t, u, k3);
  axpy<S>(t, y, w.h, k3);
  w.deriv(t, u, k4);
  rk4_sum<S>(y, w.h6, k1, k2, k3, k4);
}

// ---- worlds -----------------------------------------------------------------
// Each: kS state numbers in the order of the world's `.x`, kA actions, its
// state leaves' widths (width(l); the leaves in the order of its state
// NamedTuple, the clock last and apart), kParams packed floats. `load` reads
// the pack; `clamp_u` clamps the held action as physics_step does; `step` is
// one physics_step (RK4 and the post-step rules).

struct Cadence {
  float h, hh, h6, end;
  __device__ void load_cadence(const float* p) { h = p[0]; hh = p[1]; h6 = p[2]; end = p[3]; }
};

// envs/point_mass_world.py: per axis (m + armature)·q̈ = gear·u − damping·q̇,
// RK4, then the joint-limit clamp with the velocity zeroed at the stop.
template <int N>
struct PointMass : Cadence {
  static constexpr int kS = 2 * N, kA = N, kLeaves = 2, kParams = 9;
  __host__ __device__ static constexpr int width(int) { return N; }
  float cr, gear, damp, inv_m, jr;
  __device__ void load(const float* p) {
    load_cadence(p);
    cr = p[4]; gear = p[5]; damp = p[6]; inv_m = p[7]; jr = p[8];
  }
  __device__ void clamp_u(float* u) const {
#pragma unroll
    for (int i = 0; i < N; ++i) u[i] = clampf(u[i], -cr, cr);
  }
  __device__ float accel(float qd, float u) const {
    return mul(sub(mul(gear, u), mul(damp, qd)), inv_m);
  }
  __device__ void step(float* x, const float* u) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float q = x[i], qd = x[N + i];
      const float k1q = qd, k1v = accel(qd, u[i]);
      const float k2q = add(qd, mul(hh, k1v)), k2v = accel(k2q, u[i]);
      const float k3q = add(qd, mul(hh, k2v)), k3v = accel(k3q, u[i]);
      const float k4q = add(qd, mul(h, k3v)), k4v = accel(k4q, u[i]);
      float qn = add(q, mul(h6, add(add(add(k1q, mul(2.0f, k2q)), mul(2.0f, k3q)), k4q)));
      float qdn = add(qd, mul(h6, add(add(add(k1v, mul(2.0f, k2v)), mul(2.0f, k3v)), k4v)));
      const bool hit = fabsf(qn) > jr;
      qn = clampf(qn, -jr, jr);
      x[i] = qn;
      x[N + i] = hit ? 0.0f : qdn;
    }
  }
};

// envs/pendulum_world.py: θ̈ = (g/l)·sin θ + u/(m·l²) − b·θ̇.
struct Pendulum : Cadence {
  static constexpr int kS = 2, kA = 1, kLeaves = 2, kParams = 8;
  __host__ __device__ static constexpr int width(int) { return 1; }
  float mt, gl, inv_ml2, damp;
  __device__ void load(const float* p) {
    load_cadence(p);
    mt = p[4]; gl = p[5]; inv_ml2 = p[6]; damp = p[7];
  }
  __device__ void clamp_u(float* u) const { u[0] = clampf(u[0], -mt, mt); }
  __device__ void deriv(const float* y, const float* u, float* k) const {
    k[0] = y[1];
    k[1] = sub(add(mul(gl, sinf(y[0])), mul(u[0], inv_ml2)), mul(damp, y[1]));
  }
  __device__ void step(float* x, const float* u) const { rk4(*this, x, u); }
};

// envs/cartpole_world.py: the coupled cart-pole ODE, then the track limit.
struct CartPole : Cadence {
  static constexpr int kS = 4, kA = 1, kLeaves = 4, kParams = 12;
  __host__ __device__ static constexpr int width(int) { return 1; }
  float mf, inv_total, ml, g, l, c43, mp, tl;
  __device__ void load(const float* p) {
    load_cadence(p);
    mf = p[4]; inv_total = p[5]; ml = p[6]; g = p[7]; l = p[8]; c43 = p[9]; mp = p[10];
    tl = p[11];
  }
  __device__ void clamp_u(float* u) const { u[0] = clampf(u[0], -mf, mf); }
  // y = [p, θ, ṗ, θ̇] → [ṗ, θ̇, p̈, θ̈]
  __device__ void deriv(const float* y, const float* u, float* k) const {
    float s, c;
    sin_cos(y[1], &s, &c);
    const float thd = y[3];
    const float a = mul(add(u[0], mul(mul(ml, mul(thd, thd)), s)), inv_total);
    const float den = mul(l, sub(c43, mul(mul(mp, mul(c, c)), inv_total)));
    const float thdd = dvd(sub(mul(g, s), mul(c, a)), den);
    k[0] = y[2];
    k[1] = thd;
    k[2] = sub(a, mul(mul(mul(ml, thdd), c), inv_total));
    k[3] = thdd;
  }
  __device__ void step(float* x, const float* u) const {
    rk4(*this, x, u);
    const bool hit = fabsf(x[0]) > tl;
    x[0] = clampf(x[0], -tl, tl);
    if (hit) x[2] = 0.0f;
  }
};

// envs/unicycle_world.py: [v·cos θ, v·sin θ, ω].
struct Unicycle : Cadence {
  static constexpr int kS = 3, kA = 2, kLeaves = 1, kParams = 6;
  __host__ __device__ static constexpr int width(int) { return 3; }
  float mv, mw;
  __device__ void load(const float* p) {
    load_cadence(p);
    mv = p[4]; mw = p[5];
  }
  __device__ void clamp_u(float* u) const {
    u[0] = clampf(u[0], -mv, mv);
    u[1] = clampf(u[1], -mw, mw);
  }
  __device__ void deriv(const float* y, const float* u, float* k) const {
    float s, c;
    sin_cos(y[2], &s, &c);
    k[0] = mul(u[0], c);
    k[1] = mul(u[0], s);
    k[2] = u[1];
  }
  __device__ void step(float* x, const float* u) const { rk4(*this, x, u); }
};

// envs/quadrotor_world.py: the command (F, D) mixed into two rotor thrusts
// (F ± D)/2, each clamped to [0, max_thrust]; u holds the thrusts after
// clamp_u.
struct Quadrotor : Cadence {
  static constexpr int kS = 6, kA = 2, kLeaves = 6, kParams = 9;
  __host__ __device__ static constexpr int width(int) { return 1; }
  float mt, inv_m, g, arm, inv_i;
  __device__ void load(const float* p) {
    load_cadence(p);
    mt = p[4]; inv_m = p[5]; g = p[6]; arm = p[7]; inv_i = p[8];
  }
  __device__ void clamp_u(float* u) const {
    const float F = u[0], D = u[1];
    u[0] = clampf(mul(0.5f, add(F, D)), 0.0f, mt);
    u[1] = clampf(mul(0.5f, sub(F, D)), 0.0f, mt);
  }
  // y = [px, pz, θ, vx, vz, ω]
  __device__ void deriv(const float* y, const float* u, float* k) const {
    const float f_tot = add(u[0], u[1]);
    float s, c;
    sin_cos(y[2], &s, &c);
    k[0] = y[3];
    k[1] = y[4];
    k[2] = y[5];
    k[3] = mul(mul(f_tot, s), inv_m);
    k[4] = sub(mul(mul(f_tot, c), inv_m), g);
    k[5] = mul(mul(arm, sub(u[0], u[1])), inv_i);
  }
  __device__ void step(float* x, const float* u) const { rk4(*this, x, u); }
};

// envs/quadrotor3d_world.py: [F, τx, τy, τz] mixed into four rotor thrusts
// ("+" configuration), clamped, the achieved wrench rebuilt from them; the
// rigid-body ODE; the quaternion renormalised after each RK4 step. clamp_u
// turns u into the wrench.
struct Quadrotor3D : Cadence {
  static constexpr int kS = 13, kA = 4, kLeaves = 4, kParams = 17;
  __host__ __device__ static constexpr int width(int l) { return l == 1 ? 4 : 3; }
  float mt, inv_2arm, inv_4kappa, arm, kappa, inv_m, g, jzy, jxz, jyx, inv_jx, inv_jy, inv_jz;
  __device__ void load(const float* p) {
    load_cadence(p);
    mt = p[4]; inv_2arm = p[5]; inv_4kappa = p[6]; arm = p[7]; kappa = p[8]; inv_m = p[9];
    g = p[10]; jzy = p[11]; jxz = p[12]; jyx = p[13]; inv_jx = p[14]; inv_jy = p[15];
    inv_jz = p[16];
  }
  __device__ void clamp_u(float* u) const {
    const float qf = mul(u[0], 0.25f), qx = mul(u[1], inv_2arm), qy = mul(u[2], inv_2arm);
    const float qz = mul(u[3], inv_4kappa);
    const float f1 = clampf(add(sub(qf, qy), qz), 0.0f, mt);
    const float f2 = clampf(sub(add(qf, qx), qz), 0.0f, mt);
    const float f3 = clampf(add(add(qf, qy), qz), 0.0f, mt);
    const float f4 = clampf(sub(sub(qf, qx), qz), 0.0f, mt);
    u[0] = add(add(add(f1, f2), f3), f4);
    u[1] = mul(arm, sub(f2, f4));
    u[2] = mul(arm, sub(f3, f1));
    u[3] = mul(kappa, sub(add(sub(f1, f2), f3), f4));
  }
  // y = [p (3), q (4: w, x, y, z), v (3), ω (3)] → [v, q̇, v̇, ω̇]
  __device__ void deriv(const float* y, const float* W, float* k) const {
    const float qw = y[3], qx = y[4], qy = y[5], qz = y[6];
    const float wx = y[10], wy = y[11], wz = y[12];
    const float fm = mul(W[0], inv_m);
    k[0] = y[7];
    k[1] = y[8];
    k[2] = y[9];
    k[3] = mul(0.5f, -add(add(mul(qx, wx), mul(qy, wy)), mul(qz, wz)));
    k[4] = mul(0.5f, sub(add(mul(qw, wx), mul(qy, wz)), mul(qz, wy)));
    k[5] = mul(0.5f, sub(add(mul(qw, wy), mul(qz, wx)), mul(qx, wz)));
    k[6] = mul(0.5f, sub(add(mul(qw, wz), mul(qx, wy)), mul(qy, wx)));
    k[7] = mul(mul(2.0f, add(mul(qx, qz), mul(qw, qy))), fm);
    k[8] = mul(mul(2.0f, sub(mul(qy, qz), mul(qw, qx))), fm);
    k[9] = sub(mul(sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy)))), fm), g);
    k[10] = mul(sub(W[1], mul(mul(jzy, wy), wz)), inv_jx);
    k[11] = mul(sub(W[2], mul(mul(jxz, wz), wx)), inv_jy);
    k[12] = mul(sub(W[3], mul(mul(jyx, wx), wy)), inv_jz);
  }
  __device__ void step(float* x, const float* u) const {
    rk4(*this, x, u);
    const float n = add(add(mul(x[3], x[3]), mul(x[5], x[5])), add(mul(x[4], x[4]), mul(x[6], x[6])));
    const float r = rsqrtf(n);
#pragma unroll
    for (int i = 3; i < 7; ++i) x[i] = mul(x[i], r);
  }
};

// envs/arm_world.py through models/arm.py: the manipulator equations with the
// 2×2 mass matrix inverted through 1/det; the joint rates saturated after
// each RK4 step (_sat).
struct Arm : Cadence {
  static constexpr int kS = 4, kA = 2, kLeaves = 1, kParams = 13;
  __host__ __device__ static constexpr int width(int) { return 4; }
  float mt1, mt2, A, B, D, G1, G2, damp, mr;
  __device__ void load(const float* p) {
    load_cadence(p);
    mt1 = p[4]; mt2 = p[5]; A = p[6]; B = p[7]; D = p[8]; G1 = p[9]; G2 = p[10]; damp = p[11];
    mr = p[12];
  }
  __device__ void clamp_u(float* u) const {
    u[0] = clampf(u[0], -mt1, mt1);
    u[1] = clampf(u[1], -mt2, mt2);
  }
  // TwoLinkArmDynamics._deriv: y = [q1, q2, q̇1, q̇2] → [q̇1, q̇2, q̈1, q̈2]
  __device__ void deriv(const float* y, const float* u, float* k) const {
    const float q1 = y[0], q2 = y[1], qd1 = y[2], qd2 = y[3];
    float s2, c2;
    sin_cos(q2, &s2, &c2);
    const float c1 = cosf(q1), c12 = cosf(add(q1, q2));
    const float d11 = add(A, mul(mul(2.0f, B), c2));
    const float d12 = add(D, mul(B, c2));
    const float hs = mul(B, s2);
    const float r1 = sub(sub(add(u[0], mul(hs, add(mul(mul(2.0f, qd1), qd2), mul(qd2, qd2)))),
                             add(mul(G1, c1), mul(G2, c12))),
                         mul(damp, qd1));
    const float r2 = sub(sub(sub(u[1], mul(mul(hs, qd1), qd1)), mul(G2, c12)), mul(damp, qd2));
    const float inv_det = rcp(sub(mul(d11, D), mul(d12, d12)));
    k[0] = qd1;
    k[1] = qd2;
    k[2] = mul(sub(mul(D, r1), mul(d12, r2)), inv_det);
    k[3] = mul(sub(mul(d11, r2), mul(d12, r1)), inv_det);
  }
  __device__ void step(float* x, const float* u) const {
    rk4(*this, x, u);
    x[2] = nan_min(nan_max(x[2], -mr), mr);
    x[3] = nan_min(nan_max(x[3], -mr), mr);
  }
};

enum WorldId {  // ops/world_step.py WORLDS
  kPointMass1 = 0,
  kPointMass2 = 1,
  kPointMass3 = 2,
  kPendulum = 3,
  kCartPole = 4,
  kUnicycle = 5,
  kQuadrotor = 6,
  kQuadrotor3D = 7,
  kArm = 8,
};

struct AdvanceArgs {
  const float* in[kMaxLeaves];  // the state leaves, (R, width) each
  float* out[kMaxLeaves];       // the new state's leaves; may be `in` (in place)
  const float* time_in;         // 0-dim (shared) or (R,)
  float* time_out;              // may be time_in
  const float* u;               // (R, kA), robot r's at u + r·u_stride
  const float* params;
  float* xs;                    // (n_hist + 1, R, kS) or null
  float* us;                    // (n_hist, R, kA)
  float* ts;                    // (n_hist,) shared clock, (n_hist, R) per robot
  long long* step_ptr;          // the history row, read on the device
  float* x_out;                 // (R, kS) the new x, or null
  int u_stride, R, per_robot_clock, steps, n_hist, tick;
};

// One robot's control cycle in two parts. `load` reads everything the cycle
// reads, issued together before any arithmetic: the pack, the counter, the
// robot's clock (its own, or the fleet's shared one) and state and, where
// the caller gives its address, the held action. `run` steps the robot under
// that action, clamped as physics_step clamps it, steps_per_control times
// unless its clock was at or past sim_end, then writes its leaves, its own
// clock (per robot), its row of x_out and, at a history row, its rows of the
// histories. The fleet's shared clock, its history row and the counter's
// advance are the caller's (`finish`): every robot reads both first. A
// caller whose action is not in memory yet (it computes it) loads without it;
// `run_alone` then takes it, for a launch of one robot.
template <class W>
struct Robot {
  W w;
  long long row;    // the history row the counter holds, −1 without a counter
  float t;          // the robot's clock, then its clock after the cycle
  float x[W::kS];   // its state
  float u0[W::kA];  // the held action, as given

  __device__ __forceinline__ void load(const AdvanceArgs& a, int r, const float* u_in) {
    w.load(a.params);
    row = a.step_ptr != nullptr ? *a.step_ptr : -1;
    t = a.time_in[a.per_robot_clock ? r : 0];
    int off = 0;
#pragma unroll
    for (int l = 0; l < W::kLeaves; ++l) {
#pragma unroll
      for (int j = 0; j < W::width(l); ++j) x[off + j] = a.in[l][r * W::width(l) + j];
      off += W::width(l);
    }
    if (u_in != nullptr) {
#pragma unroll
      for (int i = 0; i < W::kA; ++i) u0[i] = u_in[i];
    }
  }

  // whether the cycle writes the histories: a counter whose row is in them
  __device__ __forceinline__ bool hist(const AdvanceArgs& a) const {
    return a.xs != nullptr && row >= 0 && row < a.n_hist;
  }

  __device__ __forceinline__ void run(const AdvanceArgs& a, int r) {
    constexpr int S = W::kS, A = W::kA;
    float u[A];
#pragma unroll
    for (int i = 0; i < A; ++i) u[i] = u0[i];
    if (!(t >= w.end)) {  // World.advance holds a state at or past sim_end
      w.clamp_u(u);
      for (int s = 0; s < a.steps; ++s) {
        w.step(x, u);
        t = add(t, w.h);
      }
    }
    int off = 0;
#pragma unroll
    for (int l = 0; l < W::kLeaves; ++l) {
#pragma unroll
      for (int j = 0; j < W::width(l); ++j) a.out[l][r * W::width(l) + j] = x[off + j];
      off += W::width(l);
    }
    if (a.per_robot_clock) a.time_out[r] = t;
    if (a.x_out != nullptr) {
#pragma unroll
      for (int i = 0; i < S; ++i) a.x_out[r * S + i] = x[i];
    }
    if (hist(a)) {
      float* xr = a.xs + ((row + 1) * a.R + r) * S;
#pragma unroll
      for (int i = 0; i < S; ++i) xr[i] = x[i];
      float* ur = a.us + (row * a.R + r) * A;
#pragma unroll
      for (int i = 0; i < A; ++i) ur[i] = u0[i];
      if (a.per_robot_clock) a.ts[row * a.R + r] = t;
    }
  }

  // after every robot's `run`, by one thread: the shared clock (any robot's
  // t is the fleet's after the cycle), its history row, and the counter
  __device__ __forceinline__ void finish(const AdvanceArgs& a) const {
    if (!a.per_robot_clock) {
      a.time_out[0] = t;
      if (hist(a)) a.ts[row] = t;
    }
    if (a.tick) *a.step_ptr = row + 1;  // the episode's next control step
  }

  // The cycle of a launch that steps one robot (R = 1; the sharded
  // controller's tail, sharded_combine.cu), loaded without its action, under
  // the action `u_in`: run's arithmetic and stores, then the clock, its
  // history row and the counter's advance, which finish leaves to one thread
  // after every robot's run: with one robot there is none to wait for. The
  // floats are run's and finish's at R = 1, its clock shared or its own (the
  // same one float). Its stores are addressed for the one robot: with run's
  // and finish's, K9's point-mass instances took 0.12-0.15 µs longer per
  // episode cycle on an H100 (PERF.md §6).
  __device__ __forceinline__ void run_alone(const AdvanceArgs& a, const float* u_in) {
    constexpr int S = W::kS, A = W::kA;
    float u[A];
#pragma unroll
    for (int i = 0; i < A; ++i) u[i] = u0[i] = u_in[i];
    if (!(t >= w.end)) {  // World.advance holds a state at or past sim_end
      w.clamp_u(u);
      for (int s = 0; s < a.steps; ++s) {
        w.step(x, u);
        t = add(t, w.h);
      }
    }
    int off = 0;
#pragma unroll
    for (int l = 0; l < W::kLeaves; ++l) {
#pragma unroll
      for (int j = 0; j < W::width(l); ++j) a.out[l][j] = x[off + j];
      off += W::width(l);
    }
    a.time_out[0] = t;
    if (a.x_out != nullptr) {
#pragma unroll
      for (int i = 0; i < S; ++i) a.x_out[i] = x[i];
    }
    if (a.xs != nullptr && row >= 0 && row < a.n_hist) {
#pragma unroll
      for (int i = 0; i < S; ++i) a.xs[(row + 1) * S + i] = x[i];
#pragma unroll
      for (int i = 0; i < A; ++i) a.us[row * A + i] = u0[i];
      a.ts[row] = t;
    }
    if (a.tick) *a.step_ptr = row + 1;  // the episode's next control step
  }
};

// Robot r's control cycle in one thread of a launch that also ran the
// solve's tail (K2's epilogue in combine_tail.cu), under the action `u` it
// holds, at the row the counter holds; then its ticket (tickets[R], zero,
// left zero): the last robot to finish writes the shared clock and advances
// the counter, after every robot has read both.
template <class W>
__device__ __forceinline__ void step_world(const AdvanceArgs& a, int r, const float* u,
                                           int* tickets) {
  Robot<W> robot;
  robot.load(a, r, u);
  robot.run(a, r);
  __threadfence();  // robot r has read the clock and the counter and written its rows
  if (atomicAdd(tickets + a.R, 1) != a.R - 1) return;
  tickets[a.R] = 0;
  robot.finish(a);
}

}  // namespace world
}  // namespace
