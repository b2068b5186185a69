// K6 world_advance: one control cycle of a ground-truth world for R robots in
// one launch, bound to Python with ctypes (mppi_gpu_tpu_torch/ops/_build.py,
// ops/world_step.py). In the device episode the same launch also writes the
// cycle's next x and advances the control-step counter.
//
// It replaces, on a CUDA device, the torch operations of `World.advance`
// (envs/base.py): steps_per_control RK4 steps of the world's physics_step,
// each with its post-step rules, then the hold of a robot whose clock was at
// or past sim_end before the cycle. On the TPU there is no Pallas kernel for
// it: under lax.scan XLA fuses the JAX world's `simulate`
// (mppi_gpu_tpu/runner.py:375-383, mppi_gpu_tpu/envs/*_world.py), and this
// kernel stands for that fusion in the port's device episode
// (runner.EpisodeCycle), where the unfused cycle ran 100-1100 elementwise
// kernels of ~1.2 µs each.
//
// One thread per robot carries its state in registers through the cycle
// (world_step.cuh: the world bodies and one robot's cycle, `Robot`, which
// K2's epilogue in combine_tail.cu and K9 in sharded_combine.cu run too).
// The work is a few hundred to a few thousand float operations per robot
// (R ≤ 64 on the episode paths), far under a microsecond of the card at any
// rate: the kernel is bound by its own latency (launch, the loads' round
// trips, the dependent chain of one robot's RK4 stages), not by bytes or
// operations. So it is one block of up to 1024 threads, robots r, r +
// blockDim, … per thread; the one block also lets a clock shared by a fleet
// (a 0-dim time) be read by every robot and written once after a barrier, so
// the state may be updated in place. For its latency:
// - a robot's loads (the pack, the counter, the clock, the state leaves and
//   the held action) sit together at the start of its cycle (`Robot::load`),
//   none behind another's arithmetic. The compiler issues the pack fields
//   that only the stepping reads after the hold's test on the clock; reading
//   the pack once ahead of the robots' loop, which keeps every load ahead of
//   that test, measured up to 0.26 µs slower on 8 of the 10 worlds (0.14
//   faster on the planar quadrotor) on an H100 (PERF.md §6);
// - the chain of each RK4 stage is shortened only where the float stays the
//   same for every input: the arm's inverse determinant by the correctly
//   rounded reciprocal (`rcp`) in place of the division 1/x, and sinf and
//   cosf of one argument from one `sincosf` (`sin_cos`), each held over all
//   2³² inputs by mppi_world_identities below.
//
// The arithmetic repeats the plain version's float32 operations in their
// order, each rounded once as the torch op is (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn: never contracted into an FMA): a Python-scalar
// constant is packed as torch rounds it (0.5·h, h/6 and products of
// parameters computed in double, then rounded to float32; `x / c` by a
// Python scalar c is x · float32(1/c), the double reciprocal rounded once,
// as torch's CUDA division by a CPU scalar computes it, packed through
// ops/_rounding.scalar_reciprocal); x**2 is x·x; 1.0 / x, which torch
// computes as reciprocal(x)·1.0, is rcp(x); sinf, cosf and rsqrtf at full
// precision (no fast math); clamp, minimum and maximum pass NaN through as
// torch's do, so a diverged state stays NaN (utils/guard.py). The 3-D
// quadrotor's quaternion norm adds its squares as torch.sum over the last
// dim of a (…, 4) tensor does on the card: (q0² + q2²) + (q1² + q3²).
//
// The packed parameters of each world, in order (ops/world_step.py packs
// them from the world's params dataclass, the first four from its cadence;
// tests/test_torch_world_step.py reads these lines):
// @pack point_mass: timestep half_step sixth_step sim_end ctrl_range gear damping inv_mass joint_range
// @pack pendulum: timestep half_step sixth_step sim_end max_torque g_over_l inv_ml2 damping
// @pack cartpole: timestep half_step sixth_step sim_end max_force inv_total ml gravity pole_length four_thirds pole_mass track_limit
// @pack unicycle: timestep half_step sixth_step sim_end max_v max_w
// @pack quadrotor: timestep half_step sixth_step sim_end max_thrust inv_mass gravity arm inv_inertia
// @pack quadrotor3d: timestep half_step sixth_step sim_end max_thrust inv_two_arm inv_four_kappa arm kappa inv_mass gravity jzy jxz jyx inv_jx inv_jy inv_jz
// @pack arm: timestep half_step sixth_step sim_end max_t1 max_t2 A B D G1 G2 damping max_rate

#include "world_step.cuh"

namespace {

using namespace world;

template <class W>
__global__ void __launch_bounds__(kMaxThreads) world_advance_kernel(const AdvanceArgs a) {
  // a thread's robots r, r + blockDim, …: each one's loads issued together
  // as its cycle starts (the first's at the kernel's start), its arithmetic
  // after them
  Robot<W> robot;
  for (int r = threadIdx.x; r < a.R; r += blockDim.x) {
    robot.load(a, r, a.u + r * a.u_stride);
    robot.run(a, r);
  }
  if (!a.per_robot_clock || a.tick) {
    __syncthreads();  // every robot has read the shared clock and the counter
    // thread 0 ran robot 0, so its t is the fleet's clock after the cycle
    if (threadIdx.x == 0) robot.finish(a);
  }
}

template <class W>
int launch(const AdvanceArgs& a, int n_leaves, int n_params, int A, cudaStream_t stream) {
  if (n_leaves != W::kLeaves || n_params != W::kParams || A != W::kA) return (int)cudaErrorInvalidValue;
  const int threads = a.R < kMaxThreads ? ((a.R + 31) / 32) * 32 : kMaxThreads;
  world_advance_kernel<W><<<1, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// Over every float x (its 2³² bit patterns, grid-strided): whether rcp(x)
// differs in bits from __fdiv_rn(1, x), and sin_cos(x)'s sine and cosine from
// sinf(x) and cosf(x); counts[k] += the inputs that differ, first[k] = the
// smallest such bit pattern (k: 0 rcp, 1 sine, 2 cosine).
__global__ void world_identities_kernel(unsigned long long* counts, unsigned* first) {
  const unsigned lane = threadIdx.x % 32;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    const float x = __uint_as_float((unsigned)i);
    float s, c;
    sin_cos(x, &s, &c);
    const bool differ[3] = {__float_as_uint(rcp(x)) != __float_as_uint(dvd(1.0f, x)),
                            __float_as_uint(s) != __float_as_uint(sinf(x)),
                            __float_as_uint(c) != __float_as_uint(cosf(x))};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // every lane of a warp runs the same pass, lane j on input i − lane + j
      const unsigned mask = __ballot_sync(0xffffffffu, differ[k]);
      if (mask != 0 && lane == 0) {
        atomicAdd(counts + k, (unsigned long long)__popc(mask));
        atomicMin(first + k, (unsigned)i + __ffs(mask) - 1);
      }
    }
  }
}

template <class W>
int layout(int* widths, int* n_params, int* A) {
  for (int l = 0; l < W::kLeaves; ++l) widths[l] = W::width(l);
  *n_params = W::kParams;
  *A = W::kA;
  return W::kLeaves;
}

}  // namespace

extern "C" {

// The layout world `world` (WorldId) is built for: its leaves' widths into
// `widths` (kMaxLeaves ints), its packed parameters' count and its action
// dim; returns its number of state leaves, or -1 for an unknown world. The
// wrapper holds these against its own at load.
int mppi_world_layout(int world, int* widths, int* n_params, int* action_dim) {
  switch (world) {
    case kPointMass1: return layout<PointMass<1>>(widths, n_params, action_dim);
    case kPointMass2: return layout<PointMass<2>>(widths, n_params, action_dim);
    case kPointMass3: return layout<PointMass<3>>(widths, n_params, action_dim);
    case kPendulum: return layout<Pendulum>(widths, n_params, action_dim);
    case kCartPole: return layout<CartPole>(widths, n_params, action_dim);
    case kUnicycle: return layout<Unicycle>(widths, n_params, action_dim);
    case kQuadrotor: return layout<Quadrotor>(widths, n_params, action_dim);
    case kQuadrotor3D: return layout<Quadrotor3D>(widths, n_params, action_dim);
    case kArm: return layout<Arm>(widths, n_params, action_dim);
    default: return -1;
  }
}

// K6: one control cycle (`steps` physics steps) of world `world` for R
// robots. in / out: n_leaves pointers each, the state leaves (R, width)
// float32 (out may be in: in place); time_in / time_out: the clock, shared
// (per_robot_clock 0, one float) or (R,); u: (R, A), robot r's A floats at
// u + r·u_stride (a fleet's action is a column of its sequences); params:
// n_params floats. With xs
// non-null and a row = *step_ptr in [0, n_hist): xs[row + 1] = the new x
// (R, S), us[row] = u, ts[row] = the new clock ((R,) per robot). With x_out
// non-null, x_out = the new x (R, S) as well (the device episode's next
// solve reads it); with `tick`, *step_ptr = row + 1 once every robot is
// done (the episode's counter advanced in the same launch). Refuses
// (cudaErrorInvalidValue) another leaf count, pack length or action dim than
// the world's, R outside [1, 65535], steps < 0, or `tick` without step_ptr.
int mppi_world_advance(int world, const void* const* in, void* const* out, int n_leaves,
                       const float* time_in, float* time_out, int per_robot_clock,
                       const float* u, int u_stride, int A, const float* params, int n_params,
                       int R, int steps, float* xs, float* us, float* ts, int n_hist,
                       long long* step_ptr, float* x_out, int tick, void* stream) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || R < 1 || R > 65535 || steps < 0 || u_stride < A
      || (tick && step_ptr == nullptr))
    return (int)cudaErrorInvalidValue;
  AdvanceArgs a{};
  for (int l = 0; l < n_leaves; ++l) {
    a.in[l] = static_cast<const float*>(in[l]);
    a.out[l] = static_cast<float*>(out[l]);
  }
  a.time_in = time_in;
  a.time_out = time_out;
  a.u = u;
  a.u_stride = u_stride;
  a.params = params;
  a.xs = xs;
  a.us = us;
  a.ts = ts;
  a.step_ptr = step_ptr;
  a.x_out = x_out;
  a.tick = tick;
  a.R = R;
  a.per_robot_clock = per_robot_clock;
  a.steps = steps;
  a.n_hist = n_hist;
  cudaStream_t s = (cudaStream_t)stream;
  switch (world) {
    case kPointMass1: return launch<PointMass<1>>(a, n_leaves, n_params, A, s);
    case kPointMass2: return launch<PointMass<2>>(a, n_leaves, n_params, A, s);
    case kPointMass3: return launch<PointMass<3>>(a, n_leaves, n_params, A, s);
    case kPendulum: return launch<Pendulum>(a, n_leaves, n_params, A, s);
    case kCartPole: return launch<CartPole>(a, n_leaves, n_params, A, s);
    case kUnicycle: return launch<Unicycle>(a, n_leaves, n_params, A, s);
    case kQuadrotor: return launch<Quadrotor>(a, n_leaves, n_params, A, s);
    case kQuadrotor3D: return launch<Quadrotor3D>(a, n_leaves, n_params, A, s);
    case kArm: return launch<Arm>(a, n_leaves, n_params, A, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The substitutions of world_step.cuh over all 2³² float inputs: counts[3]
// (zeros) += the inputs where rcp, sin_cos's sine and its cosine differ in
// bits from __fdiv_rn(1, x), sinf and cosf; first[3] (0xffffffff) = the
// smallest bit pattern of each that differs.
int mppi_world_identities(unsigned long long* counts, unsigned* first, void* stream) {
  world_identities_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(counts, first);
  return (int)cudaGetLastError();
}

}  // extern "C"
