// K2' combine_tail: K2's fold with the solve's tail as its epilogue and, in
// the device episode's last update, the world's control cycle, for R robots
// in one launch; bound to Python with ctypes (mppi_gpu_tpu_torch/ops/_build.py,
// ops/combine_tail.py).
//
// It replaces no Pallas kernel of its own. On the TPU, XLA fuses the jitted
// solve's tail and the JAX world's simulate into the episode's program
// (mppi_gpu_tpu/controller.py:504, 522-531; mppi_gpu_tpu/runner.py:375-383).
// The port first stood for that fusion with two kernels of their own, K7
// (solve_tail.cu) and K6 (world_step.cu), which took 1.4-3.1 and 1.8-5.3 µs
// of device time per graph cycle. Neither is bound by its bytes or its
// operations (their bounds are 1e-8 to 2e-4 ms): each is bound by its launch
// and its serial latency. Both read only what K2 has just produced for the
// same robot: K7 its ΔU, K6 the action K7 computes from it. So here their
// work has no launch of its own.
//
// Design: K2's fold (softmin_combine.cuh) in one of its two forms, a
// function of nb and T·A alone (ops/fused_solve.combine_one_block; K2 alone
// always takes the tiles). In the tiled form, grid (column tiles, R), every block then
// fences its ΔU columns and takes a ticket from robot r's counter; the last
// of the robot's tiles to finish reads the robot's whole ΔU row from L2. In
// the one-block form, grid (1, R), the block holds the robot's whole ΔU in
// shared memory already: no fence, no ticket, no reload. Either runs K7's
// row body (solve_tail.cuh: U + ΔU, the clamp, u_seq, or the shift in place
// and the action). With a world body (world_step.cuh), its thread 0 then
// steps robot r's world under the action it holds in shared memory, as K6
// does: the state, the clock, the histories at the counter's row and the
// next x. The robot then takes a second ticket; the last robot to finish
// writes a fleet's shared clock and advances the counter, after every robot
// has read both.
// The last blocks reset their counters to 0, so a graph's every replay
// starts clean. The tickets are R + 1 int32 the caller holds (zeros).
//
// The arithmetic, its order and each rounding are the standalone kernels'
// (the same device functions): the outputs are bit-equal to K2, K7 and K6
// launched one after the other. The row body's loads stay one round trip
// per 256 entries: hoisting them all ahead (every load in flight at once)
// took the flagship's K2' from 6.2 to 5.2-5.5 µs, but lengthened the
// kernels that step a world (K2'<Arm> 9.6 → 11.3 µs per launch in the
// episode; PERF.md §6), so K2' keeps the strided row body, and K7, which
// steps no world, stages its row with loads of its own.

#include <type_traits>

#include "softmin_combine.cuh"
#include "solve_tail.cuh"
#include "world_step.cuh"

namespace {

struct NoWorld {};  // the tail alone: an inner opt iteration, or no K6 body

struct EpilogueArgs {
  tail::RowArgs row;   // U, ΔU (K2's output), max_a, u_seq, u_next, action
  world::AdvanceArgs adv;  // its u unused: the action is the row's first A floats
  int* tickets;        // (R + 1,): one per robot, then one for the robots' world steps
};

template <class W>
__global__ void __launch_bounds__(kCombineThreads) combine_tail_kernel(
    const float* __restrict__ partials, int nb, int TA, float lam, int one_block,
    float* __restrict__ beta_eta, float* __restrict__ dU, const EpilogueArgs e) {
  const int r = blockIdx.y;
  extern __shared__ float row[];  // robot r's u_new, T·A floats, once the fold is done
  if (one_block) {
    const float* d = combine_block(partials, nb, TA, lam, 1, beta_eta, dU);
    __syncthreads();  // ΔU complete; the partials' copy free for the row
    tail::row_body_of(e.row, r, row, [&](long long, int i) { return d[i]; });
  } else {
    combine_tile(partials, nb, TA, lam, 1, beta_eta, dU);
    __shared__ int last;
    __threadfence();  // this block's ΔU columns reach L2 before its ticket
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(e.tickets + r, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x == 0) e.tickets[r] = 0;  // every tile of robot r has taken its ticket
    // ΔU from L2: the other tiles of this launch wrote it
    tail::row_body(e.row, r, row);
  }
  if constexpr (!std::is_same<W, NoWorld>::value) {
    if (threadIdx.x == 0) world::step_world<W>(e.adv, r, row, e.tickets);
  }
}

template <class W>
int launch(const float* partials, int nb, int TA, float lam, int one_block, float* beta_eta,
           float* dU, const EpilogueArgs& e, int R, size_t smem, cudaStream_t stream) {
  const cudaError_t err = set_smem(combine_tail_kernel<W>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(one_block ? 1 : (TA + kCombineCols - 1) / kCombineCols, R);
  combine_tail_kernel<W><<<grid, kCombineThreads, smem, stream>>>(partials, nb, TA, lam,
                                                                  one_block, beta_eta, dU, e);
  return (int)cudaGetLastError();
}

template <class W>
bool fits(int n_leaves, int n_params, int A) {
  return n_leaves == W::kLeaves && n_params == W::kParams && A == W::kA;
}

}  // namespace

extern "C" {

// K2': for R robots, K2's fold of partials (R, nb, 2 + T·A) into beta_eta
// (R, 2) and dU (R, T, A), divided by η; then K7's row body for each robot
// (u_new = U + ΔU, clamped to ±max_a when `clamp`; u_seq = u_new, u_next =
// u_new shifted with the last repeated (may be U: in place), action =
// u_new[0] (R, A); a null output is not written); then, with `world_id` >= 0
// (world_step.cuh's WorldId), K6's cycle of that world for each robot under
// its action, as mppi_world_advance with `tick` and step_ptr: in / out the
// state leaves (out may be in), the clock shared (per_robot_clock 0) or
// (R,), xs[row + 1], us[row], ts[row] at row = *step_ptr when row is in
// [0, n_hist), x_out = the new x, and *step_ptr = row + 1 once every robot
// is done. The fold runs in one block per robot when `one_block`, else in
// K2's column tiles (ops/fused_solve.combine_one_block picks).
// tickets: R + 1 int32, zero, left zero. Refuses (cudaErrorInvalidValue) R
// outside [1, 65535], nb, T or A below 1, a row of more than 227 KB, a form
// whose shared memory exceeds a block's, null tickets, and with a world
// another leaf count, pack length or action dim than the world's, steps < 0,
// or a null step_ptr.
int mppi_combine_tail(const float* partials, int R, int nb, int T, int A, float lam,
                      float* beta_eta, float* dU, const float* U, const float* max_a, int clamp,
                      float* u_seq, float* u_next, float* action, int* tickets, int world_id,
                      const void* const* in, void* const* out, int n_leaves,
                      const float* time_in, float* time_out, int per_robot_clock,
                      const float* params, int n_params, int steps, float* xs, float* us,
                      float* ts, int n_hist, long long* step_ptr, float* x_out, int one_block,
                      void* stream) {
  const int TA = T * A;
  if (R < 1 || R > kMaxRobots || nb < 1 || T < 1 || A < 1 || tickets == nullptr)
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)TA * (long long)sizeof(float);
  if (row_bytes > tail::kMaxRowBytes) return (int)cudaErrorInvalidValue;
  const size_t fold = fold_smem_bytes(nb, TA, one_block);
  const size_t smem = fold > (size_t)row_bytes ? fold : (size_t)row_bytes;
  if (smem > kCombineSmemFloats * sizeof(float)) return (int)cudaErrorInvalidValue;
  EpilogueArgs e{};
  e.row = tail::RowArgs{U, dU, max_a, u_seq, u_next, action, clamp, T, A};
  e.tickets = tickets;
  cudaStream_t s = (cudaStream_t)stream;
  if (world_id < 0)
    return launch<NoWorld>(partials, nb, TA, lam, one_block, beta_eta, dU, e, R, smem, s);
  if (n_leaves < 1 || n_leaves > world::kMaxLeaves || steps < 0 || step_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  world::AdvanceArgs& a = e.adv;
  for (int l = 0; l < n_leaves; ++l) {
    a.in[l] = static_cast<const float*>(in[l]);
    a.out[l] = static_cast<float*>(out[l]);
  }
  a.time_in = time_in;
  a.time_out = time_out;
  a.params = params;
  a.xs = xs;
  a.us = us;
  a.ts = ts;
  a.step_ptr = step_ptr;
  a.x_out = x_out;
  a.tick = 1;
  a.R = R;
  a.per_robot_clock = per_robot_clock;
  a.steps = steps;
  a.n_hist = n_hist;
#define WORLD_CASE(id, W)                                                                  \
  case world::id:                                                                          \
    return fits<world::W>(n_leaves, n_params, A)                                           \
               ? launch<world::W>(partials, nb, TA, lam, one_block, beta_eta, dU, e, R,    \
                                  smem, s)                                                 \
               : (int)cudaErrorInvalidValue;
  switch (world_id) {
    WORLD_CASE(kPointMass1, PointMass<1>)
    WORLD_CASE(kPointMass2, PointMass<2>)
    WORLD_CASE(kPointMass3, PointMass<3>)
    WORLD_CASE(kPendulum, Pendulum)
    WORLD_CASE(kCartPole, CartPole)
    WORLD_CASE(kUnicycle, Unicycle)
    WORLD_CASE(kQuadrotor, Quadrotor)
    WORLD_CASE(kQuadrotor3D, Quadrotor3D)
    WORLD_CASE(kArm, Arm)
    default: return (int)cudaErrorInvalidValue;
  }
#undef WORLD_CASE
}

}  // extern "C"
