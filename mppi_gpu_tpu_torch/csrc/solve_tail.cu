// K7 solve_tail: the tail of one MPPI update for R robots in one launch,
// bound to Python with ctypes (mppi_gpu_tpu_torch/ops/_build.py,
// ops/solve_tail.py).
//
// It replaces, on a CUDA device, the torch operations of the controller's
// tail (controller._finish / _finish_fused): u_new = U + ΔU, the clamp to
// ±max_a, the action u_new[0], the receding-horizon shift with the last
// action repeated, and the softmin weights exp(−(S − β)/λ)/η over K. On the
// TPU there is no Pallas kernel for it: XLA fuses the same elementwise
// operations into the jitted solve (mppi_gpu_tpu/controller.py:504, 522-531;
// solve_from_costs :261-268), and drops the weights where nothing reads them
// (the device episode, mppi_gpu_tpu/runner.py:375-383). This kernel stands
// for that fusion; each output is written only where the caller passes its
// pointer.
//
// The work is a few hundred floats per robot (T·A ≤ 3000 on every config)
// and 8 bytes per rollout for the weights: at the flagship (R = 1, T = 200,
// A = 3, K = 10⁴) about 90 KB, some 0.03 µs of the card's 3.35 TB/s. So the
// kernel is bound by its launch and its latency, not by bytes or operations.
// Its grid is (1 + ⌈K/w⌉, R) with weights, (1, R) without, for blocks of w
// threads: block 0 of row r runs robot r's sequence, the others its
// weights, w rollouts each, so a launch does all of a solve's tail at once.
// Block 0 reads the robot's whole U + ΔU into shared memory before it writes
// anything, and no other block touches that robot's sequence, so the
// shifted sequence may be written over U itself (the device episode shifts
// its nominal sequence in place).
//
// For its latency, block 0 stages the row in rounds of w entries, one per
// thread, and issues every load of a round (U, ΔU and the entry's bound
// max_a[i % A], each read once) before the arithmetic that uses it. The
// block width makes every config's row one round: w = 1024 for a row of
// more than 256 entries (the flagship's T·A = 600: one round trip to memory
// where a strided loop of 256 threads took three; a longer row, up to the
// 58112-float limit, one per 1024 entries), w = 256 for a row that fits in
// 256 (the configs' 60-240, point_mass2d's 100), which one round of 1024
// threads would stage no sooner and whose wider blocks cost 0.06-0.13 µs
// more per launch on an H100 (PERF.md §6). The weights blocks take w
// rollouts each, one per thread.
//
// The arithmetic is the torch ops', each rounded once alike (never
// contracted into an FMA): the row's add and clamp (solve_tail.cuh's clampf,
// as K2''s epilogue's); the weights are the sub, the neg, the division by
// the Python float λ, which torch's CUDA division by a CPU scalar computes as
// a product with the double reciprocal 1/λ rounded once to float32 (the
// wrapper passes that factor, ops/_rounding.scalar_reciprocal, so the
// product here is __fmul_rn), expf at full precision (no fast math), and the
// true division by the device scalar η (__fdiv_rn).

#include "solve_tail.cuh"

namespace {

// a block's threads, one entry of the row each per round: the row's entries
// per round trip to memory; the small blocks take rows that fit in them
constexpr int kThreads = 1024;
constexpr int kSmallThreads = 256;

struct TailArgs {
  tail::RowArgs row;   // U, ΔU, max_a, u_seq, u_next, action
  const float* S;      // (R, K)
  const float* beta;   // robot r's at beta + r·beta_stride
  const float* eta;    // robot r's at eta + r·eta_stride
  float* weights;      // (R, K) or null
  int beta_stride, eta_stride, K;
  float inv_lam;       // float32(1/λ)
};

// Robot r's u_new = U + ΔU, clamped, into `row` (T·A floats of shared
// memory), a round of THREADS entries at a time, each round's loads (U, ΔU
// and the entry's bound) issued before its arithmetic: the first round
// straight, the rest (a row longer than the block) in a loop; then, the
// whole row read, its outputs.
template <int THREADS>
__device__ __forceinline__ void tail_row(const tail::RowArgs& a, int r, float* row) {
  const int n = a.T * a.A;
  const long long base = (long long)r * n;
  const float* U = a.U + base;
  const float* dU = a.dU + base;
  auto stage = [&](int i) {
    const float u = U[i], d = dU[i];
    const float m = a.clamp ? a.max_a[i % a.A] : 0.0f;
    float v = __fadd_rn(u, d);
    if (a.clamp) v = tail::clampf(v, -m, m);
    row[i] = v;
  };
  if ((int)threadIdx.x < n) stage(threadIdx.x);
  for (int i = threadIdx.x + THREADS; i < n; i += THREADS) stage(i);
  __syncthreads();  // the whole row is read before any of it is written (u_next may be U)
  for (int i = threadIdx.x; i < n; i += THREADS) {
    if (a.u_seq != nullptr) a.u_seq[base + i] = row[i];
    // u_next[t] = u_new[t + 1], the last step's action repeated
    if (a.u_next != nullptr) a.u_next[base + i] = row[i + a.A < n ? i + a.A : i];
    if (a.action != nullptr && i < a.A) a.action[(long long)r * a.A + i] = row[i];
  }
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) solve_tail_kernel(const TailArgs a) {
  const int r = blockIdx.y;
  if (blockIdx.x > 0) {  // the weights of rollouts (blockIdx.x − 1)·THREADS + threadIdx.x
    const int k = (blockIdx.x - 1) * THREADS + threadIdx.x;
    if (k < a.K) {
      const long long i = (long long)r * a.K + k;
      const float d = __fsub_rn(a.S[i], a.beta[(long long)r * a.beta_stride]);
      const float e = expf(__fmul_rn(-d, a.inv_lam));
      a.weights[i] = __fdiv_rn(e, a.eta[(long long)r * a.eta_stride]);
    }
    return;
  }
  extern __shared__ float row[];  // robot r's u_new, T·A floats
  tail_row<THREADS>(a.row, r, row);
}

template <int THREADS>
int launch(const TailArgs& a, int R, long long row_bytes, cudaStream_t stream) {
  if (row_bytes > 48 * 1024) {  // past the default, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        solve_tail_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(1 + (a.weights != nullptr ? (a.K + THREADS - 1) / THREADS : 0), R);
  solve_tail_kernel<THREADS><<<grid, THREADS, (size_t)row_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: for R robots, u_new = U + ΔU (clamped to ±max_a when `clamp`), then
// u_seq = u_new, u_next = u_new shifted by one step with the last repeated,
// action = u_new[0] (R, A), and, with `weights` non-null, weights[r, k] =
// expf(−(S[r, k] − β_r)·inv_lam) / η_r over K (inv_lam: float32(1/λ)); a
// null output is not written. u_next may be U (in place); no other output
// may overlap an input. Refuses
// (cudaErrorInvalidValue) R outside [1, 65535], T, A or K below 1 (K only
// with weights), and a row of more than 227 KB (T·A > 58112 floats): the row
// is staged in shared memory, and there is no other path.
int mppi_solve_tail(const float* U, const float* dU, const float* max_a, int clamp,
                    float* u_seq, float* u_next, float* action, const float* S,
                    const float* beta, int beta_stride, const float* eta, int eta_stride,
                    float inv_lam, float* weights, int R, int T, int A, int K, void* stream) {
  if (R < 1 || R > tail::kMaxRobots || T < 1 || A < 1 || (weights != nullptr && K < 1))
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)T * A * (long long)sizeof(float);
  if (row_bytes > tail::kMaxRowBytes) return (int)cudaErrorInvalidValue;
  TailArgs a{};
  a.row = tail::RowArgs{U, dU, max_a, u_seq, u_next, action, clamp, T, A};
  a.S = S;
  a.beta = beta;
  a.eta = eta;
  a.weights = weights;
  a.beta_stride = beta_stride;
  a.eta_stride = eta_stride;
  a.K = weights != nullptr ? K : 0;
  a.inv_lam = inv_lam;
  const cudaStream_t s = (cudaStream_t)stream;
  return T * A > kSmallThreads ? launch<kThreads>(a, R, row_bytes, s)
                               : launch<kSmallThreads>(a, R, row_bytes, s);
}

}  // extern "C"
