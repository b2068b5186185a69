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
// Its grid is (1 + ⌈K/256⌉, R) with weights, (1, R) without: block 0 of row r
// runs robot r's sequence, the others its weights, 256 rollouts each, so a
// launch does all of a solve's tail at once. Block 0 reads the robot's whole
// U + ΔU into shared memory before it writes anything, and no other block
// touches that robot's sequence, so the shifted sequence may be written over
// U itself (the device episode shifts its nominal sequence in place).
//
// The arithmetic is the torch ops', each rounded once alike (never
// contracted into an FMA): the row's (solve_tail.cuh, shared with K2's
// epilogue); the weights are the sub, the neg, the division by the Python
// float λ, which torch's CUDA division by a CPU scalar computes as a product
// with the double reciprocal 1/λ rounded once to float32 (the wrapper passes
// that factor, ops/_rounding.scalar_reciprocal, so the product here is
// __fmul_rn), expf at full precision (no fast math), and the true division
// by the device scalar η (__fdiv_rn).

#include "solve_tail.cuh"

namespace {

constexpr int kThreads = 256;

struct TailArgs {
  tail::RowArgs row;   // U, ΔU, max_a, u_seq, u_next, action
  const float* S;      // (R, K)
  const float* beta;   // robot r's at beta + r·beta_stride
  const float* eta;    // robot r's at eta + r·eta_stride
  float* weights;      // (R, K) or null
  int beta_stride, eta_stride, K;
  float inv_lam;       // float32(1/λ)
};

__global__ void __launch_bounds__(kThreads) solve_tail_kernel(const TailArgs a) {
  const int r = blockIdx.y;
  if (blockIdx.x > 0) {  // the weights of rollouts (blockIdx.x − 1)·256 + threadIdx.x
    const int k = (blockIdx.x - 1) * kThreads + threadIdx.x;
    if (k < a.K) {
      const long long i = (long long)r * a.K + k;
      const float d = __fsub_rn(a.S[i], a.beta[(long long)r * a.beta_stride]);
      const float e = expf(__fmul_rn(-d, a.inv_lam));
      a.weights[i] = __fdiv_rn(e, a.eta[(long long)r * a.eta_stride]);
    }
    return;
  }
  extern __shared__ float row[];  // robot r's u_new, T·A floats
  tail::row_body<false>(a.row, r, row);
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
  if (row_bytes > 48 * 1024) {  // past the default, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        solve_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_bytes);
    if (err != cudaSuccess) return (int)err;
  }
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
  const dim3 grid(1 + (weights != nullptr ? (K + kThreads - 1) / kThreads : 0), R);
  solve_tail_kernel<<<grid, kThreads, (size_t)row_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
