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
// contracted into an FMA): U + ΔU with __fadd_rn; torch.clamp with tensor
// bounds passes NaN and is otherwise min(max(v, −m), m); the weights are the
// sub, the neg, the division by the Python float λ, which torch's CUDA
// division by a CPU scalar computes as a product with the float32 reciprocal
// 1.0f/λ (its BinaryDivTrueKernel; the wrapper passes that reciprocal, so the
// product here is __fmul_rn), expf at full precision (no fast math), and the
// true division by the device scalar η (__fdiv_rn).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRobots = 65535;
// the shared memory a block can have on Hopper (227 KB), the row's bound
constexpr int kMaxRowBytes = 232448;

struct TailArgs {
  const float* U;      // (R, T, A)
  const float* dU;     // (R, T, A)
  const float* max_a;  // (A,)
  float* u_seq;        // (R, T, A) or null
  float* u_next;       // (R, T, A) or null; may be U (in place)
  float* action;       // (R, A) or null
  const float* S;      // (R, K)
  const float* beta;   // robot r's at beta + r·beta_stride
  const float* eta;    // robot r's at eta + r·eta_stride
  float* weights;      // (R, K) or null
  int beta_stride, eta_stride, clamp, T, A, K;
  float inv_lam;       // 1.0f / (float)λ
};

// torch.clamp(v, lo, hi) on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

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
  const int n = a.T * a.A;
  const long long base = (long long)r * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = __fadd_rn(a.U[base + i], a.dU[base + i]);
    if (a.clamp) {
      const float m = a.max_a[i % a.A];
      v = clampf(v, -m, m);
    }
    row[i] = v;
  }
  __syncthreads();  // the whole row is read before any of it is written
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (a.u_seq != nullptr) a.u_seq[base + i] = row[i];
    // u_next[t] = u_new[t + 1], the last step's action repeated
    if (a.u_next != nullptr) a.u_next[base + i] = row[i + a.A < n ? i + a.A : i];
    if (a.action != nullptr && i < a.A) a.action[(long long)r * a.A + i] = row[i];
  }
}

}  // namespace

extern "C" {

// K7: for R robots, u_new = U + ΔU (clamped to ±max_a when `clamp`), then
// u_seq = u_new, u_next = u_new shifted by one step with the last repeated,
// action = u_new[0] (R, A), and, with `weights` non-null, weights[r, k] =
// expf(−(S[r, k] − β_r)·inv_lam) / η_r over K; a null output is not written.
// u_next may be U (in place); no other output may overlap an input. Refuses
// (cudaErrorInvalidValue) R outside [1, 65535], T, A or K below 1 (K only
// with weights), and a row of more than 227 KB (T·A > 58112 floats): the row
// is staged in shared memory, and there is no other path.
int mppi_solve_tail(const float* U, const float* dU, const float* max_a, int clamp,
                    float* u_seq, float* u_next, float* action, const float* S,
                    const float* beta, int beta_stride, const float* eta, int eta_stride,
                    float inv_lam, float* weights, int R, int T, int A, int K, void* stream) {
  if (R < 1 || R > kMaxRobots || T < 1 || A < 1 || (weights != nullptr && K < 1))
    return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)T * A * (long long)sizeof(float);
  if (row_bytes > kMaxRowBytes) return (int)cudaErrorInvalidValue;
  if (row_bytes > 48 * 1024) {  // past the default, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        solve_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)row_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  TailArgs a{};
  a.U = U;
  a.dU = dU;
  a.max_a = max_a;
  a.u_seq = u_seq;
  a.u_next = u_next;
  a.action = action;
  a.S = S;
  a.beta = beta;
  a.eta = eta;
  a.weights = weights;
  a.beta_stride = beta_stride;
  a.eta_stride = eta_stride;
  a.clamp = clamp;
  a.T = T;
  a.A = A;
  a.K = weights != nullptr ? K : 0;
  a.inv_lam = inv_lam;
  const dim3 grid(1 + (weights != nullptr ? (K + kThreads - 1) / kThreads : 0), R);
  solve_tail_kernel<<<grid, kThreads, (size_t)row_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
