// Hopper (sm_90a) kernels of the MPPI solve for the point-mass LTI family
// with the quadratic cost, bound to Python with ctypes
// (mppi_gpu_tpu_torch/ops/_build.py, ops/fused_solve.py).
//
//   K1 lti_solve_partials  rollout + cost + per-block softmin partial + ΔŨ
//   K2 softmin_combine     fold of the per-block partials into β, η, ΔU
//   K3 noise_dump          the ε stream K1 consumed, written as (T, K, A)
//
// One thread per rollout k carries its state in registers through a
// sequential loop over the horizon. K1 and K2 take a fleet of R independent
// robots in one launch: grid axis y of K1 and grid axis x of K2 is the robot
// r, which reads its own x0, U, goal, noise key and (injected) ε and writes
// its own S, partials, β, η and ΔU; σ, Σ⁻¹, the weights, dt, both λ, the
// counter words (step, it), antithetic and OU are shared. The single-robot
// solve is the R = 1 launch. The noise stream is Philox4x32-10 keyed
// by the seed, counter (k, t, step, it), with Box-Muller normals; its plain
// torch twin is ops/philox.py and the words must match it bit for bit. The
// noise, state-update and cost arithmetic uses explicitly rounded operations
// (__fmul_rn/__fadd_rn, never contracted into FMAs), in the plain version's
// order, so K3's dump reproduces K1's ε exactly and the replay of a dump
// through the injected-ε mode reproduces the Philox-mode solve. No
// fast-math flags.
//
// Rollouts past K (the idle threads of the last block) never enter β, η or
// ΔU. A block whose real rollouts all have S = +inf contributes η_b = 0 and
// ΔŨ_b = 0 (its weights are exactly 0 against any finite β); if every block
// is like that, K2's β is +inf and β − β_b = NaN reaches η and ΔU, so the
// action comes out NaN and the divergence guard fires, as on the eager path.

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

// Σ_j w_j (x_j − g_j)² over x = (q, qd), in the plain version's order.
template <int A>
__device__ __forceinline__ float state_cost(const float q[A], const float qd[A],
                                            const float wq[A], const float wqd[A],
                                            const float gq[A], const float gqd[A]) {
  float c = 0.0f;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float d = __fsub_rn(q[a], gq[a]);
    c = __fadd_rn(c, __fmul_rn(__fmul_rn(d, wq[a]), d));
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const float d = __fsub_rn(qd[a], gqd[a]);
    c = __fadd_rn(c, __fmul_rn(__fmul_rn(d, wqd[a]), d));
  }
  return c;
}

// K1. Replaces the TPU solve kernels of mppi_gpu_tpu/ops/pallas_rollout.py:
// _onepass_solve_kernel (:2342), _planar_onepass_kernel (:2686) and
// _fused_solve_kernel (:2287), LTI family (_LTIQuadFamily :490), and their
// fleet forms _fleet_onepass_solve_kernel (:3121), _fleet_fused_solve_kernel
// (:2973) and _planar_fleet_onepass_kernel (:3078), whose grid (R, tiles)
// runs the same per-tile bodies robot after robot.
//
// What bounds it: arithmetic, not memory. Per rollout and step it does one
// Philox call (10 rounds of two 32-bit multiply-high), one or two Box-Muller
// pairs (log1p, sqrt, cos, sin) and ~10 flops of dynamics and cost; the only
// traffic is U and the parameters (read once into shared memory/registers),
// S (4 B per rollout) and one (2 + T·A)-float partial per block. In the
// injected-ε mode it instead streams 2·T·A·4 B per rollout.
//
// Design: the TPU kernels stage the tile's ε in VMEM for the ΔU pass; here a
// thread's ε for a whole horizon does not fit in registers and staging it in
// shared memory would cap the block at a few rollouts, so pass 2
// regenerates ε from the counter (Philox is stateless), which costs a second
// round of noise arithmetic and no memory. The cross-tile online softmin of
// the TPU kernel, which relies on the grid running in order, becomes an
// associative per-block partial (β_b, η_b, ΔŨ_b) folded by K2, the same
// combine the sharded path uses across devices. Σ_k e_k ε_k[t, a] is a warp
// shuffle reduction per (t, a) into shared memory, summed over the warps in a
// fixed order.
//
// Fleet: block (b, r) is block b of robot r; robots run side by side on the
// SMs, not in turn as on the TPU. All robot offsets are size_t: at R = 64,
// K = 10⁵ the partials alone are 30 M floats, and an injected (R, T, K, A) ε
// passes 2³¹ elements. `keys` holds every robot's (R,) int64 seed, whose low
// and high words are its Philox key; null means every robot uses
// np.key0/np.key1, which is how the single-robot solve runs without a seed
// tensor on the device.
template <int A, bool INJ>
__global__ void __launch_bounds__(kBlock) lti_solve_partials_kernel(
    const float* __restrict__ x0, const float* __restrict__ U,
    const float* __restrict__ sigma, const float* __restrict__ inv_s,
    const float* __restrict__ wgt, const float* __restrict__ goal,
    const long long* __restrict__ keys, const float* __restrict__ eps_in,
    float* __restrict__ S_out, float* __restrict__ partials, int T, float dt,
    float lam_cost, float lam_softmin, NoiseParams np) {
  extern __shared__ float smem[];
  __shared__ float scratch[kWarps];
  const int TA = T * A;
  const size_t r = blockIdx.y;
  x0 += r * 2 * A;
  U += r * TA;
  goal += r * 2 * A;
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

  float sig[A], lis[A], wq[A], wqd[A], gq[A], gqd[A], q[A], qd[A], e[A];
#pragma unroll
  for (int a = 0; a < A; ++a) {
    sig[a] = sigma[a];
    lis[a] = inv_s[a];
    wq[a] = wgt[a];
    wqd[a] = wgt[A + a];
    gq[a] = goal[a];
    gqd[a] = goal[A + a];
  }
  __syncthreads();

  const int k = blockIdx.x * kBlock + threadIdx.x;
  const bool valid = k < np.K;
  const bool mirror = np.antithetic && k >= np.K_draw;
  const int kd = mirror ? k - np.K_draw : k;
  const float hdt2 = 0.5f * dt * dt;
  unsigned words[4];

  // ---- pass 1: rollout and cost -------------------------------------------
  float S = INFINITY;
  if (valid) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      q[a] = x0[a];
      qd[a] = x0[A + a];
      e[a] = 0.0f;
    }
    float acc = 0.0f, comp = 0.0f;  // Kahan-compensated Σ_t step cost
    for (int t = 0; t < T; ++t) {
      float eps[A];
      if (INJ) {
#pragma unroll
        for (int a = 0; a < A; ++a) eps[a] = eps_in[((size_t)t * np.K + k) * A + a];
      } else {
        next_eps<A>(np, sig, kd, mirror, t, e, eps, words);
      }
      // explicitly rounded, in the plain version's order (models/point_mass,
      // ops/cost): both modes of this kernel step bit-identical states and
      // costs from bit-identical ε
      float ctrl = 0.0f;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float u = u_s[t * A + a];
        const float ue = __fadd_rn(u, eps[a]);
        q[a] = __fadd_rn(__fadd_rn(q[a], __fmul_rn(dt, qd[a])), __fmul_rn(hdt2, ue));
        qd[a] = __fadd_rn(qd[a], __fmul_rn(dt, ue));
        ctrl = __fadd_rn(ctrl, __fmul_rn(__fmul_rn(u, lis[a]), eps[a]));
      }
      const float step_cost = __fadd_rn(__fmul_rn(lam_cost, ctrl), state_cost<A>(q, qd, wq, wqd, gq, gqd));
      const float y = __fsub_rn(step_cost, comp);
      const float sum = __fadd_rn(acc, y);
      // an infinite sum stays infinite (a diverged rollout costs +inf, never NaN)
      comp = isfinite(sum) ? __fsub_rn(__fsub_rn(sum, acc), y) : 0.0f;
      acc = sum;
    }
    // terminal cost: x_T's state cost counted again (reference parity)
    S = __fadd_rn(acc, state_cost<A>(q, qd, wq, wqd, gq, gqd));
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

template <int A, bool INJ>
cudaError_t launch_partials(const float* x0, const float* U, const float* sigma,
                            const float* inv_s, const float* w, const float* goal,
                            const long long* keys, const float* eps_in, float* S,
                            float* partials, int R, int T, float dt, float lam_cost,
                            float lam_softmin, NoiseParams np, cudaStream_t stream) {
  const dim3 grid((np.K + kBlock - 1) / kBlock, R);
  const size_t smem = (size_t)(1 + kWarps) * T * A * sizeof(float);
  cudaError_t err = set_smem(lti_solve_partials_kernel<A, INJ>, smem);
  if (err != cudaSuccess) return err;
  lti_solve_partials_kernel<A, INJ><<<grid, kBlock, smem, stream>>>(
      x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials, T, dt, lam_cost, lam_softmin,
      np);
  return cudaGetLastError();
}

template <int A>
cudaError_t launch_partials_mode(const float* x0, const float* U, const float* sigma,
                                 const float* inv_s, const float* w, const float* goal,
                                 const long long* keys, const float* eps_in, float* S,
                                 float* partials, int R, int T, float dt, float lam_cost,
                                 float lam_softmin, NoiseParams np, cudaStream_t stream) {
  if (eps_in != nullptr)
    return launch_partials<A, true>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials,
                                    R, T, dt, lam_cost, lam_softmin, np, stream);
  return launch_partials<A, false>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials,
                                   R, T, dt, lam_cost, lam_softmin, np, stream);
}

}  // namespace

extern "C" {

// Every entry returns a cudaError_t as int: 0 on a launched kernel.

// x0 (R, 2A), U (R, T, A), goal (R, 2A), keys (R,) int64 or null, eps_in
// (R, T, K, A) or null → S (R, K), partials (R, nb, 2 + T·A).
int mppi_lti_solve_partials(const float* x0, const float* U, const float* sigma,
                            const float* inv_s, const float* w, const float* goal,
                            const long long* keys, const float* eps_in, float* S,
                            float* partials, int R, int K, int T, int A, float dt,
                            float lam_cost, float lam_softmin, unsigned key0, unsigned key1,
                            unsigned step, unsigned it, int antithetic, float ou_beta,
                            float ou_c, void* stream) {
  if (R < 1 || R > kMaxRobots) return (int)cudaErrorInvalidValue;
  const NoiseParams np = make_noise(key0, key1, step, it, K, antithetic, ou_beta, ou_c);
  cudaStream_t s = (cudaStream_t)stream;
  switch (A) {
    case 1: return launch_partials_mode<1>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials, R, T, dt, lam_cost, lam_softmin, np, s);
    case 2: return launch_partials_mode<2>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials, R, T, dt, lam_cost, lam_softmin, np, s);
    case 3: return launch_partials_mode<3>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials, R, T, dt, lam_cost, lam_softmin, np, s);
    case 4: return launch_partials_mode<4>(x0, U, sigma, inv_s, w, goal, keys, eps_in, S, partials, R, T, dt, lam_cost, lam_softmin, np, s);
    default: return (int)cudaErrorInvalidValue;
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
