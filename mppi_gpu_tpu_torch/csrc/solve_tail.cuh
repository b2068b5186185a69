// The row body: the tail of one MPPI update for one robot's sequence, run by
// K2's epilogue (combine_tail.cu) in the last of K2's blocks to finish for a
// robot. K7 (solve_tail.cu) has row code of its own, its loads issued ahead
// of its arithmetic, with the same per-entry arithmetic (clampf below), so
// both compute the same floats.
//
// u_new = U + ΔU (__fadd_rn: torch's add, never contracted into an FMA),
// clamped to ±max_a as torch.clamp with tensor bounds clamps (NaN passes,
// else min(max(v, −m), m)); then u_seq = u_new, u_next = u_new shifted by one
// step with the last action repeated, action = u_new[0], each written only
// where its pointer is not null. The block reads the robot's whole u_new into
// shared memory before it writes anything, and no other block touches that
// robot's sequence, so u_next may be U itself (the device episode shifts its
// nominal sequence in place).
//
// The sharded controller's tail (sharded_combine.cu) has a row of its own with
// the same per-entry arithmetic, its loads issued ahead of it, as K7's.
//
// Everything lives in the namespace `tail` inside an anonymous namespace, so
// a translation unit may include it beside mppi_solve.cuh and world_step.cuh,
// and no library exports any of it.

#pragma once

#include <cuda_runtime.h>

namespace {
namespace tail {

constexpr int kMaxRobots = 65535;
// the shared memory a block can have on Hopper (227 KB), the row's bound
constexpr int kMaxRowBytes = 232448;

struct RowArgs {
  const float* U;      // (R, T, A)
  const float* dU;     // (R, T, A)
  const float* max_a;  // (A,)
  float* u_seq;        // (R, T, A) or null
  float* u_next;       // (R, T, A) or null; may be U (in place)
  float* action;       // (R, A) or null
  int clamp, T, A;
};

// torch.clamp(v, lo, hi) on the card: NaN passes, else min(max(v, lo), hi)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// Robot r's tail, by every thread of the block, from ΔU[base + i] =
// delta(base, i), base = r·T·A; `row` holds T·A floats of shared memory.
template <class Delta>
__device__ __forceinline__ void row_body_of(const RowArgs& a, int r, float* row, Delta delta) {
  const int n = a.T * a.A;
  const long long base = (long long)r * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = delta(base, i);
    float v = __fadd_rn(a.U[base + i], d);
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

// Robot r's tail from ΔU = a.dU, read from L2 (__ldcg): K2's epilogue reads
// columns that other blocks of the same launch wrote.
__device__ __forceinline__ void row_body(const RowArgs& a, int r, float* row) {
  row_body_of(a, r, row, [&](long long base, int i) { return __ldcg(a.dU + base + i); });
}

}  // namespace tail
}  // namespace
