// K1's second pass, part 1: the block's rollouts that weigh packed into
// slots. Text, not a header: it is included inside the body of each of
// K1's kernels (mppi_solve.cuh), in place, so that each compiles it as code
// of its own body; weigh_chunks.cuh is part 2. The kernel declares before
// it: constexpr ints kWeighThreads (its threads) and the floats ek (the
// weight of the thread's rollout, 0 where the thread holds none), ints k, kd
// and bool mirror (its rollout, draw and mirror), int TA, and the shared
// float* e_s, int* slot (a slot per rollout of the block), int* counts (one
// per warp) and the partial row float* part. A rollout weighs when e_k ≠ 0
// (a NaN e_k too: it reaches ΔŨ_b, as in block_partials). Slot i of the
// block's n such rollouts, in rollout order, holds its weight and its draw:
// Philox mode kd, or ~kd for an antithetic mirror; injected ε the rollout k.
// Where none weighs, the kernel writes ΔŨ_b = 0 and returns. It declares
// warp, lane, n and the slots are visible to every thread after it.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool weighs = ek != 0.0f;
  const unsigned ballot = __ballot_sync(0xffffffffu, weighs);
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int n = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWeighThreads / 32; ++w) {
    before += w < warp ? counts[w] : 0;
    n += counts[w];
  }
  if (n == 0) {  // block-uniform: no rollout weighs, ΔŨ_b = 0
    for (int i = threadIdx.x; i < TA; i += kWeighThreads) part[2 + i] = 0.0f;
    return;
  }
  if (weighs) {
    const int i = before + __popc(ballot & ((1u << lane) - 1u));
    e_s[i] = ek;
    slot[i] = INJ ? k : mirror ? ~kd : kd;
  }
  __syncthreads();

