// K8 sharded_scale and K9 sharded_tail: the one-pass sharded combine of the
// ranks' unnormalized solves, the kernel between its two all-reduces (K8)
// and the tail with the world's step after them (K9), bound to Python with
// ctypes (mppi_gpu_tpu_torch/ops/_build.py, ops/sharded_combine.py).
//
// They replace no Pallas kernel. On the TPU the sharded solve runs under
// shard_map inside jax.jit (mppi_gpu_tpu/parallel/sharded.py:105, 157), and
// XLA fuses the combine's elementwise work between the collectives
// (mppi_gpu_tpu/controller.py:481-500): β = pmin β_d, f_d = exp((β − β_d)/λ),
// psum of f_d·η_d and of f_d·ΔŨ_d, ΔU = Σ f_d·ΔŨ_d / η; then the tail
// (:522-531) and, in the jitted episode, the world's simulate
// (mppi_gpu_tpu/runner.py:375-383). These kernels stand for that fusion in
// the port's sharded controller (parallel/sharded.py), where the torch ops
// of the combine, K7 (solve_tail.cu) and K6 (world_step.cu) ran 15 kernels
// per graph cycle on a world of one rank.
//
// K8, between the MIN and the SUM collectives: for each of the n local
// ranks' rows [β_d, η_d, ΔŨ_d] (K2's unnormalized output, 2 + T·A floats),
// f_d = expf((β − β_d)·float32(1/λ)) and the row [f_d·η_d, f_d·ΔŨ_d]
// (1 + T·A floats), 0 where f_d is 0: a rank whose rollouts all cost +inf
// (β_d = +inf, η_d and ΔŨ_d NaN) adds nothing, as torch.where drops it. The
// SUM collective then adds those rows over the ranks in place.
//
// K9, after the SUM: robot 0's tail on ΔU = Σ/η, each entry divided as it is
// loaded (`divide`; the two-kernel branch's ΔU is already the sum it needs),
// the softmin weights over K where asked for (K7's weight blocks), and in the
// episode's last update the world's cycle in thread 0 under the action the
// block holds in shared memory (K6's body, world_step.cuh's Robot).
//
// Both move a few KB (at the flagship T·A = 600 floats per rank) and do a
// few hundred operations: they are bound by their launch and their latency,
// not by bytes or operations. K8 is a grid (⌈(1 + T·A)/256⌉, n) of 256
// threads, one entry each; K9 is a grid (1 + ⌈K/256⌉, 1) with the weights
// (K7's blocks for one robot), (1, 1) without. So K9's row block is built
// for latency:
// - every load of a pass is issued before any arithmetic that uses it: a
//   thread's kPer entries of U and Σ (or ΔU), their max_a, and η once, into
//   registers. A row of up to kChunk = 1024 entries is one round trip to L2;
//   a longer one (up to 227 KB) takes one per 1024 entries. K2''s row body
//   (solve_tail.cuh) loads one entry per thread at a time instead, each
//   pass's loads after the last one's stores, three round trips at T·A = 600;
// - thread 0 issues the world's loads (its pack, the counter, the clock and
//   the state) at the start too, beside its row loads, so after the barrier
//   only the world's serial arithmetic and its stores remain;
// - the one robot writes the clock, its history row and the counter's
//   advance itself: no fence and no ticket (step_world takes one per robot so
//   that the last of R writes them). The tickets argument stays, left zero.
// The per-entry arithmetic and the world's are K7's and K6's, so the outputs
// are the same floats.
//
// The arithmetic is the torch ops', each rounded once (never contracted into
// an FMA): β − β_d (__fsub_rn), the division by the Python float λ as torch's
// CUDA division by a CPU scalar computes it, a product with float32(1/λ)
// (the wrapper passes it, ops/_rounding.scalar_reciprocal; __fmul_rn), expf
// at full precision (no fast math), f·x (__fmul_rn), 0.0 where f == 0, and
// Σ/η by the device scalar η (__fdiv_rn); the cross-rank sums are the mesh's
// own. So the result is the torch combine's bit for bit.
//
// K10 softmin_min and K11 softmin_eta: the two-kernel sharded solve's softmin
// across the ranks, one kernel before each of its collectives. They replace
// no Pallas kernel either: under jax.jit (mppi_gpu_tpu/parallel/sharded.py:
// 157) the two-kernel branch (mppi_gpu_tpu/controller.py:508-521) runs
// softmin_weights with an axis name (mppi_gpu_tpu/ops/softmin.py:30-43), a
// min, a pmin, an exp with its sum, a psum and e/η, and XLA fuses the work
// before each collective into one fusion, the weights into the Pallas update.
// Here K10 takes β_d = min of each local rank's row of S (the rows of one
// (n, K/n) buffer K4 writes), the MIN collective β; K11 η_d = Σ_k e_k with
// e_k = expf(−(S_k − β)·float32(1/λ)) (K9's and K7's expression for torch's
// rounding), the SUM collective η; K5's softmin form (mppi_solve.cu) forms
// the weights e_k/η itself. Their plain version is
// parallel/sharded.softmin_across, the seven torch kernels they replace.
// K10's min is torch.amin's: +inf where every rollout of the rank costs +inf,
// NaN where a NaN is present (a NaN wins every comparison). K11's sum has one
// fixed order, whatever the grid: each 4096-entry chunk of a row is summed by
// 1024 lanes, lane l taking entries l, l + 1024, l + 2048, l + 3072 of the
// chunk in that order (entries past the row are 0), then by a halving tree,
// lane l adding lane l + h for h = 512, 256, …, 1; the chunks' sums are then
// added in chunk order. The plain version repeats it in elementwise torch
// adds over a zero-padded view (ops/sharded_combine.eta_sum), so on the card
// the two agree bit for bit.
// Both read K/n floats a row and write one: at K/n = 3000-10⁴ that is 12-40 KB,
// 0.004-0.012 µs at 3.35 TB/s, far below a launch. They are built for
// latency: a block of 256 threads takes one chunk, each thread its 16 entries
// (16 loads, then β once, all in flight before any arithmetic), and K11's
// halving tree takes one barrier (h = 512, 256 in registers, then warp 0 alone
// reads the 256 partial lanes and finishes h = 128 … 1). A row of C chunks
// takes one of three forms, by C (row_form):
// - C = 1 (K/n ≤ 4096): one block, which writes the row's value;
// - 2 ≤ C ≤ 8 (up to 32768 entries): one thread-block cluster of the row's C
//   blocks (Hopper's portable cluster size is 8). Thread 0 of block r > 0
//   sends its chunk's value into block 0's shared memory through distributed
//   shared memory (st.async), which counts its bytes on an mbarrier of block
//   0; block 0's thread 0 waits on that mbarrier alone and combines the C
//   values in chunk order. No scratch, fence, atomic or ticket: the row's
//   second round trip to L2 is gone, and no barrier of the whole cluster
//   follows the reduction. The cluster barrier that proves block 0 has
//   started and readied its mbarrier before another block writes it is
//   split: arrived at the kernel's start, waited on after the chunk's
//   reduction, so it hides behind the loads. A cluster barrier after the
//   writes instead (cooperative_groups' cluster.sync(), every block waiting)
//   was 0.5 µs slower per launch at three chunks on an H100 (PERF.md §6);
// - C > 8 (the K = 10⁵ and 10⁶ cells on few ranks): a block per chunk, in
//   parallel; each writes its chunk's value to a scratch row and takes a
//   ticket of its row (atomicAdd after __threadfence), and the last block
//   combines the C values in chunk order, and sets the ticket back to 0 for
//   the next launch (a replayed graph's too).
// The three forms combine the same chunk values in the same order, so they
// give the same floats. Blocks of up to four chunks (1024 threads, no ticket
// up to 16384 entries) were tried on an H100: about 0.3 µs less per cycle at
// the flagship's K/n = 10⁴, 0.15-0.3 µs more at one chunk (PERF.md §6).

#include "solve_tail.cuh"
#include "world_step.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 65535;  // gridDim.y of K8, K10 and K11
constexpr int kPer = 4;             // K9: row entries a thread holds per pass
constexpr int kChunk = kPer * kThreads;  // K9: entries per pass, one round trip each
constexpr int kRowChunk = 4096;     // K10/K11: entries of a row per block, K11's chunk
constexpr int kRowLanes = 1024;     // K11: lanes of a chunk, kRowChunk / kRowLanes entries each
constexpr int kRowPer = kRowChunk / kThreads;          // K10/K11: entries a thread loads, 16
constexpr int kLaneEntries = kRowChunk / kRowLanes;    // K11: entries a lane adds in order, 4
constexpr int kThreadLanes = kRowLanes / kThreads;     // K11: lanes a thread holds, 4
constexpr int kMaxCluster = 8;      // K10/K11: chunks of a row in one cluster, the portable most

struct NoWorld {};  // the tail alone: an inner opt iteration, or a world without a K6 body

__global__ void __launch_bounds__(kThreads) sharded_scale_kernel(
    const float* __restrict__ rows, const float* __restrict__ beta, float inv_lam, int TA,
    float* __restrict__ out) {
  const long long d = blockIdx.y;
  const float* row = rows + d * (2 + (long long)TA);
  const float f = expf(__fmul_rn(__fsub_rn(*beta, row[0]), inv_lam));
  for (int i = blockIdx.x * kThreads + threadIdx.x; i <= TA; i += gridDim.x * kThreads)
    out[d * (1 + (long long)TA) + i] = f == 0.0f ? 0.0f : __fmul_rn(f, row[1 + i]);
}

// torch's min: a NaN on either side wins
__device__ __forceinline__ float nan_min(float a, float b) { return (a != a || a < b) ? a : b; }

// After each block of row d has its value v in thread 0: true in every thread
// of the last of the row's C blocks to finish, which then reads the C values
// from scratch[d·C …]; thread 0 of every block wrote its own there first.
__device__ __forceinline__ bool last_block_of_row(float v, float* scratch, int* tickets,
                                                  long long d) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    scratch[d * gridDim.x + blockIdx.x] = v;
    __threadfence();  // the value is seen before the ticket
    last = atomicAdd(&tickets[d], 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// The cluster form's landing place in block 0's shared memory: an mbarrier
// counting the bytes of the other blocks' values, and the row's C values
struct RowParts {
  unsigned long long full;
  float part[kMaxCluster];
};

__device__ __forceinline__ RowParts& row_parts() {
  __shared__ RowParts parts;
  return parts;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// At the kernel's start, in a cluster of the row's C blocks: block 0's thread
// 0 readies its mbarrier for one arrival (its own) and the other blocks'
// 4·(C − 1) bytes, and every thread arrives at the cluster's barrier (relaxed;
// the init's fence releases it). Only a thread about to write block 0's
// memory waits on that barrier, after its chunk is reduced.
__device__ __forceinline__ void cluster_start() {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 : : "r"(smem_addr(&row_parts().full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed;\n" : : : "memory");
}

// With the chunk's value v in thread 0: thread 0 of block r > 0 waits until
// every block of the cluster has started (block 0's mbarrier is ready), sends
// v into part[r] of block 0 by st.async, which completes its 4 bytes on block
// 0's mbarrier, and leaves; thread 0 of block 0 puts v into part[0], arrives
// expecting the others' bytes, and waits for the mbarrier's phase. True in
// block 0's thread 0 alone, once part holds the row's C values. No cluster
// barrier after the reduction: the values travel one way, and only block 0
// waits.
__device__ __forceinline__ bool cluster_gather(float v) {
  if (threadIdx.x != 0) return false;
  RowParts& p = row_parts();
  if (blockIdx.x > 0) {
    asm volatile("barrier.cluster.wait;\n" : : : "memory");
    unsigned dst, full;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                 : "=r"(dst) : "r"(smem_addr(p.part + blockIdx.x)));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(full) : "r"(smem_addr(&p.full)));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
                 : : "r"(dst), "r"(__float_as_uint(v)), "r"(full) : "memory");
    return false;
  }
  p.part[0] = v;
  const unsigned full = smem_addr(&p.full);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               : : "r"(full), "r"(4 * ((int)gridDim.x - 1)) : "memory");
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT;\n"
      "}\n"
      : : "r"(full) : "memory");
  return true;
}

// K10: β_d = min over row d of S (n, k_loc), grid (⌈k_loc/4096⌉, n); with
// CLUSTER each row's blocks form one cluster, else the row is one block or
// takes a ticket
template <bool CLUSTER>
__global__ void __launch_bounds__(kThreads) softmin_min_kernel(
    const float* __restrict__ S, int k_loc, float* __restrict__ beta_d, float* scratch,
    int* tickets) {
  if constexpr (CLUSTER) cluster_start();
  const long long d = blockIdx.y;
  const float* row = S + d * k_loc;
  const int base = blockIdx.x * kRowChunk + threadIdx.x;
  float v[kRowPer];
#pragma unroll
  for (int j = 0; j < kRowPer; ++j) {
    const int i = base + j * kThreads;
    v[j] = i < k_loc ? row[i] : __int_as_float(0x7f800000);  // +inf
  }
  float m = v[0];
#pragma unroll
  for (int j = 1; j < kRowPer; ++j) m = nan_min(m, v[j]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_min[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = nan_min(m, warp_min[w]);
  }
  if constexpr (CLUSTER) {
    if (cluster_gather(m)) {
      const float* part = row_parts().part;
      float r = part[0];
#pragma unroll
      for (int c = 1; c < kMaxCluster; ++c)
        if (c < (int)gridDim.x) r = nan_min(r, part[c]);
      beta_d[d] = r;
    }
    return;
  }
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) beta_d[d] = m;
    return;
  }
  if (last_block_of_row(m, scratch, tickets, d) && threadIdx.x == 0) {
    const float* part = scratch + d * gridDim.x;
    float r = __ldcg(part);
#pragma unroll 8
    for (int c = 1; c < (int)gridDim.x; ++c) r = nan_min(r, __ldcg(part + c));
    beta_d[d] = r;
    tickets[d] = 0;
  }
}

// K11: η_d = Σ_k expf(−(S_k − β)·inv_lam) over row d of S (n, k_loc) in the
// fixed order above, grid (⌈k_loc/4096⌉, n), its rows' blocks in clusters
// with CLUSTER as K10's. Thread t holds lanes t, t + 256, t + 512, t + 768 of
// its block's chunk: the tree's first two levels (h = 512, 256) in its
// registers; after one barrier lane i of warp 0 holds partial lanes i + 32·j
// (j = 0 … 7) and adds h = 128, 64, 32 in its registers, 16-1 by shuffles.
template <bool CLUSTER>
__global__ void __launch_bounds__(kThreads) softmin_eta_kernel(
    const float* __restrict__ S, int k_loc, const float* __restrict__ beta, float inv_lam,
    float* __restrict__ eta_d, float* scratch, int* tickets) {
  if constexpr (CLUSTER) cluster_start();
  const long long d = blockIdx.y;
  const float* row = S + d * k_loc;
  const int base = blockIdx.x * kRowChunk + threadIdx.x;
  float s[kThreadLanes][kLaneEntries];  // lane t + 256·q, its entries in order
#pragma unroll
  for (int q = 0; q < kThreadLanes; ++q) {
#pragma unroll
    for (int j = 0; j < kLaneEntries; ++j) {
      const int i = base + q * kThreads + j * kRowLanes;
      s[q][j] = i < k_loc ? row[i] : 0.0f;
    }
  }
  const float b = *beta;
  float lane[kThreadLanes];
#pragma unroll
  for (int q = 0; q < kThreadLanes; ++q) {
#pragma unroll
    for (int j = 0; j < kLaneEntries; ++j) {
      const int i = base + q * kThreads + j * kRowLanes;
      const float e = i < k_loc ? expf(__fmul_rn(-__fsub_rn(s[q][j], b), inv_lam)) : 0.0f;
      lane[q] = j == 0 ? e : __fadd_rn(lane[q], e);
    }
  }
  // h = 512 (lane t + lane t + 512, lane t + 256 + lane t + 768), then h = 256
  __shared__ float tree[kThreads];
  tree[threadIdx.x] = __fadd_rn(__fadd_rn(lane[0], lane[2]), __fadd_rn(lane[1], lane[3]));
  __syncthreads();
  float v = 0.0f;
  if (threadIdx.x < 32) {
    constexpr int kWarps = kThreads / 32;
    float t[kWarps];  // partial lanes threadIdx.x + 32·j
#pragma unroll
    for (int j = 0; j < kWarps; ++j) t[j] = tree[threadIdx.x + 32 * j];
#pragma unroll
    for (int h = kWarps / 2; h > 0; h >>= 1) {  // h = 128, 64, 32: lane + lane 32·h later
#pragma unroll
      for (int j = 0; j < h; ++j) t[j] = __fadd_rn(t[j], t[j + h]);
    }
    v = t[0];
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  }
  if constexpr (CLUSTER) {
    if (cluster_gather(v)) {
      const float* part = row_parts().part;
      float r = part[0];
#pragma unroll
      for (int c = 1; c < kMaxCluster; ++c)
        if (c < (int)gridDim.x) r = __fadd_rn(r, part[c]);  // chunk order
      eta_d[d] = r;
    }
    return;
  }
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) eta_d[d] = v;
    return;
  }
  if (last_block_of_row(v, scratch, tickets, d) && threadIdx.x == 0) {
    const float* part = scratch + d * gridDim.x;
    float r = __ldcg(part);
#pragma unroll 8
    for (int c = 1; c < (int)gridDim.x; ++c) r = __fadd_rn(r, __ldcg(part + c));  // chunk order
    eta_d[d] = r;
    tickets[d] = 0;
  }
}

struct ShardedTailArgs {
  tail::RowArgs row;   // U, ΔU (with `divide` the sum [η, Σ f·ΔŨ]), max_a, u_seq, u_next, action
  float* dU_out;       // (T, A) the quotient Σ/η, or null
  const float* S;      // (K,)
  const float* beta;   // 0-dim
  const float* eta;    // 0-dim
  float* weights;      // (K,) or null
  int K;
  float inv_lam;       // float32(1/λ)
  world::AdvanceArgs adv;  // its u unused: the action is the row's first A floats
};

// The world's step in the thread that takes it: its loads at the kernel's
// start, its arithmetic under the action after the row's barrier.
template <class W>
struct WorldStep {
  world::Robot<W> robot;
  __device__ __forceinline__ void load(const world::AdvanceArgs& a) { robot.load(a, 0, nullptr); }
  __device__ __forceinline__ void run(const world::AdvanceArgs& a, const float* u) {
    robot.run_alone(a, u);
  }
};

template <>
struct WorldStep<NoWorld> {
  __device__ __forceinline__ void load(const world::AdvanceArgs&) {}
  __device__ __forceinline__ void run(const world::AdvanceArgs&, const float*) {}
};

template <class W, bool DIVIDE>
__global__ void __launch_bounds__(kThreads) sharded_tail_kernel(const ShardedTailArgs a) {
  if (blockIdx.x > 0) {  // the weights of rollouts (blockIdx.x − 1)·256 + threadIdx.x, as K7's
    const int k = (blockIdx.x - 1) * kThreads + threadIdx.x;
    if (k < a.K) {
      const float d = __fsub_rn(a.S[k], *a.beta);
      const float e = expf(__fmul_rn(-d, a.inv_lam));
      a.weights[k] = __fdiv_rn(e, *a.eta);
    }
    return;
  }
  extern __shared__ float row[];  // u_new, T·A floats
  const tail::RowArgs& r = a.row;
  const int n = r.T * r.A;
  WorldStep<W> world;  // thread 0's: its loads go out now, beside the row's
  if (threadIdx.x == 0) world.load(a.adv);
  const float eta = DIVIDE ? r.dU[0] : 0.0f;
  // c: the action index of this thread's next entry (entries i = threadIdx.x
  // + m·256), kept mod A by one subtraction per entry
  int c = 0, step = 0;
  for (int base = threadIdx.x; base < n; base += kChunk) {
    float u[kPer], d[kPer], m[kPer];
    // every load of the pass before any arithmetic: U and ΔU first, then
    // their bounds, whose first index takes two integer divisions
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreads;
      if (i < n) {
        u[j] = r.U[i];
        d[j] = r.dU[DIVIDE + i];  // Σ after η, or ΔU itself
      }
    }
    if (r.clamp) {
      if (base == (int)threadIdx.x) {
        step = kThreads % r.A;
        c = threadIdx.x % r.A;
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (base + j * kThreads < n) {
          m[j] = r.max_a[c];
          c += step;
          if (c >= r.A) c -= r.A;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = base + j * kThreads;
      if (i < n) {
        float q = d[j];
        if constexpr (DIVIDE) {
          q = __fdiv_rn(q, eta);
          if (a.dU_out != nullptr) a.dU_out[i] = q;
        }
        float v = __fadd_rn(u[j], q);
        if (r.clamp) v = tail::clampf(v, -m[j], m[j]);
        row[i] = v;
      }
    }
  }
  __syncthreads();  // the whole row is read before any of it is written (u_next may be U)
  for (int i = threadIdx.x; i < n; i += kThreads) {
    if (r.u_seq != nullptr) r.u_seq[i] = row[i];
    // u_next[t] = u_new[t + 1], the last step's action repeated
    if (r.u_next != nullptr) r.u_next[i] = row[i + r.A < n ? i + r.A : i];
    if (r.action != nullptr && i < r.A) r.action[i] = row[i];
  }
  if (threadIdx.x == 0) world.run(a.adv, row);
}

template <class W, bool DIVIDE>
int launch_tail(const ShardedTailArgs& a, int row_bytes, cudaStream_t stream) {
  if (row_bytes > 48 * 1024) {  // past the default, on the current device
    const cudaError_t err = cudaFuncSetAttribute(
        sharded_tail_kernel<W, DIVIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize, row_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(1 + (a.weights != nullptr ? (a.K + kThreads - 1) / kThreads : 0), 1);
  sharded_tail_kernel<W, DIVIDE><<<grid, kThreads, (size_t)row_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class W>
int launch(const ShardedTailArgs& a, int divide, int row_bytes, cudaStream_t stream) {
  return divide ? launch_tail<W, true>(a, row_bytes, stream)
                : launch_tail<W, false>(a, row_bytes, stream);
}

template <class W>
bool fits(int n_leaves, int n_params, int A) {
  return n_leaves == W::kLeaves && n_params == W::kParams && A == W::kA;
}

// the chunks of a row of k_loc entries, K10's and K11's blocks per row
int row_chunks(int k_loc) { return (k_loc + kRowChunk - 1) / kRowChunk; }

// a row of more than kMaxCluster chunks takes scratch and a ticket
bool ticket_rows(int k_loc) { return row_chunks(k_loc) > kMaxCluster; }

// K10 and K11 refuse n outside [1, 65535], k_loc below 1, and a row of more
// than eight chunks without scratch (n·C floats) or tickets (n int32, zero)
bool bad_rows(int n, int k_loc, const float* scratch, const int* tickets) {
  return n < 1 || n > kMaxRanks || k_loc < 1
         || (ticket_rows(k_loc) && (scratch == nullptr || tickets == nullptr));
}

// K10 or K11 over grid (C, n) for rows of C chunks: one block or a ticket
// per row by a plain launch, 2 ≤ C ≤ 8 as one cluster of the row's C blocks
// (the kernels read scratch and tickets only for a ticket). A launch
// refused, the cluster's too, returns its error.
template <class... Params, class... Args>
int launch_rows(void (*plain)(Params...), void (*cluster)(Params...), int n, int k_loc,
                cudaStream_t stream, Args... args) {
  const int C = row_chunks(k_loc);
  const dim3 grid(C, n);
  if (C == 1 || C > kMaxCluster) {
    plain<<<grid, kThreads, 0, stream>>>(args...);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, cluster, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8: for n rows (n, 2 + TA) = [β_d, η_d, ΔŨ_d] and β (one float on the
// device, after the MIN collective), out (n, 1 + TA) = f_d·[η_d, ΔŨ_d] with
// f_d = expf((β − β_d)·inv_lam), 0 where f_d == 0 (inv_lam: float32(1/λ)).
// out may not overlap rows. Refuses (cudaErrorInvalidValue) n outside
// [1, 65535] and TA below 1.
int mppi_sharded_scale(const float* rows, int n, int TA, const float* beta, float inv_lam,
                       float* out, void* stream) {
  if (n < 1 || n > kMaxRanks || TA < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((TA + kThreads) / kThreads, n);  // ⌈(1 + TA)/256⌉ blocks per row
  sharded_scale_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(rows, beta, inv_lam, TA, out);
  return (int)cudaGetLastError();
}

// K10: beta_d (n,) = the min of each row of S (n, k_loc), torch.amin's (NaN
// where one is present). A row of one chunk (k_loc ≤ 4096) is one block, of
// 2-8 chunks one cluster; scratch (n, ⌈k_loc/4096⌉) floats and tickets (n,)
// int32 zeros, left zero, serve rows of more than eight chunks (k_loc >
// 32768; else unused, may be null). Refuses (cudaErrorInvalidValue) what
// bad_rows names.
int mppi_softmin_min(const float* S, int n, int k_loc, float* beta_d, float* scratch,
                     int* tickets, void* stream) {
  if (bad_rows(n, k_loc, scratch, tickets)) return (int)cudaErrorInvalidValue;
  return launch_rows(softmin_min_kernel<false>, softmin_min_kernel<true>, n, k_loc,
                     (cudaStream_t)stream, S, k_loc, beta_d, scratch, tickets);
}

// K11: eta_d (n,) = Σ_k expf(−(S[d, k] − β)·inv_lam) for each row of S
// (n, k_loc), β one float on the device (after the MIN collective), inv_lam
// float32(1/λ), summed in the fixed order above; its forms, scratch and
// tickets as K10's. Refuses (cudaErrorInvalidValue) what bad_rows names.
int mppi_softmin_eta(const float* S, int n, int k_loc, const float* beta, float inv_lam,
                     float* eta_d, float* scratch, int* tickets, void* stream) {
  if (bad_rows(n, k_loc, scratch, tickets)) return (int)cudaErrorInvalidValue;
  return launch_rows(softmin_eta_kernel<false>, softmin_eta_kernel<true>, n, k_loc,
                     (cudaStream_t)stream, S, k_loc, beta, inv_lam, eta_d, scratch, tickets);
}

// K9: one robot's tail, u_new = U + ΔU (clamped to ±max_a when `clamp`),
// where with `divide` dU holds the sum [η, Σ (T·A)] and ΔU = Σ/η (written to
// dU_out when it is not null), else dU is ΔU (T, A); then u_seq = u_new,
// u_next = u_new shifted by one step with the last repeated (may be U: in
// place), action = u_new[0] (A,), and with `weights` non-null weights[k] =
// expf(−(S[k] − β)·inv_lam)/η over K; a null output is not written. Then,
// with `world_id` >= 0 (world_step.cuh's WorldId), K6's cycle of that world
// for the one robot under the action, as mppi_combine_tail runs it: in / out
// the state leaves (out may be in), the clock, xs[row + 1], us[row], ts[row]
// at row = *step_ptr when row is in [0, n_hist), x_out = the new x, and
// *step_ptr = row + 1; tickets: 2 int32, zero, left zero. Refuses
// (cudaErrorInvalidValue) T or A below 1, K below 1 with weights, a row of
// more than 227 KB, and with a world null tickets, another leaf count, pack
// length or action dim than the world's, steps < 0, or a null step_ptr.
int mppi_sharded_tail(const float* U, const float* dU, int divide, const float* max_a, int clamp,
                      float* u_seq, float* u_next, float* action, float* dU_out, const float* S,
                      const float* beta, const float* eta, float inv_lam, float* weights, int T,
                      int A, int K, int* tickets, int world_id, const void* const* in,
                      void* const* out, int n_leaves, const float* time_in, float* time_out,
                      int per_robot_clock, const float* params, int n_params, int steps, float* xs,
                      float* us, float* ts, int n_hist, long long* step_ptr, float* x_out,
                      void* stream) {
  if (T < 1 || A < 1 || (weights != nullptr && K < 1)) return (int)cudaErrorInvalidValue;
  const long long row_bytes = (long long)T * A * (long long)sizeof(float);
  if (row_bytes > tail::kMaxRowBytes) return (int)cudaErrorInvalidValue;
  ShardedTailArgs a{};
  a.row = tail::RowArgs{U, dU, max_a, u_seq, u_next, action, clamp, T, A};
  a.dU_out = divide ? dU_out : nullptr;
  a.S = S;
  a.beta = beta;
  a.eta = eta;
  a.weights = weights;
  a.K = weights != nullptr ? K : 0;
  a.inv_lam = inv_lam;
  cudaStream_t s = (cudaStream_t)stream;
  const int rb = (int)row_bytes;
  if (world_id < 0) return launch<NoWorld>(a, divide, rb, s);
  if (tickets == nullptr || n_leaves < 1 || n_leaves > world::kMaxLeaves || steps < 0
      || step_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  world::AdvanceArgs& w = a.adv;
  for (int l = 0; l < n_leaves; ++l) {
    w.in[l] = static_cast<const float*>(in[l]);
    w.out[l] = static_cast<float*>(out[l]);
  }
  w.time_in = time_in;
  w.time_out = time_out;
  w.params = params;
  w.xs = xs;
  w.us = us;
  w.ts = ts;
  w.step_ptr = step_ptr;
  w.x_out = x_out;
  w.tick = 1;
  w.R = 1;
  w.per_robot_clock = per_robot_clock;
  w.steps = steps;
  w.n_hist = n_hist;
#define WORLD_CASE(id, W)                                                                   \
  case world::id:                                                                           \
    return fits<world::W>(n_leaves, n_params, A) ? launch<world::W>(a, divide, rb, s)       \
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
