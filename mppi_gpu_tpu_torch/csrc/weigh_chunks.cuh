// K1's second pass, part 2: ΔŨ_b[t, a] = Σ over the n slots of e·ε[t, a]
// for t < t_end, ε drawn again (injected: copied), into the partial row.
// Text included inside each of K1's kernels after weigh_slots.cuh (see
// there); the kernel declares besides: constexpr ints kWeighAll (the n at
// which thread j draws slot j, its own rollout: every rollout of a block of
// one thread per rollout weighs; 0 where no such case is) and kWeighCells
// (floats per action of the slab, < 2^11), int t_end, NoiseParams np,
// float sig[A], e[A] (the thread's OU state, reset here), the injected
// eps_in and the shared slab float* cells.
  // Where ε is shaped: by the thread that draws it when shaping needs no
  // order (iid, injected ε) or when every rollout weighs, whose thread j then
  // draws slot j's steps in order; else (OU, some rollouts weigh 0) by the
  // thread of each slot after the chunk's draws, in t order.
  const bool own = INJ || np.ou_beta == 0.0f || n == kWeighAll;
  const bool shaper = threadIdx.x < n;
  const float se = shaper ? e_s[threadIdx.x] : 0.0f;
  const bool smirror = shaper && slot[threadIdx.x] < 0;
#pragma unroll
  for (int a = 0; a < A; ++a) e[a] = 0.0f;  // the OU state of the slot this thread shapes
  const float inv_n = 1.0f / (float)n;
  // (iii)'s lanes per row, G = 2^lg: 8 when 128 rollouts weigh, fewer for
  // fewer slots, each lane summing up to 16 of a row's n slots
  int lg = 0;
  while ((16 << lg) < n) ++lg;
  const int G = 1 << lg;
  // row stride of the slab: the 32 / G rows that one warp sums at once start
  // on banks G apart
  const int ld = n > 32 ? ((n + 31) & ~31) + G : n;
  const int span = kWeighCells / ld;  // steps per chunk: 8 when 128 rollouts weigh
  for (int t0 = 0; t0 < t_end; t0 += span) {
    const int steps = min(span, t_end - t0), m = steps * n;
    // (i) the chunk's cells (step s, slot i), two draws in flight per lane
    // (injected ε: two copies); a second cell past the chunk repeats the
    // first and is neither shaped nor stored
    if (n == kWeighAll) {
      // every rollout weighs: thread j draws slot j, its own rollout, at the
      // chunk's steps in order, and shapes them as it goes
      for (int s = 0; s < steps; s += 2) {
        const bool second = s + 1 < steps;
        float v[2][A];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + s + (second ? h : 0);
          if (INJ) {
            const float* src = eps_in + ((size_t)t * np.K + k) * A;
#pragma unroll
            for (int a = 0; a < A; ++a) v[h][a] = src[a];
          } else {
            unsigned w[4];
            draw_normals<A>(np, kd, t, v[h], w);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 0 || second) {
            float eps[A];
            if (INJ) {
#pragma unroll
              for (int a = 0; a < A; ++a) eps[a] = v[h][a];
            } else {
              shape_eps<A>(np, sig, mirror, t0 + s + h, v[h], e, eps);
            }
#pragma unroll
            for (int a = 0; a < A; ++a)
              cells[((s + h) * A + a) * ld + threadIdx.x] = __fmul_rn(ek, eps[a]);
          }
        }
      }
    } else {
      // cell q = s·n + i, over all threads
      for (int q = threadIdx.x; q < m; q += 2 * kWeighThreads) {
        const bool second = q + kWeighThreads < m;
        int cs[2], ci[2], d[2];
        float v[2][A];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int qh = second ? q + h * kWeighThreads : q;
          cs[h] = (int)(((float)qh + 0.5f) * inv_n);  // exact: qh < kWeighCells < 2^11, n <= 128
          ci[h] = qh - cs[h] * n;
          d[h] = slot[ci[h]];
          if (INJ) {
            const float* src = eps_in + ((size_t)(t0 + cs[h]) * np.K + d[h]) * A;
#pragma unroll
            for (int a = 0; a < A; ++a) v[h][a] = src[a];
          } else {
            unsigned w[4];
            draw_normals<A>(np, d[h] < 0 ? ~d[h] : d[h], t0 + cs[h], v[h], w);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 0 || second) {
            float eps[A];
            if (INJ) {
#pragma unroll
              for (int a = 0; a < A; ++a) eps[a] = v[h][a];
            } else if (own) {
              shape_eps<A>(np, sig, d[h] < 0, t0 + cs[h], v[h], e, eps);
            }
            const float w = e_s[ci[h]];
#pragma unroll
            for (int a = 0; a < A; ++a)
              cells[(cs[h] * A + a) * ld + ci[h]] = own ? __fmul_rn(w, eps[a]) : v[h][a];
          }
        }
      }
    }
    __syncthreads();
    if (!own) {
      // (ii) shape slot threadIdx.x's normals in t order and weigh them
      if (shaper) {
        for (int s = 0; s < steps; ++s) {
          float* c = cells + s * A * ld + threadIdx.x;
          float v[A], eps[A];
#pragma unroll
          for (int a = 0; a < A; ++a) v[a] = c[a * ld];
          shape_eps<A>(np, sig, smirror, t0 + s, v, e, eps);
#pragma unroll
          for (int a = 0; a < A; ++a) c[a * ld] = __fmul_rn(se, eps[a]);
        }
      }
      __syncthreads();
    }
    // (iii) row (s, a) = Σ over its n slots: lane l of a row's G adds slots
    // l, l + 2G, … and l + G, l + 3G, … in two sums, then the G lanes' sums
    // by a shuffle tree
    const int rows = steps * A;
    for (int r0 = warp << (5 - lg); r0 < rows; r0 += (kWeighThreads / 32) << (5 - lg)) {
      const int row = r0 + (lane >> lg);
      float sum = 0.0f;
      if (row < rows) {
        const float* c = cells + row * ld;
        float odd = 0.0f;
        int i = lane & (G - 1);
        for (; i + G < n; i += 2 * G) {
          sum += c[i];
          odd += c[i + G];
        }
        if (i < n) sum += c[i];
        sum += odd;
      }
      for (int o = G >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if ((lane & (G - 1)) == 0 && row < rows) part[2 + t0 * A + row] = sum;
    }
    __syncthreads();  // the slab is free for the next chunk
  }
