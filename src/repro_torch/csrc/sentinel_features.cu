// LEAR's sentinel-time features for Hopper (sm_90a): the whole output of
// repro_torch.core.features.augment_features in one launch, with a plain C
// interface loaded through ctypes by repro_torch/kernels/sentinel_features.py.
//
// It replaces no Pallas kernel. The JAX package builds these features with
// plain jnp (src/repro/core/features.py), and the port did the same with a
// chain of PyTorch ops: the [Q, D, D] "beats" predicate of the rank compare
// (or 16 tiles of it from a host loop above 256 slots), its int32 copy for
// the sum, the min-max, then stack, where and cat. Each op is a pass over
// device memory, and the predicate is the largest tensor of the stage. This
// kernel produces the same bits and writes nothing but the output.
//
// What it computes, per query q of D slots with mask m and partial scores p:
//   s[j]    = m[j] ? p[j] : -1e30f                       (core.features.NEG)
//   rank[i] = #{j : s[j] > s[i] or (s[j] == s[i] and j < i)}   (_beats)
//   lo, hi  = min and max of p over the real slots (+inf / -inf if none)
//   norm[i] = clamp((p[i] - lo) / max(hi - lo, 1e-9), 0, 1)
//   n       = #{j : m[j]}
//   out[q, i, :F] = X[q, i, :]; out[q, i, F:] = {p[i], rank[i], norm[i], n}
//   on a real slot, and {0, 0, 0, 0} on a masked one.
// Every float is an IEEE operation in the plain path's order (subtract,
// divide, min/max with NaN kept as torch.amin / clamp keep it), written with
// the _rn intrinsics so that nothing is contracted: bit-equal to the plain
// PyTorch version on the card.
//
// What bounds it on this card. Bytes: X read once and X_aug written once,
// Q*D*(2F + 4)*4, plus the partials and the mask, Q*D*5 (1.163 GB at
// Q = 4096, D = 256, F = 136; 3.725 GB at D = 512, F = 220: 0.35 and
// 1.11 ms at 3.35 TB/s). The rank compare is D^2 pairs a query, a few
// instructions each, all of them on shared memory and registers: ~0.03 and
// ~0.15 ms of the card's issue rate at those shapes, below the copy.
//
// What the design does about that.
// - One CTA per query, or, where D is at most half the CTA's 256 threads,
//   floor(256 / D) queries side by side, so that no warp idles in the compare.
//   A query's [D, F] slab of X and its [D, F + 4] slab of the output are
//   contiguous, so a CTA streams one contiguous range in and one out.
// - The query's D scores (masked slots at -1e30) are staged in shared
//   memory, at most kColChunk at a time, so any D runs. Each thread owns
//   rows (every 256th) and counts, for each real row, the columns that beat
//   it: the column is a shared-memory broadcast, the count a register. A
//   masked row's output is zero, so it is not counted. The counts go to
//   shared memory for the copy, kRowChunk rows at a time.
// - min, max and the real count: warp shuffles, then the warps of a query
//   combined through shared memory.
// - The copy: where F % 4 == 0 and X is 16-byte aligned, every output row
//   is F/4 + 1 float4s, the last the four features, so the whole slab is
//   written by 16-byte stores in order, read by 16-byte streaming loads,
//   kUnroll loads in flight a thread. Otherwise a scalar loop does the same.
// - The copy is bound by memory and the compare by instruction issue; with
//   several CTAs resident on an SM one CTA's compare overlaps another's copy.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColChunk = 2048;  // scores staged in shared memory at a time
constexpr int kRowChunk = 1024;  // rows whose counts shared memory holds
constexpr int kUnroll = 4;       // 16-byte loads in flight a thread
constexpr float kNeg = -1e30f;   // core.features.NEG
constexpr float kMinSpan = 1e-9f;

// torch.amin / amax keep a NaN; so do these.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (b < a || b != b) ? b : a;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

struct Group {
  const float* X;      // the group's first query's [D, F] slab
  const float* p;      // its [D] partials
  const uint8_t* m;    // its [D] mask
  float* out;          // its [D, F + 4] slab
  int D, F;
  const float* lo;     // per query of the group, in shared memory
  const float* hi;
  const int* n;
  const int* ranks;    // counts of rows [r0, r0 + kRowChunk)
  int r0;
};

// The four features of group row rr (flattened over the group's queries).
__device__ __forceinline__ float4 features_of(const Group& g, int rr) {
  if (!g.m[rr]) return make_float4(0.f, 0.f, 0.f, 0.f);
  const int q = rr / g.D;
  const float p = g.p[rr];
  const float lo = g.lo[q];
  float span = __fsub_rn(g.hi[q], lo);
  span = span != span ? span : fmaxf(span, kMinSpan);         // clamp_min
  float norm = __fdiv_rn(__fsub_rn(p, lo), span);
  norm = norm != norm ? norm : fminf(fmaxf(norm, 0.f), 1.f);  // clamp
  return make_float4(p, static_cast<float>(g.ranks[rr - g.r0]), norm,
                     static_cast<float>(g.n[q]));
}

__device__ __forceinline__ float feature_of(const Group& g, int rr, int k) {
  const float4 v = features_of(g, rr);
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Rows [r0, r1) of the group into the output: 16-byte loads and stores.
__device__ void copy_rows_vec(const Group& g, int r1) {
  const int F4 = g.F / 4, W4 = F4 + 1;  // float4s a row: X's, then the features
  const float4* X4 = reinterpret_cast<const float4*>(g.X);
  float4* O4 = reinterpret_cast<float4*>(g.out);
  const int end = r1 * W4;
  const int drow = kThreads / W4, dcol = kThreads - drow * W4;
  int k = g.r0 * W4 + threadIdx.x;
  int row = k / W4, col = k - row * W4;
  while (k < end) {
    float4 v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = k;
      if (k < end) {
        v[u] = col < F4 ? __ldcs(X4 + static_cast<long long>(row) * F4 + col)
                        : features_of(g, row);
      }
      k += kThreads;
      row += drow;
      col += dcol;
      if (col >= W4) {
        col -= W4;
        ++row;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (at[u] < end) __stcs(O4 + at[u], v[u]);
    }
  }
}

// The same with 4-byte loads and stores, for any F and alignment.
__device__ void copy_rows_scalar(const Group& g, int r1) {
  const int W = g.F + 4;
  const int end = r1 * W;
  for (int k = g.r0 * W + threadIdx.x; k < end; k += kThreads) {
    const int row = k / W, col = k - row * W;
    g.out[k] = col < g.F ? g.X[static_cast<long long>(row) * g.F + col]
                         : feature_of(g, row, col - g.F);
  }
}

// One CTA: the G queries [blockIdx.x * G, +G) of Q, each of D slots.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 4)
    sentinel_features_kernel(const float* __restrict__ X,
                             const float* __restrict__ partial,
                             const uint8_t* __restrict__ mask,
                             float* __restrict__ out, int Q, int D, int F,
                             int G) {
  __shared__ float cols[kColChunk];
  __shared__ int ranks[kRowChunk];
  __shared__ float q_lo[kThreads], q_hi[kThreads];  // G <= kThreads
  __shared__ int q_n[kThreads];
  __shared__ float w_lo[kWarps], w_hi[kWarps];
  __shared__ int w_n[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q0 = static_cast<long long>(blockIdx.x) * G;
  const int Gv = static_cast<int>(min(static_cast<long long>(G), Q - q0));
  const long long slot0 = q0 * D;
  const float* p = partial + slot0;
  const uint8_t* m = mask + slot0;

  // min, max and count of the real slots: nq queries at a time, wq warps
  // each, warp shuffles, then the wq warps' results in order.
  const int nq = min(Gv, kWarps), wq = kWarps / nq;
  const int grp = warp / wq, sub = warp - grp * wq;
  for (int g0 = 0; g0 < Gv; g0 += nq) {
    const int q = g0 + grp;
    float lo = INFINITY, hi = -INFINITY;
    int n = 0;
    if (grp < nq && q < Gv) {
      for (int j = sub * 32 + lane; j < D; j += wq * 32) {
        const long long at = static_cast<long long>(q) * D + j;
        const float v = p[at];
        if (m[at]) {
          lo = min_nan(lo, v);
          hi = max_nan(hi, v);
          ++n;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      lo = min_nan(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max_nan(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      n += __shfl_xor_sync(0xffffffffu, n, o);
    }
    if (lane == 0) {
      w_lo[warp] = lo;
      w_hi[warp] = hi;
      w_n[warp] = n;
    }
    __syncthreads();
    if (tid < nq && g0 + tid < Gv) {
      float l = w_lo[tid * wq], h = w_hi[tid * wq];
      int c = w_n[tid * wq];
      for (int w = 1; w < wq; ++w) {
        l = min_nan(l, w_lo[tid * wq + w]);
        h = max_nan(h, w_hi[tid * wq + w]);
        c += w_n[tid * wq + w];
      }
      q_lo[g0 + tid] = l;
      q_hi[g0 + tid] = h;
      q_n[g0 + tid] = c;
    }
    __syncthreads();
  }

  Group g{X + slot0 * F, p, m, out + slot0 * (F + 4), D, F, q_lo, q_hi, q_n,
          ranks, 0};
  const int n_rows = Gv * D;  // the group's rows, flattened
  for (int r0 = 0; r0 < n_rows; r0 += kRowChunk) {
    const int r1 = min(r0 + kRowChunk, n_rows);
    for (int rr = r0 + tid; rr < r1; rr += kThreads) ranks[rr - r0] = 0;
    // The slots these rows are compared with: their queries' whole lists.
    const int c_begin = (r0 / D) * D, c_end = ((r1 - 1) / D + 1) * D;
    for (int c0 = c_begin; c0 < c_end; c0 += kColChunk) {
      const int c1 = min(c0 + kColChunk, c_end);
      __syncthreads();  // the last chunk's readers are done
      for (int c = c0 + tid; c < c1; c += kThreads) {
        cols[c - c0] = m[c] ? p[c] : kNeg;
      }
      __syncthreads();
      for (int rr = r0 + tid; rr < r1; rr += kThreads) {
        if (!m[rr]) continue;
        const int q_start = (rr / D) * D;
        const float r = p[rr];
        const int j0 = max(c0, q_start), j1 = min(c1, q_start + D);
        int cnt = 0;
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const float c = cols[j - c0];
          cnt += (c > r) | ((c == r) & (j < rr));
        }
        ranks[rr - r0] += cnt;
      }
    }
    __syncthreads();
    g.r0 = r0;
    if (kVec) {
      copy_rows_vec(g, r1);
    } else {
      copy_rows_scalar(g, r1);
    }
    __syncthreads();  // the counts are read before the next chunk resets them
  }
}

}  // namespace

// X [Q, D, F] float32, partial [Q, D] float32, mask [Q, D] bool (one byte,
// nonzero = real), all contiguous, into out [Q, D, F + 4] float32, on
// `stream`. Shapes are checked by the Python wrapper. Returns the
// cudaError_t of the launch (0 when Q or D is 0: nothing to launch).
extern "C" int sentinel_features(const float* X, const float* partial,
                                 const uint8_t* mask, float* out, int Q, int D,
                                 int F, void* stream) {
  if (Q < 0 || D < 0 || F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0 || D == 0) return 0;
  const int G = D <= kThreads / 2 ? kThreads / D : 1;
  const int grid = (Q + G - 1) / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    sentinel_features_kernel<true>
        <<<grid, kThreads, 0, s>>>(X, partial, mask, out, Q, D, F, G);
  } else {
    sentinel_features_kernel<false>
        <<<grid, kThreads, 0, s>>>(X, partial, mask, out, Q, D, F, G);
  }
  return static_cast<int>(cudaGetLastError());
}
