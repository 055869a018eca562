// Forest scoring for Hopper (sm_90a): the two QuickScorer kernels of the
// LEAR serving path, with a plain C interface loaded through ctypes by
// repro_torch/kernels/forest_score.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/forest_score.py:
//   forest_score_range     <- forest_score_pallas          (:318, body :240-261)
//   forest_score_segments  <- forest_score_segments_pallas (:367, body :264-291)
// Both share the block body _score_block (:199-237).
//
// What they compute. For every document b and every tree t of a run of
// tree blocks (block_t trees each): gather x[b, feature[t, n]] for every
// node n, AND together the 64-bit false-node masks of the nodes whose test
// x <= threshold fails, take the lowest set bit as the exit leaf, and read
// leaf_value[t, leaf]. The block_t values of one tree block are summed by
// the reference's contiguous-halves chain (_pairwise_tree_sum:
// v[i] + v[i + h] for h = block_t/2, ..., 1); blocks are added in order into
// an accumulator that starts at 0. The segmented kernel starts a new
// accumulator (a new output column) at every seg_block_starts entry. The
// order of every float addition is the reference's, and there is no
// multiply, so there is nothing to contract into an FMA: the result is
// bit-exact with the plain PyTorch version.
//
// Differences from the TPU kernel, on purpose:
// - The feature gather is a true indexed load. The Pallas kernel gathers by
//   a one-hot matmul, where one NaN or inf feature poisons every node of the
//   document; here a non-finite feature affects only the nodes that test it,
//   as in the reference's own oracles (kernels/ref.py, score_bitvector).
// - The mask is one uint64 (the port's int64 pattern), and ctz is __ffsll.
// - The three leaf-gather variants of the TPU kernel (one-hot, select tree,
//   MXU) all move the same values; on the card they are one shared-memory
//   load.
//
// What bounds it on this card. Each (doc, tree, node) is about five integer
// and fp32 operations (feature load, x load, compare, select, 64-bit AND).
// At the lear-msn1 shapes (B = 2048 docs, 1072 padded trees of 64 nodes)
// that is about 0.7 G operations, against about 1.1 MB of x and 1.4 MB of
// tree tables, which stay in L2. So it is bound by operations (instruction
// throughput), not by HBM bytes.
//
// What the design does about that. One thread evaluates one (document,
// tree) pair, so a CTA of 128 threads holds 128 / block_t documents and the
// grid has B * block_t / 128 CTAs (256 at the lear-msn1 shape: enough to
// fill 132 SMs, where one thread per document would give 16 CTAs). The
// tables of the current tree block are staged in shared memory, node tables
// transposed to [node][tree] so that the block_t threads of a document read
// consecutive words and the documents of a warp read the same words
// (broadcast). The contiguous-halves sum is done with __shfl_down_sync
// inside the block_t lanes of a document, which keeps the reference's order
// without shared-memory traffic. No atomics and no cross-CTA reduction: the
// kernel is deterministic. Staging the document tile by TMA, several trees
// per thread and a persistent grid are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSegments = 16;

struct SegStarts {
  int start[kMaxSegments];
};

template <bool kSegmented>
__global__ void __launch_bounds__(kThreads) forest_score_kernel(
    const float* __restrict__ x, int B, int F,
    const int* __restrict__ feature, const float* __restrict__ threshold,
    const unsigned long long* __restrict__ mask,
    const float* __restrict__ leaf_value, int N, int L, int block_t,
    int block_lo, int n_blocks, SegStarts seg, int n_seg,
    float* __restrict__ out) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* s_mask = smem;                       // [N][block_t]
  int* s_feat = reinterpret_cast<int*>(s_mask + block_t * N);
  float* s_thr = reinterpret_cast<float*>(s_feat + block_t * N);
  float* s_leaf = s_thr + block_t * N;                     // [block_t][L]

  const int t = threadIdx.x % block_t;
  const int doc = blockIdx.x * (kThreads / block_t) + threadIdx.x / block_t;
  const bool valid = doc < B;
  // Lanes past the last document compute on document 0 and write nothing:
  // every lane must take part in the shuffles below.
  const float* xd = x + static_cast<size_t>(valid ? doc : 0) * F;

  float acc = 0.0f;
  int cur_seg = 0;
  for (int j = 0; j < n_blocks; ++j) {
    const size_t tree0 = static_cast<size_t>(block_lo + j) * block_t;
    __syncthreads();  // the previous tree block's tables are no longer read
    for (int i = threadIdx.x; i < block_t * N; i += kThreads) {
      const int tt = i / N;
      const int n = i - tt * N;
      const size_t g = tree0 * N + i;
      s_feat[n * block_t + tt] = feature[g];
      s_thr[n * block_t + tt] = threshold[g];
      s_mask[n * block_t + tt] = mask[g];
    }
    for (int i = threadIdx.x; i < block_t * L; i += kThreads) {
      s_leaf[i] = leaf_value[tree0 * L + i];
    }
    __syncthreads();

    unsigned long long m = ~0ull;
    for (int n = 0; n < N; ++n) {
      const int k = n * block_t + t;
      const float v = __ldg(xd + s_feat[k]);
      if (!(v <= s_thr[k])) m &= s_mask[k];  // NaN fails the test, as in the oracle
    }
    // m != 0 for a valid ensemble (the exit leaf's bit survives every AND);
    // the clamp only keeps a malformed ensemble's read inside the table.
    const int leaf = min(max(__ffsll(static_cast<long long>(m)) - 1, 0), L - 1);
    float v = s_leaf[t * L + leaf];
    for (int h = block_t >> 1; h > 0; h >>= 1) {
      v = v + __shfl_down_sync(0xffffffffu, v, h, block_t);
    }

    if (kSegmented) {
      int s = 0;
      for (int k = 1; k < n_seg; ++k) s += (j >= seg.start[k]);
      if (s != cur_seg) {
        if (t == 0 && valid) out[static_cast<size_t>(doc) * n_seg + cur_seg] = acc;
        acc = 0.0f;
        cur_seg = s;
      }
    }
    acc = acc + v;
  }
  if (t == 0 && valid) {
    out[kSegmented ? static_cast<size_t>(doc) * n_seg + cur_seg : doc] = acc;
  }
}

size_t smem_bytes(int N, int L, int block_t) {
  return static_cast<size_t>(block_t) * N *
             (sizeof(unsigned long long) + sizeof(int) + sizeof(float)) +
         static_cast<size_t>(block_t) * L * sizeof(float);
}

template <bool kSegmented>
int launch(const float* x, int B, int F, const int* feature,
           const float* threshold, const unsigned long long* mask,
           const float* leaf_value, int N, int L, int block_t, int block_lo,
           int n_blocks, const SegStarts& seg, int n_seg, float* out,
           void* stream) {
  const int docs_per_cta = kThreads / block_t;
  const int grid = (B + docs_per_cta - 1) / docs_per_cta;
  forest_score_kernel<kSegmented>
      <<<grid, kThreads, smem_bytes(N, L, block_t),
         static_cast<cudaStream_t>(stream)>>>(
          x, B, F, feature, threshold, mask, leaf_value, N, L, block_t,
          block_lo, n_blocks, seg, n_seg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scores x [B, F] through tree blocks [block_lo, block_lo + n_blocks) of
// the padded tables (feature/threshold/mask [T, N], leaf_value [T, L]) into
// out [B]. Shapes are checked by the Python wrapper. Returns the
// cudaError_t of the launch.
extern "C" int forest_score_range(const float* x, int B, int F,
                                  const int* feature, const float* threshold,
                                  const unsigned long long* mask,
                                  const float* leaf_value, int N, int L,
                                  int block_t, int block_lo, int n_blocks,
                                  float* out, void* stream) {
  SegStarts seg = {};
  return launch<false>(x, B, F, feature, threshold, mask, leaf_value, N, L,
                       block_t, block_lo, n_blocks, seg, 1, out, stream);
}

// Scores x [B, F] through tree blocks [0, n_blocks) into out [B, n_seg]:
// column k sums the blocks [seg_block_starts[k], seg_block_starts[k + 1]).
// seg_block_starts is a host array of n_seg <= 16 ascending entries, the
// first 0. Returns the cudaError_t of the launch.
extern "C" int forest_score_segments(
    const float* x, int B, int F, const int* feature, const float* threshold,
    const unsigned long long* mask, const float* leaf_value, int N, int L,
    int block_t, int n_blocks, const int* seg_block_starts, int n_seg,
    float* out, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SegStarts seg = {};
  for (int k = 0; k < n_seg; ++k) seg.start[k] = seg_block_starts[k];
  return launch<true>(x, B, F, feature, threshold, mask, leaf_value, N, L,
                      block_t, 0, n_blocks, seg, n_seg, out, stream);
}
