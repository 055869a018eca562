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
// What bounds it on this card. A node test is a few integer and fp32
// instructions (address, compare, two 32-bit ANDs) behind two shared-memory
// reads: the node record and x[b, feature]. The tables of a tail launch
// (~1.3 MB) and the documents (~1.1 MB at B = 2048) stay in L2, so HBM bytes
// do not bound it; the shared-memory pipe, instruction issue and, above
// all, the latency of the record -> address -> x -> compare chain do. The
// first design (one thread per (document, tree), 8 documents per staged
// tree block, x read from global memory at a data-dependent address) spent
// four memory instructions per node test, restaged the tables for every 8
// documents, and launched fewer CTAs than SMs at the tail's compacted sizes.
//
// What the design does about that.
// - Documents on the lanes: a warp scores 32 * kDocsPerLane documents
//   against one tree at a time, so the node record is a warp-uniform
//   broadcast: one LDS.128 of the packed 16-byte record {feature, threshold,
//   mask} serves the kDocsPerLane x reads that follow it (two documents per
//   lane: 1.5 shared reads per document and node).
// - The CTA's document tile is staged once in shared memory, feature-major
//   with an odd row stride (xs[f * (tile + 1) + doc], by cp.async), so the
//   gather xs[feature][lane] is one conflict-free wavefront.
// - Tree blocks stream through a ring of kStages shared-memory stages, each
//   filled by two 1-D bulk copies (cp.async.bulk: the block's node records
//   and its leaf row, both contiguous) that complete on an mbarrier. Every
//   warp of the CTA reads each stage.
// - The trees of a block are split over warps_t warps (tree t goes to warp
//   t % warps_t), so a CTA has up to 8 warps for the latency chain to hide
//   behind without a wider document tile. block_t is a template parameter:
//   each lane keeps its trees' leaf values in registers and runs the
//   contiguous-halves chain there for the levels that pair trees of one
//   warp; the last log2(warps_t) levels pair the warps' sums through
//   shared memory, in the same order.
// - The grid is (document tiles) x (chunks of tree blocks), sized from B and
//   n_blocks to one wave of resident CTAs: the document tile is the widest
//   (4, 2 or 1 warps) that fits twice on an SM and still gives a grid of a
//   wave, and the tree-block range is cut into chunks to fill it. With one chunk, a CTA adds its blocks in order
//   in registers. With several, each writes its per-block partial sums into
//   a scratch buffer partials[n_blocks][B], and the last CTA of a document
//   tile to finish (__threadfence, then an arrival counter) adds them in
//   order into accumulators that start at 0, with a new output column at
//   each segment start. One launch per call; the counters are an integer per
//   tile that the last CTA resets to 0, so they need no clearing between
//   launches on one stream. No atomics on values: deterministic.
//
// The gated tail. With query-level exit the survivor count of the last
// compaction decides whether the tail has any work, and the host may not
// read it. forest_score_range therefore takes an optional device pointer
// n_valid: rows at or past *n_valid are written 0.0f. A launch given one
// runs its own instantiation (kGated), so the ungated kernel compiles
// without the count (one body for both ran the ungated launches 3-4%
// slower on an H100). In the gated one a CTA whose document
// tile starts at or past the count writes its zeros and returns before it
// stages anything, touches the partials or the arrival counter; the count
// is read per tile, so every CTA of a tile takes the same branch and the
// last-CTA reduction stays consistent. Rows below the count are computed
// exactly as in the ungated launch (the count only selects what is
// written), so they are bit-identical to it. A batch whose queries all
// converged costs one launch of zero-writing CTAs and no tree work. The
// gated launch takes the ungated launch's plan (made from the ungated
// kernel's occupancy). It loads the count before the barrier setup, which
// hides the load's latency, and again where it writes its rows: kept live
// across the tree loop, the count changed that loop's code and cost 4-6%
// on an H100 at a full count.
//
// The host side keeps the launch cheap: the plan of each shape is made once
// (its occupancy queries included) and cached per device, and the
// shared-memory opt-in is raised once per kernel pair and device. The layout of
// a CTA's shared memory lives here alone: the wrapper asks
// forest_score_max_features for the widest x it may pass.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kMaxSegments = 16;
constexpr int kDocsPerLane = 2;   // documents per lane (1 and 4 measured slower)
constexpr int kStages = 2;        // tree-block ring stages (3 measured slower)
constexpr int kMaxDevices = 64;
constexpr size_t kMaxPlans = 4096;  // cached plans per kernel, then cleared
constexpr int kMaxDocWarps = 4;   // warps side by side on documents
constexpr int kMaxTreeWarps = 8;  // warps side by side on the trees of a block
constexpr int kMaxWarps = 8;      // per CTA: doc warps x tree warps
constexpr int kThreads = 32 * kMaxWarps;

// Launch plans made so far, over every kernel and device (a gated launch
// shares the ungated plan of its shape): each is a first-touch cost
// (occupancy queries, and the shared-memory opt-in of a kernel and its gated
// twin with their first plan on a device) that warmup pays ahead of traffic.
std::atomic<int> g_plans_made{0};

// One node: {feature, threshold bits, false-node mask low word, high word},
// read as one 16-byte shared-memory load.
using Node = int4;

struct SegStarts {
  int start[kMaxSegments];
};

// ---------------------------------------------------------------------------
// Shared-memory copies and barriers (PTX).
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared; `bytes` and both addresses are multiples
// of 16. Completion is counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The gated tail's survivor count, read past L1. Volatile, so that the
// compiler neither merges two reads nor moves one across the tree loop.
__device__ __forceinline__ int load_count(const int* p) {
  int v;
  asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// ---------------------------------------------------------------------------
// The kernel.
// ---------------------------------------------------------------------------

// Bytes of one ring stage: block_t * N node records, then block_t * L4 leaf
// values (L4 = the leaf axis rounded up to 4, so both parts are multiples
// of 16 bytes).
__host__ __device__ inline uint32_t stage_bytes(int block_t, int N, int L4) {
  return static_cast<uint32_t>(block_t) * N * sizeof(Node) +
         static_cast<uint32_t>(block_t) * L4 * sizeof(float);
}

// grid = (document tiles, tree-block chunks); blockDim = 32 * warps_d *
// warps_t. Warp w works on documents (w % warps_d) and on the trees t of
// each block with t % warps_t == w / warps_d. A tile holds 32 * warps_d *
// kDocsPerLane documents. kGated: rows at or past *n_valid are 0.
template <int BT, bool kSegmented, bool kGated>
__global__ void __launch_bounds__(kThreads) forest_score_kernel(
    const float* __restrict__ x, int B, int F, const Node* __restrict__ nodes,
    const float* __restrict__ leaves, int N, int L, int L4, int block_lo,
    int n_blocks, int chunk, int warps_d, SegStarts seg, int n_seg,
    float* __restrict__ partials, unsigned int* __restrict__ arrivals,
    float* __restrict__ out, const int* __restrict__ n_valid) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ int last_arrival;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps_t = (blockDim.x >> 5) / warps_d;
  const int wd = warp % warps_d;
  const int wt = warp / warps_d;
  const int tile = 32 * warps_d * kDocsPerLane;
  const int xstride = tile + 1;  // odd: conflict-free transposed writes and reads
  const int doc0 = blockIdx.x * tile;
  static_assert(!(kGated && kSegmented), "only the range kernel is gated");
  // The count's load is issued here and first used after the barrier
  // setup below, so its latency overlaps that setup.
  int count = 0;
  if constexpr (kGated) count = load_count(n_valid);
  const uint32_t sbytes = stage_bytes(BT, N, L4);
  float* xs = reinterpret_cast<float*>(smem + kStages * sbytes);
  float* red = xs + F * xstride;  // [2][warps_t][tile] when warps_t > 1

  const int j_begin = blockIdx.y * chunk;
  const int nj = min(chunk, n_blocks - j_begin);
  const bool one_chunk = gridDim.y == 1;

  auto issue = [&](int i) {  // fill stage i % kStages with tree block j_begin + i
    const int s = i % kStages;
    const size_t tree0 = static_cast<size_t>(block_lo + j_begin + i) * BT;
    unsigned char* dst = smem + s * sbytes;
    mbar_expect_tx(&full[s], sbytes);
    bulk_copy(dst, nodes + tree0 * N, BT * N * sizeof(Node), &full[s]);
    bulk_copy(dst + BT * N * sizeof(Node), leaves + tree0 * L4,
              BT * L4 * sizeof(float), &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if constexpr (kGated) {
    if (doc0 >= max(0, min(count, B))) {  // the whole tile is past the count: zeros, no tree work
      if (blockIdx.y == 0) {
        for (int d = tid; d < tile && doc0 + d < B; d += blockDim.x) out[doc0 + d] = 0.0f;
      }
      return;
    }
  }
  if (tid == 0) {
    for (int i = 0; i < min(kStages, nj); ++i) issue(i);
  }

  // The document tile, transposed: xs[f * xstride + d] = x[doc0 + d, f]
  // (zeros past B). Lanes walk the features of one document: coalesced.
  for (int d = warp; d < tile; d += blockDim.x >> 5) {
    const int doc = doc0 + d;
    const float* row = x + static_cast<size_t>(doc < B ? doc : 0) * F;
    const uint32_t n = doc < B ? 4u : 0u;
    for (int f = lane; f < F; f += 32) cp_async4(xs + f * xstride + d, row + f, n);
  }
  cp_async_wait_all();
  __syncthreads();

  // This lane's documents: d_lane + 32 * k, k < kDocsPerLane.
  const int d_lane = wd * 32 * kDocsPerLane + lane;
  const int q_count = BT / warps_t;  // trees of each block this warp scores
  float acc[kDocsPerLane];           // one_chunk: the running sum
#pragma unroll
  for (int k = 0; k < kDocsPerLane; ++k) acc[k] = 0.0f;
  int col = 0;
  int next = kSegmented && n_seg > 1 ? seg.start[1] : n_blocks;

  for (int i = 0; i < nj; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const Node* sn = reinterpret_cast<const Node*>(smem + s * sbytes);
    const float* sl = reinterpret_cast<const float*>(smem + s * sbytes +
                                                     BT * N * sizeof(Node));

    // v[k][q]: the leaf value of tree wt + warps_t * q for document k.
    float v[kDocsPerLane][BT];
#pragma unroll
    for (int q = 0; q < BT; ++q) {
      if (q < q_count) {
        const int t = wt + warps_t * q;
        uint32_t m_lo[kDocsPerLane], m_hi[kDocsPerLane];
#pragma unroll
        for (int k = 0; k < kDocsPerLane; ++k) m_lo[k] = m_hi[k] = ~0u;
        const Node* tn = sn + t * N;
#pragma unroll 8
        for (int n = 0; n < N; ++n) {
          const Node r = tn[n];  // warp-uniform: one broadcast LDS.128
          const float* xf = xs + r.x * xstride + d_lane;
          const float thr = __int_as_float(r.y);
#pragma unroll
          for (int k = 0; k < kDocsPerLane; ++k) {
            if (!(xf[32 * k] <= thr)) {  // NaN fails the test, as in the oracle
              m_lo[k] &= static_cast<uint32_t>(r.z);
              m_hi[k] &= static_cast<uint32_t>(r.w);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kDocsPerLane; ++k) {
          // The lowest set bit is the exit leaf. m != 0 for a valid ensemble
          // (the exit leaf's bit survives every AND); the clamp only keeps a
          // malformed ensemble's read in the row.
          const int bit = m_lo[k] ? __ffs(m_lo[k]) - 1 : 31 + __ffs(m_hi[k]);
          v[k][q] = sl[t * L4 + min(max(bit, 0), L - 1)];
        }
      }
    }
    // The reference's contiguous-halves chain: its levels h >= warps_t pair
    // trees of one warp (q and q + h / warps_t), in registers ...
#pragma unroll
    for (int h = BT / 2; h > 0; h /= 2) {
      if (h < q_count) {
#pragma unroll
        for (int k = 0; k < kDocsPerLane; ++k) {
#pragma unroll
          for (int q = 0; q < h; ++q) v[k][q] = v[k][q] + v[k][q + h];
        }
      }
    }
    // ... and its last log2(warps_t) levels pair the warps' sums, through
    // shared memory (double-buffered: the next write to this half follows
    // the next iteration's barrier, which the readers reach after reading).
    float* red_i = red + (i & 1) * warps_t * tile;
    if (warps_t > 1) {
#pragma unroll
      for (int k = 0; k < kDocsPerLane; ++k) {
        red_i[wt * tile + d_lane + 32 * k] = v[k][0];
      }
    }
    __syncthreads();  // every warp is done with stage s; red_i is complete
    if (tid == 0 && i + kStages < nj) issue(i + kStages);
    if (wt != 0) continue;

#pragma unroll
    for (int k = 0; k < kDocsPerLane; ++k) {
      float p = v[k][0];
      if (warps_t > 1) {
        float u[kMaxTreeWarps];
#pragma unroll
        for (int w = 0; w < kMaxTreeWarps; ++w) {
          if (w < warps_t) u[w] = red_i[w * tile + d_lane + 32 * k];
        }
#pragma unroll
        for (int h = kMaxTreeWarps / 2; h > 0; h /= 2) {
          if (h < warps_t) {
#pragma unroll
            for (int w = 0; w < h; ++w) u[w] = u[w] + u[w + h];
          }
        }
        p = u[0];
      }
      const int doc = doc0 + d_lane + 32 * k;
      if (!one_chunk) {
        if (doc < B) partials[static_cast<size_t>(j_begin + i) * B + doc] = p;
        continue;
      }
      // One chunk holds every block: add in order here. A new segment
      // starts a new column (block i == j here).
      if (kSegmented && i == next) {
        if (doc < B) out[static_cast<size_t>(doc) * n_seg + col] = acc[k];
        acc[k] = 0.0f;
      }
      acc[k] = acc[k] + p;
    }
    if (kSegmented && one_chunk && i == next) {
      ++col;
      next = col + 1 < n_seg ? seg.start[col + 1] : n_blocks;
    }
  }

  // Rows at or past the count are written 0.0f; ungated, it is B and the
  // selects below fold away. The gated kernel loads the count again where
  // it writes rather than keep it live across the tree loop, whose code
  // then matches the ungated kernel's.
  auto valid_rows = [&] { return kGated ? max(0, min(load_count(n_valid), B)) : B; };
  if (one_chunk) {
    if (wt == 0) {
      const int nv = valid_rows();
#pragma unroll
      for (int k = 0; k < kDocsPerLane; ++k) {
        const int doc = doc0 + d_lane + 32 * k;
        if (doc < B) {
          out[kSegmented ? static_cast<size_t>(doc) * n_seg + col : doc] =
              doc < nv ? acc[k] : 0.0f;
        }
      }
    }
    return;
  }

  // The last CTA of this document tile adds the partials of every block in
  // order. The fence makes this CTA's partials visible before its arrival.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last_arrival = atomicAdd(arrivals + blockIdx.x, 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (!last_arrival) return;
  __threadfence();
  const int nv = valid_rows();
  for (int d = tid; d < tile; d += blockDim.x) {
    const int doc = doc0 + d;
    if (doc >= B) break;
    float sum = 0.0f;
    int c = 0;
    int nxt = kSegmented && n_seg > 1 ? seg.start[1] : n_blocks;
    for (int j = 0; j < n_blocks; ++j) {
      if (kSegmented && j == nxt) {
        out[static_cast<size_t>(doc) * n_seg + c] = sum;
        sum = 0.0f;
        ++c;
        nxt = c + 1 < n_seg ? seg.start[c + 1] : n_blocks;
      }
      sum = sum + __ldcg(partials + static_cast<size_t>(j) * B + doc);
    }
    out[kSegmented ? static_cast<size_t>(doc) * n_seg + c : doc] =
        doc < nv ? sum : 0.0f;
  }
  if (tid == 0) arrivals[blockIdx.x] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// Launch plan: tile width, tree split and chunking from B and n_blocks.
// ---------------------------------------------------------------------------

struct Plan {
  int warps_d;   // warps on documents: tile = 32 * warps_d * kDocsPerLane
  int warps_t;   // warps on the trees of a block
  int chunk;     // tree blocks per CTA
  int n_tiles;   // grid.x
  int n_chunks;  // grid.y
  size_t smem;   // dynamic shared memory per CTA
  int per_sm;    // resident CTAs per SM
};

size_t smem_for(int warps_d, int warps_t, int F, int N, int L4, int block_t) {
  const size_t tile = 32 * warps_d * kDocsPerLane;
  return static_cast<size_t>(kStages) * stage_bytes(block_t, N, L4) +
         static_cast<size_t>(F) * (tile + 1) * sizeof(float) +
         (warps_t > 1 ? 2 * warps_t * tile * sizeof(float) : 0);
}

// Raises `kernel`'s dynamic shared-memory limit on device `dev` to the
// device's opt-in maximum (227 KB on an H100) less its static shared memory.
template <typename Kernel>
void raise_smem_limit(Kernel kernel, int dev) {
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kernel);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       optin - static_cast<int>(attr.sharedSizeBytes));
}

// The current device, once the shared-memory limits of the kernel and of
// its gated twin (the range kernel's) are raised on it: once per kernel and
// device, with the first plan or limit query.
template <int BT, bool kSegmented>
int current_device(int* dev) {
  static std::once_flag raised[kMaxDevices];
  if (cudaGetDevice(dev) != cudaSuccess || *dev < 0 || *dev >= kMaxDevices) {
    cudaGetLastError();
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  std::call_once(raised[*dev], [dev] {
    raise_smem_limit(forest_score_kernel<BT, kSegmented, false>, *dev);
    if (!kSegmented) raise_smem_limit(forest_score_kernel<BT, false, true>, *dev);
  });
  return 0;
}

// Resident CTAs per SM of `kernel` at `warps` and `smem`; 0 if it does not fit.
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int warps, size_t smem) {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32 * warps,
                                                    smem) != cudaSuccess) {
    cudaGetLastError();  // a refused size is a 0, not a sticky error
    return 0;
  }
  return n;
}

// Up to kMaxWarps warps per CTA: warps_d side by side on documents, the
// rest (warps_t <= block_t) on the trees of a block. warps_d is the widest
// whose CTA still fits twice on an SM and whose grid holds one wave of
// resident CTAs (else the narrowest that fits); the tree-block range is
// then cut into chunks so that the grid is at most one wave. A request > 0
// forces warps_d, warps_t or the chunk (tests and tuning).
template <typename Kernel>
int make_plan(Kernel kernel, int dev, int B, int F, int N, int L4, int block_t,
              int n_blocks, int warps_d_req, int warps_t_req, int chunk_req,
              Plan* p) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) sms = 1;
  bool found = false;
  for (int wd = kMaxDocWarps; wd >= 1; wd /= 2) {
    if (warps_d_req > 0 && wd != warps_d_req) continue;
    // The most tree warps that fit beside this tile (or the forced number).
    int wt = warps_t_req > 0
                 ? warps_t_req
                 : min(block_t, min(kMaxTreeWarps, kMaxWarps / wd));
    if (wt > block_t || wd * wt > kMaxWarps || (wt & (wt - 1))) continue;
    size_t smem = smem_for(wd, wt, F, N, L4, block_t);
    int per_sm = ctas_per_sm(kernel, wd * wt, smem);
    while (per_sm == 0 && wt > 1 && warps_t_req <= 0) {
      wt /= 2;
      smem = smem_for(wd, wt, F, N, L4, block_t);
      per_sm = ctas_per_sm(kernel, wd * wt, smem);
    }
    if (per_sm == 0) continue;
    const int tile = 32 * wd * kDocsPerLane;
    *p = Plan{wd, wt, 0, (B + tile - 1) / tile, 0, smem, per_sm};
    found = true;
    if (per_sm >= 2 && static_cast<long long>(p->n_tiles) * n_blocks >=
                           static_cast<long long>(sms) * per_sm) {
      break;
    }
  }
  if (!found) return static_cast<int>(cudaErrorInvalidConfiguration);
  int chunk = chunk_req;
  if (chunk <= 0) {
    const long long slots = static_cast<long long>(sms) * p->per_sm;
    const long long fit = slots / p->n_tiles;  // chunks per tile in one wave
    const long long want = fit > 0 ? fit : 1;
    chunk = static_cast<int>((n_blocks + want - 1) / want);
  }
  p->chunk = chunk < 1 ? 1 : (chunk > n_blocks ? n_blocks : chunk);
  p->n_chunks = (n_blocks + p->chunk - 1) / p->chunk;
  return p->n_chunks > 65535 ? static_cast<int>(cudaErrorInvalidConfiguration)
                             : 0;
}

struct Args {
  const float* x;
  int B, F;
  const Node* nodes;
  const float* leaves;
  int N, L, L4, block_t, block_lo, n_blocks;
  SegStarts seg;
  int n_seg;
  float* partials;
  unsigned int* arrivals;
  float* out;
  const int* n_valid;  // device pointer, or null: every row is valid
  int warps_d_req, warps_t_req, chunk_req;
};

// The plan of each (device, shape, forced plan), made at its first launch
// from the ungated kernel. The gated kernel shares it: the gate changes no
// plan, so a gated launch runs on the grid of the ungated one at its shape.
template <int BT, bool kSegmented>
int plan_for(const Args& a, Plan* p) {
  int dev = 0;
  if (const int err = current_device<BT, kSegmented>(&dev)) return err;
  using Key = std::tuple<int, int, int, int, int, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, Plan> plans;
  const Key key{dev, a.B, a.F, a.N, a.L4, a.n_blocks,
                a.warps_d_req, a.warps_t_req, a.chunk_req};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = plans.find(key);
  if (it != plans.end()) {
    *p = it->second;
    return 0;
  }
  const int err = make_plan(forest_score_kernel<BT, kSegmented, false>, dev,
                            a.B, a.F, a.N, a.L4, BT, a.n_blocks, a.warps_d_req,
                            a.warps_t_req, a.chunk_req, p);
  if (err) return err;
  if (plans.size() >= kMaxPlans) plans.clear();
  plans.emplace(key, *p);
  g_plans_made.fetch_add(1);
  return 0;
}

template <int BT, bool kSegmented, bool kGated>
int launch_bt(const Args& a, cudaStream_t stream, Plan* plan, bool run) {
  Plan p;
  if (const int err = plan_for<BT, kSegmented>(a, &p)) return err;
  if (plan) *plan = p;
  if (!run) return 0;
  forest_score_kernel<BT, kSegmented, kGated>
      <<<dim3(p.n_tiles, p.n_chunks), 32 * p.warps_d * p.warps_t, p.smem,
         stream>>>(a.x, a.B, a.F, a.nodes, a.leaves, a.N, a.L, a.L4,
                   a.block_lo, a.n_blocks, p.chunk, p.warps_d, a.seg,
                   a.n_seg, a.partials, a.arrivals, a.out, a.n_valid);
  return static_cast<int>(cudaGetLastError());
}

// The widest x (features) whose narrowest CTA (one warp, no tree split)
// still fits an SM beside the ring of `BT`-tree blocks: every plan keeps a
// CTA that fits at such an F (make_plan shrinks the tree warps).
template <int BT, bool kSegmented>
int max_features_bt(int N, int L4, int* max_f) {
  // The gated instantiation has the same shared-memory layout.
  auto kernel = forest_score_kernel<BT, kSegmented, false>;
  int dev = 0;
  if (const int err = current_device<BT, kSegmented>(&dev)) return err;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  const long long ring = static_cast<long long>(smem_for(1, 1, 0, N, L4, BT));
  const long long per_f =
      static_cast<long long>(smem_for(1, 1, 1, N, L4, BT)) - ring;
  long long f = (attr.maxDynamicSharedSizeBytes - ring) / per_f;
  if (f < 0) f = 0;
  while (f > 0 &&
         ctas_per_sm(kernel, 1, smem_for(1, 1, static_cast<int>(f), N, L4, BT)) == 0) {
    --f;
  }
  *max_f = static_cast<int>(f);
  return 0;
}

template <bool kSegmented>
int max_features(int N, int L4, int block_t, int* max_f) {
  switch (block_t) {
    case 1: return max_features_bt<1, kSegmented>(N, L4, max_f);
    case 2: return max_features_bt<2, kSegmented>(N, L4, max_f);
    case 4: return max_features_bt<4, kSegmented>(N, L4, max_f);
    case 8: return max_features_bt<8, kSegmented>(N, L4, max_f);
    case 16: return max_features_bt<16, kSegmented>(N, L4, max_f);
    case 32: return max_features_bt<32, kSegmented>(N, L4, max_f);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kSegmented, bool kGated = false>
int launch(const Args& a, void* stream, Plan* plan, bool run) {
  if (a.B < 1 || a.F < 1 || a.n_blocks < 1 || a.L < 1 || a.L4 % 4 ||
      a.n_seg < 1 || a.n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.block_t) {
    case 1: return launch_bt<1, kSegmented, kGated>(a, s, plan, run);
    case 2: return launch_bt<2, kSegmented, kGated>(a, s, plan, run);
    case 4: return launch_bt<4, kSegmented, kGated>(a, s, plan, run);
    case 8: return launch_bt<8, kSegmented, kGated>(a, s, plan, run);
    case 16: return launch_bt<16, kSegmented, kGated>(a, s, plan, run);
    case 32: return launch_bt<32, kSegmented, kGated>(a, s, plan, run);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scores x [B, F] through tree blocks [block_lo, block_lo + n_blocks) of the
// packed tables (nodes [T, N] 16-byte records, leaves [T, L4] with L4 a
// multiple of 4 and L real leaves) into out [B]. partials is scratch of
// n_blocks * B floats; arrivals holds at least ceil(B / 32) zeros and is
// left zeroed. n_valid, when not null, is a device int read by the kernel:
// rows at or past it are written 0 (the gated tail; see the header).
// warps_d / warps_t / chunk > 0 force the tile's warps, the tree warps and
// the tree blocks per CTA (0: chosen from B and n_blocks). Shapes are
// checked by the Python wrapper. Returns the cudaError_t of the launch.
extern "C" int forest_score_range(const float* x, int B, int F,
                                  const void* nodes, const float* leaves,
                                  int N, int L, int L4, int block_t,
                                  int block_lo, int n_blocks, float* partials,
                                  unsigned int* arrivals, float* out,
                                  const int* n_valid, int warps_d, int warps_t,
                                  int chunk, void* stream) {
  Args a = {x, B, F, static_cast<const Node*>(nodes), leaves, N, L, L4,
            block_t, block_lo, n_blocks, SegStarts{}, 1, partials, arrivals,
            out, n_valid, warps_d, warps_t, chunk};
  return n_valid ? launch<false, true>(a, stream, nullptr, true)
                 : launch<false>(a, stream, nullptr, true);
}

// Scores x [B, F] through tree blocks [0, n_blocks) into out [B, n_seg]:
// column k sums the blocks [seg_block_starts[k], seg_block_starts[k + 1]).
// seg_block_starts is a host array of n_seg <= 16 ascending entries, the
// first 0. Other arguments as forest_score_range.
extern "C" int forest_score_segments(
    const float* x, int B, int F, const void* nodes, const float* leaves,
    int N, int L, int L4, int block_t, int n_blocks,
    const int* seg_block_starts, int n_seg, float* partials,
    unsigned int* arrivals, float* out, int warps_d, int warps_t, int chunk,
    void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {x, B, F, static_cast<const Node*>(nodes), leaves, N, L, L4,
            block_t, 0, n_blocks, SegStarts{}, n_seg, partials, arrivals,
            out, nullptr, warps_d, warps_t, chunk};
  for (int k = 0; k < n_seg; ++k) a.seg.start[k] = seg_block_starts[k];
  return launch<true>(a, stream, nullptr, true);
}

// The launch plan forest_score_range (segmented = 0) or
// forest_score_segments (1) would use, without launching: plan[0..6] =
// warps on documents, warps on trees, documents per tile, tree blocks per
// chunk, grid.x, grid.y, resident CTAs per SM. Returns a cudaError_t.
extern "C" int forest_score_plan(int B, int F, int N, int L, int L4,
                                 int block_t, int n_blocks, int segmented,
                                 int warps_d, int warps_t, int chunk,
                                 int* plan) {
  Args a = {nullptr, B, F, nullptr, nullptr, N, L, L4, block_t, 0, n_blocks,
            SegStarts{}, 1, nullptr, nullptr, nullptr, nullptr, warps_d, warps_t,
            chunk};
  Plan p;
  const int err = segmented ? launch<true>(a, nullptr, &p, false)
                            : launch<false>(a, nullptr, &p, false);
  if (err) return err;
  plan[0] = p.warps_d;
  plan[1] = p.warps_t;
  plan[2] = 32 * p.warps_d * kDocsPerLane;
  plan[3] = p.chunk;
  plan[4] = p.n_tiles;
  plan[5] = p.n_chunks;
  plan[6] = p.per_sm;
  return 0;
}

// The widest x (features) both kernels take on the current device for
// tables of N nodes and L4 leaf slots per tree in blocks of block_t trees,
// into *max_f: the shared-memory layout's limit. Returns a cudaError_t.
extern "C" int forest_score_max_features(int N, int L4, int block_t,
                                         int* max_f) {
  if (N < 1 || L4 < 4 || L4 % 4) return static_cast<int>(cudaErrorInvalidValue);
  int range_f = 0, seg_f = 0;
  if (const int err = max_features<false>(N, L4, block_t, &range_f)) return err;
  if (const int err = max_features<true>(N, L4, block_t, &seg_f)) return err;
  *max_f = range_f < seg_f ? range_f : seg_f;
  return 0;
}

// Launch plans made since the library was loaded (plan-cache insertions of
// every kernel on every device, forest_score_plan's included). A warmed
// service adds none while it serves.
extern "C" int forest_score_plan_count(void) { return g_plans_made.load(); }
