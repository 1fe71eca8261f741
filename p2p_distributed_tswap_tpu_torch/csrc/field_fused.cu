// field_fused: the whole next-hop direction field of a batch of goals in one
// launch -- goal seed, fast-sweeping fixpoint, next-hop codes -- as a
// hand-written CUDA kernel for Hopper (sm_90a), each field split across the
// blocks of a thread-block cluster.
//
// Replaces the two Pallas TPU kernels of the JAX package's fused field
// engine; both are this one kernel, one field per cluster:
//   p2p_distributed_tswap_tpu/ops/field_fused.py:166  _kernel
//     (one field per program, MAPD_FUSED=single);
//   p2p_distributed_tswap_tpu/ops/field_fused.py:357  _multi_kernel
//     (eight fields per program, MAPD_FUSED=1 or multi).  The Pallas
//     kernel's eight fields were its sublane layout; here no goal is padded.
//
// What a cluster computes for its field (goal g, one (H, W) mask shared by
// every field, INF = 2^30):
//   1. seed: d = 0 at cell g if that cell is free, INF everywhere else;
//   2. rounds of four passes -- along W forward, along W reverse, along H
//      forward, along H reverse -- each the recurrence of csrc/sweep_scan.cu
//          run = INF; run = min(run + 1, d[i]); run = INF if blocked[i];
//          d[i] = run
//      until a round changes no cell of the field, or max_rounds rounds have
//      run.  Each field keeps its own count (rounds_out, one int32 per
//      field); rounds on a converged field change nothing, so per-field
//      convergence gives the same fields as whole-batch convergence
//      (ops/distance.py _fixpoint) even where max_rounds binds;
//   3. codes: the neighbours in DIR_DXDY order (down, right, up, left), INF
//      off the grid, strict < (the first minimum wins); code 4 (stay) where
//      d == 0, d >= INF, best >= INF, best >= d or the cell is blocked.
// Bit-identical to the plain version (ops/field_fused.py fields_plain).
//
// The split.  A cluster of K blocks (1..16, chosen by the wrapper so that
// the clusters of a launch are resident together and fill the card) owns
// one field; block k owns rows [k H / K, (k+1) H / K) of it, a band.
//   along W: rows are independent, so a pass needs only the block barrier:
//     one warp per row, 32-cell chunks, a ballot for the last obstacle at or
//     before each lane, a five-step shuffle segmented minimum of d[k] - k,
//     and the carry (lane 31's run) from chunk to chunk in registers.  The
//     field's rows are shared by 32 K warps.
//   along H: the recurrence composes.  A band with no obstacle in a column
//     maps an incoming run c to min(tail, c + band_len); a band with one
//     emits its own tail whatever comes in; a cell above the band's first
//     obstacle (in scan order) takes min(local, c + i + 1).  Phase 1: one
//     thread per column scans its band from run = INF, writes the local
//     values and publishes (tail, obstacle bit) in shared memory.  Cluster
//     barrier.  Phase 2: the thread reads the earlier bands' summaries
//     (later ones, for the reverse pass) through distributed shared memory,
//     composes its carry and lowers only the cells above the band's first
//     obstacle, stopping where the carry stops winning (from there on it
//     never wins again).  The chain a thread walks is H / K rows long, not
//     H.
//   convergence: after the round every block publishes whether it changed a
//     cell, a cluster barrier, and every thread ORs the K blocks' flags
//     through distributed shared memory, so the whole cluster leaves the
//     loop on the same round.  No host sync.
//
// Layout.  Codes are written as (G, H, W) uint8 directly.  The distances
// are (G, H, W) int32 in device memory, allocated by the caller: a 1024^2
// field is 4 MB and a band of it at K = 16 256 KB, past the 227 KB of
// shared memory a block may use, so every field lives in device memory and
// the 50 MB L2 (16 MB at the in-step chunk of 4).  Shared memory holds the
// band's mask as bits (one 32-bit word per 32 cells of a row) and the two
// H-pass summaries (forward and reverse, one word per column).  A small
// first kernel packs the bits from the (H, W) uint8 mask into a device
// buffer, from which each block copies its band.  The codes of a band's
// edge rows read the neighbour band's row after the last cluster barrier
// (and a fence), bypassing L1.
//
// Bound on an H100.  What the function must move is the mask read once and
// the codes written once, (H W + G H W) bytes; its integer work, about 12
// operations per cell per round plus 15 per cell for the seed and the
// codes, outweighs the bytes at the path's shapes.  What the time is made
// of is latency: a dependent chain of L2 loads per thread along H, a
// dependent shuffle chain per warp along W, and 3 cluster barriers a round.
// The split cuts the first to H / K rows and spreads the second over K
// times the warps, with G K blocks on G K SMs (64 at the in-step chunk of
// 4 fields at K = 16) instead of G (or G / 8) before.
//
// Threads.  1024 per block, one block per SM; __launch_bounds__ caps
// registers at 64 a thread.  kChunks chunks (W) or kUnroll rows (H) are
// loaded ahead of each dependent scan.  A cell is written back only when
// its value changes.
//
// Interface: plain C, loaded with ctypes.  The caller passes device pointers
// and the CUDA stream; the launches are asynchronous and allocate nothing.
// Returns cudaGetLastError() after the launches (0 = success); a launch the
// runtime refuses (a cluster that cannot be placed) returns its error.  The
// limits of a layout (cluster size, shared memory) live here only:
// field_fused_max_clusters answers 0 for a layout the kernel does not take.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kInf = 1 << 30;
constexpr int kStay = 4;
constexpr int kThreads = 1024;
constexpr int kUnroll = 8;
constexpr int kChunks = 8;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
// Summary word of a band's column: the run at the band's last row in scan
// order, and this bit when the band holds an obstacle in that column.
constexpr uint32_t kObstacle = 1u << 31;
// Dynamic shared memory a block may use on sm_90, less room for the static.
constexpr long long kMaxSmemBytes = 232448 - 1024;

__host__ __device__ inline int band_start(int band, int H, int K) {
  return static_cast<int>(static_cast<long long>(band) * H / K);
}

// Dynamic shared memory of one block: the widest band's mask bits and the
// forward and reverse H summaries.
long long smem_bytes(long long K, long long H, long long W) {
  return 4 * (((H + K - 1) / K) * ((W + 31) / 32) + 2 * W);
}

// Whether the kernel takes an (H, W) field split over K blocks: at least
// one row a band, cell indices in an int, and the block's shared memory.
bool layout_fits(long long K, long long H, long long W) {
  return K >= 1 && K <= kMaxCluster && H >= K && W >= 1 &&
         H * W <= 0x7fffffffLL - kThreads &&
         smem_bytes(K, H, W) <= kMaxSmemBytes;
}

__device__ __forceinline__ bool is_blocked(const uint32_t* bits, int wp,
                                           int row, int x) {
  return (bits[row * wp + (x >> 5)] >> (x & 31)) & 1u;
}

// bits[y * wp + j] bit b = blocked[y][32 j + b] (0 past the row's end): one
// warp per word, a ballot over 32 neighbouring mask bytes.
__global__ void pack_blocked_bits(const uint8_t* __restrict__ blocked,
                                  uint32_t* __restrict__ bits, int H, int W,
                                  int wp) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long word = t >> 5;
  if (word >= static_cast<long long>(H) * wp) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const int y = static_cast<int>(word / wp);
  const int x = static_cast<int>(word % wp) * 32 + lane;
  const bool b = x < W && blocked[static_cast<long long>(y) * W + x] != 0;
  const unsigned v = __ballot_sync(kFull, b);
  if (lane == 0) bits[word] = v;
}

// What one block of a cluster owns: rows [y0, y0 + bh) of its field d
// (H * W), their mask bits in shared memory.
struct Band {
  int* d;
  const uint32_t* bits;
  int y0, bh, H, W, wp;
};

// One pass along W over the band's rows.  Returns whether this thread
// changed a cell.
__device__ bool pass_along_w(const Band& b, bool reverse) {
  const int lane = threadIdx.x & 31;
  const unsigned upto_lane = kFull >> (31 - lane);  // lanes 0..lane
  const int W = b.W;
  bool changed = false;
  for (int r = threadIdx.x >> 5; r < b.bh; r += kThreads / 32) {
    int* row = b.d + static_cast<long long>(b.y0 + r) * W;
    int carry = kInf;
    for (int base0 = 0; base0 < W; base0 += 32 * kChunks) {
      int dv[kChunks];
      bool bl[kChunks];
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int i = base0 + 32 * k + lane;  // position in scan order
        const bool valid = i < W;
        const int x = reverse ? W - 1 - i : i;
        // Lanes past the row's end hold a free INF cell: they sit after
        // every valid lane in scan order and never reach a valid result.
        dv[k] = valid ? row[x] : kInf;
        bl[k] = valid && is_blocked(b.bits, b.wp, r, x);
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int i = base0 + 32 * k + lane;
        const unsigned before = __ballot_sync(kFull, bl[k]) & upto_lane;
        const int last_blocked = before ? 31 - __clz(before) : -1;
        // segmented min over lanes (last_blocked, lane] of d[k] - k
        int m = dv[k] - lane;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(kFull, m, off);
          if (lane - off > last_blocked) m = min(m, o);
        }
        const int seg = m + lane;
        int run;
        if (bl[k]) {
          run = kInf;
        } else if (last_blocked >= 0) {
          run = seg;
        } else {
          run = min(carry + lane + 1, seg);
        }
        const int out = min(run, kInf);
        if (i < W && out != dv[k]) {
          row[reverse ? W - 1 - i : i] = out;
          changed = true;
        }
        carry = __shfl_sync(kFull, run, 31);
      }
    }
  }
  return changed;
}

// One pass along H over the band's columns, as the two-phase scan across
// the cluster's bands; `sum` is this block's summary buffer for the
// direction.  Every thread of the cluster must call it (it holds a cluster
// barrier).  Returns whether this thread changed a cell.
__device__ bool pass_along_h(const cg::cluster_group& cluster, const Band& b,
                             uint32_t* sum, bool reverse) {
  const int W = b.W;
  bool changed = false;
  // Phase 1: each column of the band from run = INF; (tail, obstacle) out.
  for (int x = threadIdx.x; x < W; x += kThreads) {
    int* col = b.d + static_cast<long long>(b.y0) * W + x;
    const uint32_t* mcol = b.bits + (x >> 5);
    const int shift = x & 31;
    int run = kInf;
    uint32_t obstacle = 0;
    int i = 0;
    for (; i + kUnroll <= b.bh; i += kUnroll) {
      int dv[kUnroll];
      uint32_t mv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int y = reverse ? b.bh - 1 - (i + k) : i + k;
        dv[k] = col[static_cast<long long>(y) * W];
        mv[k] = (mcol[y * b.wp] >> shift) & 1u;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int y = reverse ? b.bh - 1 - (i + k) : i + k;
        run = min(run + 1, dv[k]);
        if (mv[k]) run = kInf;
        obstacle |= mv[k];
        if (run != dv[k]) {
          col[static_cast<long long>(y) * W] = run;
          changed = true;
        }
      }
    }
    for (; i < b.bh; ++i) {
      const int y = reverse ? b.bh - 1 - i : i;
      const int dv = col[static_cast<long long>(y) * W];
      const uint32_t mv = (mcol[y * b.wp] >> shift) & 1u;
      run = min(run + 1, dv);
      if (mv) run = kInf;
      obstacle |= mv;
      if (run != dv) {
        col[static_cast<long long>(y) * W] = run;
        changed = true;
      }
    }
    sum[x] = static_cast<uint32_t>(run) | (obstacle ? kObstacle : 0u);
  }
  cluster.sync();
  // Phase 2: the carry into the band from the bands before it in scan
  // order, then the cells above the band's first obstacle.
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int x = threadIdx.x; x < W; x += kThreads) {
    int carry = kInf;
    const int n_before = reverse ? K - 1 - rank : rank;
#pragma unroll 4
    for (int j = 0; j < n_before; ++j) {
      const int k = reverse ? K - 1 - j : j;
      const uint32_t s = *cluster.map_shared_rank(sum + x, k);
      const int tail = static_cast<int>(s & ~kObstacle);
      const int len = band_start(k + 1, b.H, K) - band_start(k, b.H, K);
      carry = (s & kObstacle) ? tail : min(tail, carry + len);
    }
    if (carry >= kInf) continue;
    int* col = b.d + static_cast<long long>(b.y0) * W + x;
    const uint32_t* mcol = b.bits + (x >> 5);
    const int shift = x & 31;
    // kUnroll rows loaded ahead, as in phase 1; the walk stops at the
    // band's first obstacle or where the carry stops winning, after which
    // it never wins again (the local values rise by at most one a row).
    bool open = true;
    for (int i = 0; open && i < b.bh; i += kUnroll) {
      int dv[kUnroll];
      bool mv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int y = reverse ? b.bh - 1 - (i + k) : i + k;
        const bool in_band = i + k < b.bh;
        dv[k] = in_band ? col[static_cast<long long>(y) * W] : 0;
        mv[k] = !in_band || ((mcol[y * b.wp] >> shift) & 1u);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int cand = carry + i + k + 1;
        open = open && !mv[k] && cand < dv[k];
        if (open) {
          const int y = reverse ? b.bh - 1 - (i + k) : i + k;
          col[static_cast<long long>(y) * W] = cand;
          changed = true;
        }
      }
    }
  }
  return changed;
}

__global__ void __launch_bounds__(kThreads, 1)
    field_fused_kernel(const int* __restrict__ goals,
                       const uint32_t* __restrict__ bits_in, int* dist,
                       uint8_t* __restrict__ codes,
                       int* __restrict__ rounds_out, int H, int W, int wp,
                       int max_rounds) {
  const cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const long long plane = static_cast<long long>(H) * W;
  const int field = static_cast<int>(blockIdx.x / K);
  const int goal = goals[field];
  const int y0 = band_start(rank, H, K);
  const int y1 = band_start(rank + 1, H, K);

  extern __shared__ uint32_t smem[];
  uint32_t* bits = smem;  // the band's rows, bit set = blocked
  // Same offsets in every block of the cluster, for map_shared_rank.
  uint32_t* sum_fwd = bits + ((H + K - 1) / K) * wp;
  uint32_t* sum_rev = sum_fwd + W;
  __shared__ unsigned flags[2];  // a cell changed, by round parity

  for (int i = threadIdx.x; i < (y1 - y0) * wp; i += kThreads) {
    bits[i] = bits_in[static_cast<long long>(y0) * wp + i];
  }
  if (threadIdx.x < 2) flags[threadIdx.x] = 0;
  __syncthreads();

  int* d = dist + field * plane;
  const Band band{d, bits, y0, y1 - y0, H, W, wp};

  // ---- seed: 0 at the goal cell if it is free, INF elsewhere ----
  for (int cell = y0 * W + threadIdx.x; cell < y1 * W; cell += kThreads) {
    const int y = cell / W;
    const bool seed =
        cell == goal && !is_blocked(bits, wp, y - y0, cell - y * W);
    d[cell] = seed ? 0 : kInf;
  }
  __syncthreads();

  // ---- fixpoint: rounds of four passes until none changes a cell ----
  bool changed = true;
  int rounds = 0;
  while (changed && rounds < max_rounds) {
    unsigned* flag = &flags[rounds & 1];
    // The other parity's readers finished before this round's barriers.
    if (threadIdx.x == 0) *flag = 0;
    bool c = pass_along_w(band, false);
    __syncthreads();
    c |= pass_along_w(band, true);
    __syncthreads();
    c |= pass_along_h(cluster, band, sum_fwd, false);
    __syncthreads();
    c |= pass_along_h(cluster, band, sum_rev, true);
    if (__any_sync(kFull, c) && (threadIdx.x & 31) == 0) *flag = 1;
    cluster.sync();
    changed = false;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      changed |= *cluster.map_shared_rank(flag, k) != 0;
    }
    ++rounds;
  }
  if (rank == 0 && threadIdx.x == 0) rounds_out[field] = rounds;
  // Every band's distances visible to the cluster; after this barrier no
  // block reads another's shared memory, so each may run on to its exit.
  __threadfence();
  cluster.sync();

  // ---- next-hop codes of the band ----
  uint8_t* cf = codes + field * plane;
#pragma unroll 4  // the cells are independent: keep their loads in flight
  for (int cell = y0 * W + threadIdx.x; cell < y1 * W; cell += kThreads) {
    const int y = cell / W;
    const int x = cell - y * W;
    const int cur = d[cell];
    // rows past the band's edges were written by the neighbour blocks
    const int down = y + 1 >= H ? kInf
                     : y + 1 < y1 ? d[cell + W]
                                  : __ldcg(d + cell + W);
    const int up = y == 0 ? kInf : y > y0 ? d[cell - W] : __ldcg(d + cell - W);
    // DIR_DXDY order: (0,1) down, (1,0) right, (0,-1) up, (-1,0) left
    const int nv[4] = {down, x + 1 < W ? d[cell + 1] : kInf, up,
                       x > 0 ? d[cell - 1] : kInf};
    int best = kStay;
    int best_val = kInf;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (nv[k] < best_val) {
        best = k;
        best_val = nv[k];
      }
    }
    const bool stay = cur == 0 || cur >= kInf || best_val >= kInf ||
                      best_val >= cur || is_blocked(bits, wp, y - y0, x);
    cf[cell] = static_cast<uint8_t>(stay ? kStay : best);
  }
}

// The kernel's attributes, set once per process: the most dynamic shared
// memory a block may take, and clusters of up to 16 blocks.
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        field_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmemBytes));
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        field_fused_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return err;
}

cudaLaunchConfig_t launch_config(long long blocks, int K, long long smem,
                                 cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(K);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// How many clusters of `cluster` blocks, each owning one field of an
// (H, W) grid, the card can hold at once; into *out.  0 when the kernel
// does not take that layout (past 16 blocks, fewer rows than blocks, or
// more shared memory than a block may use) or the card places none.
extern "C" int field_fused_max_clusters(int cluster, long long H, long long W,
                                        int* out) {
  *out = 0;
  if (!layout_fits(cluster, H, W)) return 0;
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      cluster, cluster, smem_bytes(cluster, H, W), nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<const void*>(field_fused_kernel), &cfg);
  return static_cast<int>(err);
}

// goals (G,) int32; blocked (H, W) uint8, nonzero = obstacle; bits
// (H, ceil(W/32)) 32-bit scratch; dist (G, H, W) int32 scratch; codes
// (G, H, W) uint8 out; rounds (G,) int32 out: the rounds each field ran.
// G clusters of `cluster` blocks, one field each.
extern "C" int field_fused(const void* goals, long long G, const void* blocked,
                           void* bits, void* dist, void* codes, void* rounds,
                           long long H, long long W, int cluster,
                           int max_rounds, void* stream) {
  const long long blocks = G * cluster;
  if (!layout_fits(cluster, H, W) || G < 1 || blocks > 0x7fffffffLL ||
      max_rounds < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = configure();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long wp = (W + 31) / 32;
  const int h = static_cast<int>(H);
  const int w = static_cast<int>(W);
  const int wpi = static_cast<int>(wp);
  uint32_t* bp = static_cast<uint32_t*>(bits);
  const long long pack_threads = H * wp * 32;
  pack_blocked_bits<<<static_cast<unsigned>((pack_threads + 255) / 256), 256,
                      0, s>>>(static_cast<const uint8_t*>(blocked), bp, h, w,
                              wpi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(blocks, cluster, smem_bytes(cluster, H, W), s, &attr);
  err = cudaLaunchKernelEx(&cfg, field_fused_kernel,
                           static_cast<const int*>(goals),
                           static_cast<const uint32_t*>(bp),
                           static_cast<int*>(dist),
                           static_cast<uint8_t*>(codes),
                           static_cast<int*>(rounds), h, w, wpi, max_rounds);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
