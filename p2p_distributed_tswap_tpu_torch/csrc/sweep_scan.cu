// sweep_scan: one directional fast-sweeping relax of a batch of BFS distance
// fields, as a hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package that compute the
// same function:
//   p2p_distributed_tswap_tpu/ops/sweep_pallas.py:209  _scan8_kernel (full row)
//   p2p_distributed_tswap_tpu/ops/sweep_pallas.py:86   _scan_kernel  (strip)
// One kernel source takes any R, H, W >= 1: the TPU's 128-lane shape gate has
// no counterpart here.
//
// What it computes, for d (R, H, W) int32 and a uint8 mask (nonzero =
// blocked), along `axis` (1 = H, 2 = W), walking the axis forward or in
// reverse, with INF = 2^30.  The mask is one (H, W) plane shared by all R
// fields (mask stride 0: the solver's fields, all on one grid) or one plane
// per field (stride H * W: the repair and sector windows, each padded with
// its own blocked cells):
//
//     run    = INF                       (before the first cell)
//     run    = min(run + 1, d[i])        relax from the predecessor
//     run    = INF      if blocked[i]    obstacles reset the segment
//     out[i] = min(run, INF)
//
// Bit-identical to the doubling-scan plain version (ops/sweep_kernel.py,
// sweep_plain) for inputs in [0, INF]; every run and carry below stays at
// most INF + 2^16, so no int32 sum can overflow.
//
// Bound on an H100: device-memory bytes.  Each cell is read once, written
// once, and costs three integer operations, so a sweep moves 8 bytes per cell
// (plus the mask: a shared plane stays in the 50 MB L2 across the batch, a
// plane per field is one more byte per cell, read once) and sits far
// below the card's operations-per-byte line.  What keeps a sweep from that
// bound is latency: the recurrence is a dependent chain along the axis, and
// the in-step replans sweep only R = 4 fields.  So the design keeps whole
// tiles of loads in flight and cuts the chains:
//
//   axis 1 (along H): a block owns one field's tile of TW columns (32, 16
//     or 8) cut into NB bands of BH rows (8 or 16), TW threads a band, one
//     column each.  Every thread issues all BH loads of its band before its
//     chain runs.  Phase 1 scans each band from run = INF and publishes per
//     column its (tail, obstacle-in-band) summary in shared memory; after
//     one __syncthreads, phase 2 composes each band's carry from the
//     earlier bands' summaries in scan order and rescans the band from that
//     carry in registers, then stores.  The chain is BH rows plus NB
//     summaries instead of H rows.  Where H outgrows NB * BH the block
//     walks segments of NB * BH rows, the carry between them in shared
//     memory.  Forward and reverse are one code path: positions are taken
//     in scan order and mirrored to rows.  The layout comes from (R, H, W)
//     alone (choose_h_layout): the widest tile that still gives about one
//     block per SM (so R = 4 fields fill the card at 256^2 too), the band
//     height that makes the chain shortest, and, where the blocks come in
//     several waves (the prime's 64 or 128 fields), at most 8 bands a
//     block, so that small blocks overlap one another's loads and stores.
//   axis 2 (along W): one warp per (field, row).  Each lane loads 8 cells
//     of each 256-cell segment of the row before any scan runs (longer
//     rows go segment by segment, the carry between them): where W % 4 ==
//     0 and the tensors are 16-byte aligned in chunks of 4 cells a lane,
//     one int4 each, else in chunks of one cell, one coalesced scalar each.
//     Each chunk is a raking scan: every lane scans its cells from INF to
//     a (tail, obstacle) summary, a ballot finds the last lane with an
//     obstacle, five shuffle rounds take the segmented minimum of
//     tail - cells * lane, the chunk's carry enters the lanes that no
//     obstacle separates from it, and each lane rescans its cells from its
//     incoming carry in registers.  Short segments keep registers low and
//     warps per SM high.
//   Both: positions past the end of an axis read a cell inside it, so
//     every load is unconditional and none waits behind another's use.
//
// Interface: plain C, loaded with ctypes.  The caller passes device pointers,
// the mask stride (0 or H * W, in cells) and the CUDA stream; the launch is
// asynchronous and allocates nothing.
// `sweep_scan` picks the layout; `sweep_scan_forced` takes it as (tile,
// rows, bands), 0 = the chosen one (see Layout; along W only the tile),
// for tests and measurement; `sweep_scan_layout` reports a layout without launching.
// Each launch returns cudaGetLastError() after it (0 = success), a layout
// it does not take cudaErrorInvalidValue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kObstacle = 1u << 31;  // summary bit: obstacle in band

// Along H.
constexpr int kMaxThreads = 1024;  // threads of an along-H block, at most
constexpr int kFillBlocks = 128;   // blocks that about fill 132 SMs
constexpr int kMaxGrid = 1 << 20;  // blocks launched, at most (grid-stride)

// The BH cells of one column at scan positions pb .. pb + BH - 1 (row p,
// or H - 1 - p in reverse; `col` points at the column's row 0) and their
// blocked bits.  Positions past H read row H - 1 of scan order and become
// free INF cells, so every load is unconditional: all of them are in flight
// before any is used.
template <int BH>
__device__ __forceinline__ uint32_t load_column(
    const int* __restrict__ col, const uint8_t* __restrict__ mcol, int H,
    int W, int pb, int reverse, int (&v)[BH]) {
  uint8_t mv[BH];
#pragma unroll
  for (int i = 0; i < BH; ++i) {
    const int p = min(pb + i, H - 1);
    const long long y = reverse ? H - 1 - p : p;
    v[i] = col[y * W];
    mv[i] = mcol[y * W];
  }
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < BH; ++i) {
    const bool in = pb + i < H;
    if (!in) v[i] = kInf;
    m |= (in && mv[i] != 0 ? 1u : 0u) << i;
  }
  return m;
}

// The recurrence over those cells from `run`, storing the cells inside H
// when `store`.
template <int BH>
__device__ __forceinline__ void relax_column(int* __restrict__ col, int H,
                                             int W, int pb, int reverse,
                                             const int (&v)[BH], uint32_t m,
                                             bool store, int& run) {
#pragma unroll
  for (int i = 0; i < BH; ++i) {
    run = min(run + 1, v[i]);
    if ((m >> i) & 1u) run = kInf;
    if (store && pb + i < H) {
      const long long y = reverse ? H - 1 - (pb + i) : pb + i;
      col[y * W] = min(run, kInf);
    }
  }
}

template <int TW, int BH>
__global__ void __launch_bounds__(kMaxThreads)
    sweep_along_h(const int* __restrict__ d,
                  const uint8_t* __restrict__ blocked, int* __restrict__ out,
                  long long R, int H, int W, long long mstride, int NB,
                  int reverse) {
  __shared__ uint32_t sum[kMaxThreads];  // (tail | obstacle bit), band-major
  __shared__ int seg_carry[2][TW];       // carry into a segment, by parity
  const int c = threadIdx.x % TW;        // column in the tile
  const int b = threadIdx.x / TW;        // band in the segment, scan order
  const int tiles = (W + TW - 1) / TW;
  const long long plane = static_cast<long long>(H) * W;
  const int seg_rows = NB * BH;
  for (long long blk = blockIdx.x; blk < R * tiles; blk += gridDim.x) {
    const long long r = blk / tiles;
    const int x = static_cast<int>(blk % tiles) * TW + c;
    const bool col = x < W;  // columns past W load column W - 1, store none
    const int* dcol = d + r * plane + (col ? x : W - 1);
    const uint8_t* mcol = blocked + r * mstride + (col ? x : W - 1);
    int* ocol = out + r * plane + x;
    if (threadIdx.x < TW) seg_carry[0][threadIdx.x] = kInf;
    int parity = 0;
    for (int p0 = 0; p0 < H; p0 += seg_rows, parity ^= 1) {
      const int pb = p0 + b * BH;  // the band's first scan position
      int v[BH];
      const uint32_t m = load_column<BH>(dcol, mcol, H, W, pb, reverse, v);
      // Phase 1: the band alone, from run = INF.
      int run = kInf;
#pragma unroll
      for (int i = 0; i < BH; ++i) {
        run = min(run + 1, v[i]);
        if ((m >> i) & 1u) run = kInf;
      }
      sum[threadIdx.x] = static_cast<uint32_t>(run) | (m ? kObstacle : 0u);
      __syncthreads();
      // Phase 2: the carry from the segment's start through the bands
      // before this one, then the band again from that carry.
      int carry = seg_carry[parity][c];
      for (int j = 0; j < b; ++j) {
        const uint32_t s = sum[j * TW + c];
        const int tail = static_cast<int>(s & ~kObstacle);
        carry = (s & kObstacle) ? tail : min(tail, carry + BH);
      }
      if (b == NB - 1) {  // the carry out of the segment, into the next
        seg_carry[parity ^ 1][c] = m ? run : min(run, carry + BH);
      }
      run = carry;
      relax_column<BH>(ocol, H, W, pb, reverse, v, m, col, run);
      __syncthreads();  // sum and seg_carry[parity] are free again
    }
  }
}

// Along W.  A lane holds kCells cells of each chunk of 32 * kCells and
// loads kLaneCells cells of each segment of 32 * kLaneCells before it scans
// any: kCells = 4 is one int4 per chunk (W % 4 == 0, 16-byte aligned
// tensors), kCells = 1 one coalesced scalar per chunk (any W).
constexpr int kRowThreads = 256;  // 8 warps, one row each
constexpr int kLaneCells = 8;     // cells a lane loads per segment

// The lane's kCells cells of the chunk starting at scan position p, in scan
// order (cells past W: free INF); returns their blocked bits.  As along H,
// positions past W read a cell inside the row, so the loads are
// unconditional.  kCells = 4: W % 4 == 0, so p < W implies p + 3 < W and
// both loads are aligned.
template <int kCells>
__device__ __forceinline__ uint32_t load_cells(const int* __restrict__ dp,
                                               const uint8_t* __restrict__ mp,
                                               int W, int p, int reverse,
                                               int (&v)[kCells]) {
  uint32_t m = 0;
  if constexpr (kCells == 4) {
    const int pc = min(p, W - 4);
    const int x = reverse ? W - 4 - pc : pc;
    const int4 q = *reinterpret_cast<const int4*>(dp + x);
    const uint32_t mb = *reinterpret_cast<const uint32_t*>(mp + x);
    const bool in = p < W;
    v[0] = in ? (reverse ? q.w : q.x) : kInf;
    v[1] = in ? (reverse ? q.z : q.y) : kInf;
    v[2] = in ? (reverse ? q.y : q.z) : kInf;
    v[3] = in ? (reverse ? q.x : q.w) : kInf;
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int e = reverse ? kCells - 1 - k : k;  // byte of cell k
      m |= (in && ((mb >> (8 * e)) & 0xffu) != 0 ? 1u : 0u) << k;
    }
  } else {
    uint8_t mv[kCells];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int pc = min(p + k, W - 1);
      const int x = reverse ? W - 1 - pc : pc;
      v[k] = dp[x];
      mv[k] = mp[x];
    }
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const bool in = p + k < W;
      if (!in) v[k] = kInf;
      m |= (in && mv[k] != 0 ? 1u : 0u) << k;
    }
  }
  return m;
}

template <int kCells>
__device__ __forceinline__ void store_cells(int* __restrict__ op, int W, int p,
                                            int reverse,
                                            const int (&v)[kCells]) {
  if constexpr (kCells == 4) {
    if (p < W) {
      const int x = reverse ? W - 4 - p : p;
      *reinterpret_cast<int4*>(op + x) =
          reverse ? make_int4(v[3], v[2], v[1], v[0])
                  : make_int4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      if (p + k < W) op[reverse ? W - 1 - (p + k) : p + k] = v[k];
    }
  }
}

// One chunk of 32 lanes x kCells cells: the raking segmented scan.  `m`
// holds the cells' blocked bits; `carry` is the run before the chunk's first
// cell on entry and after its last cell on return; v is replaced by the
// result.
template <int kCells>
__device__ __forceinline__ void scan_chunk(int (&v)[kCells], uint32_t m,
                                           int lane, int& carry) {
  int run = kInf;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    run = min(run + 1, v[k]);
    if ((m >> k) & 1u) run = kInf;
  }
  // Lanes [last, lane] reach the end of this lane's cells unbroken (`last`
  // = the last lane at or before this one holding an obstacle; its tail is
  // the run after that obstacle): through = min over them of
  // tail_j + kCells * (lane - j), as a segmented min of tail_j - kCells*j.
  const unsigned upto = kFull >> (31 - lane);
  const unsigned before = __ballot_sync(kFull, m != 0) & upto;
  const int last = before ? 31 - __clz(before) : 0;
  int key = run - kCells * lane;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, key, off);
    if (lane - off >= last) key = min(key, o);
  }
  int through = key + kCells * lane;
  if (!before) through = min(through, carry + kCells * (lane + 1));
  through = min(through, kInf);
  int cin = __shfl_up_sync(kFull, through, 1);
  if (lane == 0) cin = carry;
  carry = __shfl_sync(kFull, through, 31);
  run = cin;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    run = min(run + 1, v[k]);
    if ((m >> k) & 1u) run = kInf;
    v[k] = min(run, kInf);
  }
}

template <int kCells>
__global__ void __launch_bounds__(kRowThreads)
    sweep_along_w(const int* __restrict__ d,
                  const uint8_t* __restrict__ blocked, int* __restrict__ out,
                  long long rows, int H, int W, long long mstride,
                  int reverse) {
  constexpr int kChunk = 32 * kCells;
  constexpr int kChunks = kLaneCells / kCells;
  constexpr int kSegment = 32 * kLaneCells;
  const int lane = threadIdx.x & 31;
  const long long warps =
      static_cast<long long>(gridDim.x) * (kRowThreads / 32);
  const long long first =
      (static_cast<long long>(blockIdx.x) * kRowThreads + threadIdx.x) >> 5;
  // one row per warp: every branch on `row` is uniform across the warp
  for (long long row = first; row < rows; row += warps) {
    const int* dp = d + row * W;
    int* op = out + row * W;
    const uint8_t* mp = blocked + (row / H) * mstride + (row % H) * W;
    int carry = kInf;
    for (int s0 = 0; s0 < W; s0 += kSegment) {
      int v[kChunks][kCells];
      uint32_t m = 0;  // bit j * kCells + k: cell k of chunk j is blocked
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        m |= load_cells<kCells>(dp, mp, W, s0 + j * kChunk + lane * kCells,
                                reverse, v[j])
             << (j * kCells);
      }
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        if (s0 + j * kChunk >= W) break;  // uniform across the warp
        scan_chunk<kCells>(v[j], (m >> (j * kCells)) & ((1u << kCells) - 1),
                           lane, carry);
        store_cells<kCells>(op, W, s0 + j * kChunk + lane * kCells, reverse,
                            v[j]);
      }
    }
  }
}

// A launch's layout.  Along H: tile = columns per block (8, 16 or 32),
// rows per band (8 or 16), bands per segment.  Along W: tile = cells per
// lane per chunk (1 or 4), rows = bands = 0.
struct Layout {
  int tile, rows, bands, threads;
  long long blocks;
};

// Along H, from this many blocks (several waves) a block holds at most
// kManyBands bands: smaller blocks overlap one another's loads and stores.
constexpr long long kManyBlocks = 4 * kFillBlocks;
constexpr int kManyBands = 8;

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The along-H layout for (R, H, W), with any of tile, rows, bands forced
// (nonzero).  Returns false for a forced layout the kernel does not take.
bool choose_h_layout(long long R, long long H, long long W, int tile,
                     int rows, int bands, Layout* out) {
  if (tile == 0) {
    // the widest tile that still gives about one block per SM
    tile = 32;
    while (tile > 8 && (R * cdiv(W, tile) < kFillBlocks || tile / 2 >= W)) {
      tile /= 2;
    }
  }
  if (tile != 8 && tile != 16 && tile != 32) return false;
  const long long blocks = R * cdiv(W, tile);
  const int per_warp = 32 / tile;  // bands sharing a warp
  const int max_bands = kMaxThreads / tile;
  auto bands_for = [&](int bh) {
    const long long nb = cdiv(cdiv(H, bh), per_warp) * per_warp;
    return static_cast<int>(nb < max_bands ? nb : max_bands);
  };
  if (rows == 0) {
    // the shortest chain per segment, BH dependent rows plus NB summaries
    // at half the weight (they are read from shared memory, not loaded),
    // times the segments; ties to the longer band (fewer threads)
    long long best = -1;
    for (int bh = 8; bh <= 16; bh *= 2) {
      const int nb = bands ? bands : bands_for(bh);
      const long long cost =
          cdiv(H, static_cast<long long>(nb) * bh) * (2 * bh + nb);
      if (best < 0 || cost <= best) best = cost, rows = bh;
    }
  }
  if (rows != 8 && rows != 16) return false;
  if (bands == 0) {
    bands = bands_for(rows);
    if (blocks >= kManyBlocks && bands > kManyBands) bands = kManyBands;
  }
  if (bands < 1 || bands > max_bands || bands % per_warp != 0) return false;
  *out = {tile, rows, bands, tile * bands, blocks};
  return true;
}

// The along-W layout; `aligned`: W % 4 == 0 and 16-byte aligned tensors.
// Only the cells per lane can be forced.
bool choose_w_layout(long long R, long long H, bool aligned, int tile,
                     int rows, int bands, Layout* out) {
  const int cells = tile ? tile : (aligned ? 4 : 1);
  if (rows || bands || (cells != 1 && cells != 4) ||
      (cells == 4 && !aligned)) {
    return false;
  }
  *out = {cells, 0, 0, kRowThreads, cdiv(R * H, kRowThreads / 32)};
  return true;
}

bool choose_layout(long long R, long long H, long long W, int axis,
                   bool aligned, int tile, int rows, int bands, Layout* out) {
  // positions, rows and columns stay well inside int32 (H, W < 2^30)
  if (R < 1 || H < 1 || W < 1 || H >= kInf || W >= kInf) return false;
  if (axis == 1) return choose_h_layout(R, H, W, tile, rows, bands, out);
  return axis == 2 && choose_w_layout(R, H, aligned, tile, rows, bands, out);
}

struct Args {
  const int* d;
  const uint8_t* m;
  int* o;
  long long R;
  int H, W;
  long long mstride;
  int reverse;
  cudaStream_t s;
};

unsigned grid_of(const Layout& L) {
  return static_cast<unsigned>(L.blocks < kMaxGrid ? L.blocks : kMaxGrid);
}

template <int TW>
void launch_bands(const Layout& L, const Args& a) {
  if (L.rows == 8) {
    sweep_along_h<TW, 8><<<grid_of(L), L.threads, 0, a.s>>>(
        a.d, a.m, a.o, a.R, a.H, a.W, a.mstride, L.bands, a.reverse);
  } else {
    sweep_along_h<TW, 16><<<grid_of(L), L.threads, 0, a.s>>>(
        a.d, a.m, a.o, a.R, a.H, a.W, a.mstride, L.bands, a.reverse);
  }
}

template <int kCells>
void launch_rows(const Layout& L, const Args& a) {
  sweep_along_w<kCells><<<grid_of(L), L.threads, 0, a.s>>>(
      a.d, a.m, a.o, a.R * a.H, a.H, a.W, a.mstride, a.reverse);
}

void launch(int axis, const Layout& L, const Args& a) {
  if (axis == 2) {
    return L.tile == 4 ? launch_rows<4>(L, a) : launch_rows<1>(L, a);
  }
  switch (L.tile) {
    case 8: return launch_bands<8>(L, a);
    case 16: return launch_bands<16>(L, a);
    default: return launch_bands<32>(L, a);
  }
}

}  // namespace

// The layout `sweep_scan_forced` takes for these arguments, without
// launching: out = {tile, rows, bands, threads, blocks} as in Layout,
// assuming 16-byte aligned tensors, as every fresh allocation is.  Returns
// 0, or cudaErrorInvalidValue for a shape or forced layout the kernel does
// not take.
extern "C" int sweep_scan_layout(long long R, long long H, long long W,
                                 int axis, int tile, int rows, int bands,
                                 long long* out) {
  Layout L;
  if (!choose_layout(R, H, W, axis, W % 4 == 0, tile, rows, bands, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  out[0] = L.tile, out[1] = L.rows, out[2] = L.bands, out[3] = L.threads;
  out[4] = L.blocks;
  return 0;
}

extern "C" int sweep_scan_forced(const void* d, const void* blocked, void* out,
                                 long long R, long long H, long long W,
                                 long long mstride, int axis, int reverse,
                                 int tile, int rows, int bands,
                                 void* stream) {
  if (mstride < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = W % 4 == 0 && mstride % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(d) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(blocked) % 4 == 0;
  Layout L;
  if (!choose_layout(R, H, W, axis, aligned, tile, rows, bands, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const int*>(d),
               static_cast<const uint8_t*>(blocked),
               static_cast<int*>(out),
               R,
               static_cast<int>(H),
               static_cast<int>(W),
               mstride,
               reverse,
               static_cast<cudaStream_t>(stream)};
  launch(axis, L, a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sweep_scan(const void* d, const void* blocked, void* out,
                          long long R, long long H, long long W,
                          long long mstride, int axis, int reverse,
                          void* stream) {
  return sweep_scan_forced(d, blocked, out, R, H, W, mstride, axis, reverse,
                           0, 0, 0, stream);
}
