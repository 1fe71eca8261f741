// field_fused: the whole next-hop direction field of a batch of goals in one
// launch -- goal seed, fast-sweeping fixpoint, next-hop codes -- as a
// hand-written CUDA kernel for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package's fused field
// engine, one template instance each (kFields = fields owned by one block):
//   kFields = 1: p2p_distributed_tswap_tpu/ops/field_fused.py:166  _kernel
//                (one field per program, MAPD_FUSED=single)
//   kFields = 8: p2p_distributed_tswap_tpu/ops/field_fused.py:357  _multi_kernel
//                (eight fields per program, MAPD_FUSED=1 or multi)
//
// What a block computes, for each field f it owns (goal g_f, one (H, W) mask
// shared by every field, INF = 2^30):
//   1. seed: d = 0 at cell g_f if that cell is free, INF everywhere else;
//   2. rounds of four passes -- along W forward, along W reverse, along H
//      forward, along H reverse -- each the recurrence of csrc/sweep_scan.cu
//          run = INF; run = min(run + 1, d[i]); run = INF if blocked[i];
//          d[i] = min(run, INF)
//      until no pass of the round changes any of the block's fields, or
//      max_rounds rounds have run.  The convergence flag is a
//      __syncthreads_or per pass, never a host sync.  Rounds on a field that
//      has converged change nothing, so per-block convergence gives the same
//      fields as whole-batch convergence (ops/distance.py _fixpoint) even
//      where max_rounds binds;
//   3. codes: the neighbours in DIR_DXDY order (down, right, up, left), INF
//      off the grid, strict < (the first minimum wins); code 4 (stay) where
//      d == 0, d >= INF, best >= INF, best >= d or the cell is blocked.
// Bit-identical to the plain version (ops/field_fused.py fields_plain).
//
// Layout.  Codes are written as (G, H, W) uint8 directly; the multi
// instance's goals arrive padded to a multiple of 8 by repeating the last goal
// (as the Pallas wrapper pads them) and the padded fields are computed and not
// written.  The distance scratch is (G_pad, H, W) int32 in device memory,
// allocated by the caller: a 1024^2 field is 4 MB and a 256^2 field 256 KB,
// both past the 227 KB of shared memory a block may use, so the fields live
// in device memory and mostly in the 50 MB L2.  The mask is held in shared
// memory as bits, one 32-bit word per 32 cells of a row (rows padded to whole
// words): 128 KB at 1024^2.  A small first kernel packs those bits from the
// (H, W) uint8 mask into a device buffer, which every block copies in.
//
// Threads.  1024 per block, one block per SM at 1024^2 (the mask's shared
// memory), __launch_bounds__ caps registers at 64 a thread.
//   along W: one warp per row, as sweep_scan: 32-cell chunks, a ballot for
//     the last obstacle at or before each lane, a five-step shuffle
//     segmented minimum of d[k] - k, and the carry (lane 31's run) from the
//     previous chunk.  The carry stays in the warp's registers from chunk to
//     chunk of its row, so no other thread touches it.  kChunks chunks are
//     loaded before their dependent scans run, to keep loads in flight.
//   along H: one thread per (field, column), the run in a register down the
//     rows, kUnroll rows loaded ahead of the dependent min chain.
//   A cell is written back only when its value changes.
//
// Bound on an H100.  What the function must move is the mask read once and
// the codes written once, (H*W + G*H*W) bytes; the integer work is about 16
// operations per cell per round plus about 23 per cell for the seed and the
// codes, which at these shapes and measured round counts (chip_smoke.py)
// outweighs the bytes.  Trouble spots, recorded and not tuned here: the
// in-step chunk of 4 fields fills 4 (single) or 1 (multi) of 132 SMs, and at
// 1024^2 each along-H pass is a 1024-long dependent chain per thread.
//
// Interface: plain C, loaded with ctypes.  The caller passes device pointers
// and the CUDA stream; the launches are asynchronous and allocate nothing.
// Returns cudaGetLastError() after the launches (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kStay = 4;
constexpr int kThreads = 1024;
constexpr int kUnroll = 8;
constexpr int kChunks = 8;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a block may use on sm_90, less room for the static goals.
constexpr long long kMaxBitsBytes = 232448 - 1024;

__device__ __forceinline__ bool is_blocked(const uint32_t* bits, int wp, int y,
                                           int x) {
  return (bits[y * wp + (x >> 5)] >> (x & 31)) & 1u;
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

// One pass along W over rows [0, nrows) of the block's fields (row r is row
// r % H of field r / H).  Returns whether this thread changed a cell.
__device__ bool pass_along_w(int* d, const uint32_t* bits, int nrows, int H,
                             int W, int wp, bool reverse) {
  const int lane = threadIdx.x & 31;
  const unsigned upto_lane = kFull >> (31 - lane);  // lanes 0..lane
  bool changed = false;
  for (int r = threadIdx.x >> 5; r < nrows; r += kThreads / 32) {
    const int y = r % H;
    int* row = d + static_cast<long long>(r) * W;
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
        bl[k] = valid && is_blocked(bits, wp, y, x);
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

// One pass along H over the columns of `nfields` fields.  Returns whether
// this thread changed a cell.
__device__ bool pass_along_h(int* d, const uint32_t* bits, int nfields, int H,
                             int W, int wp, bool reverse) {
  bool changed = false;
  const int ncols = nfields * W;
  for (int c = threadIdx.x; c < ncols; c += kThreads) {
    const int f = c / W;
    const int x = c - f * W;
    int* col = d + static_cast<long long>(f) * H * W + x;
    const uint32_t* mcol = bits + (x >> 5);
    const int shift = x & 31;
    int run = kInf;
    int i = 0;
    for (; i + kUnroll <= H; i += kUnroll) {
      int dv[kUnroll];
      bool mv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int y = reverse ? H - 1 - (i + k) : i + k;
        dv[k] = col[static_cast<long long>(y) * W];
        mv[k] = (mcol[y * wp] >> shift) & 1u;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int y = reverse ? H - 1 - (i + k) : i + k;
        run = min(run + 1, dv[k]);
        if (mv[k]) run = kInf;
        const int out = min(run, kInf);
        if (out != dv[k]) {
          col[static_cast<long long>(y) * W] = out;
          changed = true;
        }
      }
    }
    for (; i < H; ++i) {
      const int y = reverse ? H - 1 - i : i;
      const int dv = col[static_cast<long long>(y) * W];
      run = min(run + 1, dv);
      if ((mcol[y * wp] >> shift) & 1u) run = kInf;
      const int out = min(run, kInf);
      if (out != dv) {
        col[static_cast<long long>(y) * W] = out;
        changed = true;
      }
    }
  }
  return changed;
}

template <int kFields>
__global__ void __launch_bounds__(kThreads, 1)
    field_fused_kernel(const int* __restrict__ goals, int g_out,
                       const uint32_t* __restrict__ bits_in, int* dist,
                       uint8_t* __restrict__ codes, int* __restrict__ rounds_out,
                       int H, int W, int wp, int max_rounds) {
  extern __shared__ uint32_t bits[];  // H * wp words, bit set = blocked
  __shared__ int goal_s[kFields];
  const int plane = H * W;  // the wrapper keeps kFields * H * W < 2^31
  const long long g0 = static_cast<long long>(blockIdx.x) * kFields;
  int* d = dist + g0 * plane;

  for (int i = threadIdx.x; i < H * wp; i += kThreads) bits[i] = bits_in[i];
  if (threadIdx.x < kFields) goal_s[threadIdx.x] = goals[g0 + threadIdx.x];
  __syncthreads();

  // ---- seed: 0 at the goal cell if it is free, INF elsewhere ----
  for (int f = 0; f < kFields; ++f) {
    const int goal = goal_s[f];
    int* df = d + f * plane;
    for (int cell = threadIdx.x; cell < plane; cell += kThreads) {
      const int y = cell / W;
      const bool seed = cell == goal && !is_blocked(bits, wp, y, cell - y * W);
      df[cell] = seed ? 0 : kInf;
    }
  }
  __syncthreads();

  // ---- fixpoint: rounds of four passes until none changes a cell ----
  int rounds = 0;
  bool changed = true;
  while (changed && rounds < max_rounds) {
    int c = __syncthreads_or(
        pass_along_w(d, bits, kFields * H, H, W, wp, false));
    c |= __syncthreads_or(pass_along_w(d, bits, kFields * H, H, W, wp, true));
    c |= __syncthreads_or(pass_along_h(d, bits, kFields, H, W, wp, false));
    c |= __syncthreads_or(pass_along_h(d, bits, kFields, H, W, wp, true));
    changed = c != 0;
    ++rounds;
  }
  if (threadIdx.x == 0) rounds_out[blockIdx.x] = rounds;

  // ---- next-hop codes of the fields that are not padding ----
  const long long left_over = g_out - g0;
  const int nreal = left_over < kFields ? static_cast<int>(left_over) : kFields;
  for (int f = 0; f < nreal; ++f) {
    const int* df = d + f * plane;
    uint8_t* cf = codes + (g0 + f) * plane;
    for (int cell = threadIdx.x; cell < plane; cell += kThreads) {
      const int y = cell / W;
      const int x = cell - y * W;
      const int cur = df[cell];
      // DIR_DXDY order: (0,1) down, (1,0) right, (0,-1) up, (-1,0) left
      const int nv[4] = {y + 1 < H ? df[cell + W] : kInf,
                         x + 1 < W ? df[cell + 1] : kInf,
                         y > 0 ? df[cell - W] : kInf,
                         x > 0 ? df[cell - 1] : kInf};
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
                        best_val >= cur || is_blocked(bits, wp, y, x);
      cf[cell] = static_cast<uint8_t>(stay ? kStay : best);
    }
  }
}

template <int kFields>
int launch(const int* goals, long long g_pad, long long g_out,
           const uint32_t* bits, int* dist, uint8_t* codes, int* rounds,
           int H, int W, int wp, int max_rounds, cudaStream_t s) {
  const int smem = H * wp * 4;
  cudaError_t err = cudaFuncSetAttribute(
      field_fused_kernel<kFields>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  field_fused_kernel<kFields>
      <<<static_cast<unsigned>(g_pad / kFields), kThreads, smem, s>>>(
          goals, static_cast<int>(g_out), bits, dist, codes, rounds, H, W, wp,
          max_rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// goals (g_pad,) int32; blocked (H, W) uint8, nonzero = obstacle; bits
// (H, ceil(W/32)) 32-bit scratch; dist (g_pad, H, W) int32 scratch; codes
// (g_out, H, W) uint8 out; rounds (g_pad / fields_per_block,) int32 out: the
// rounds each block ran.  fields_per_block is 1 or 8 and divides g_pad.
extern "C" int field_fused(const void* goals, long long g_pad, long long g_out,
                           const void* blocked, void* bits, void* dist,
                           void* codes, void* rounds, long long H, long long W,
                           int fields_per_block, int max_rounds,
                           void* stream) {
  const long long wp = (W + 31) / 32;
  if ((fields_per_block != 1 && fields_per_block != 8) || H < 1 || W < 1 ||
      g_out < 1 || g_pad < g_out || g_pad % fields_per_block != 0 ||
      g_pad / fields_per_block > 0x7fffffffLL || max_rounds < 0 ||
      H * wp * 4 > kMaxBitsBytes ||
      fields_per_block * H * W > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int h = static_cast<int>(H);
  const int w = static_cast<int>(W);
  const int wpi = static_cast<int>(wp);
  uint32_t* bp = static_cast<uint32_t*>(bits);
  const long long pack_threads = H * wp * 32;
  pack_blocked_bits<<<static_cast<unsigned>((pack_threads + 255) / 256), 256,
                       0, s>>>(static_cast<const uint8_t*>(blocked), bp, h, w,
                               wpi);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int* gp = static_cast<const int*>(goals);
  int* dp = static_cast<int*>(dist);
  uint8_t* cp = static_cast<uint8_t*>(codes);
  int* rp = static_cast<int*>(rounds);
  if (fields_per_block == 1) {
    return launch<1>(gp, g_pad, g_out, bp, dp, cp, rp, h, w, wpi, max_rounds,
                     s);
  }
  return launch<8>(gp, g_pad, g_out, bp, dp, cp, rp, h, w, wpi, max_rounds, s);
}
