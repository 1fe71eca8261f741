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
// What it computes, for d (R, H, W) int32 and one (H, W) uint8 mask shared by
// all R fields (nonzero = blocked), along `axis` (1 = H, 2 = W), walking the
// axis forward or in reverse, with INF = 2^30:
//
//     run    = INF                       (before the first cell)
//     run    = min(run + 1, d[i])        relax from the predecessor
//     run    = INF      if blocked[i]    obstacles reset the segment
//     out[i] = min(run, INF)
//
// Bit-identical to the doubling-scan plain version (ops/sweep_kernel.py,
// sweep_plain) for inputs in [0, INF]; run never exceeds INF, so no int32 sum
// below can overflow.
//
// Bound on an H100: device-memory bytes.  Each cell is read once, written
// once, and costs three integer operations, so a sweep moves 8 bytes per cell
// (plus the mask, which stays in the 50 MB L2 across the batch) and sits far
// below the card's operations-per-byte line.  The design keeps every access
// coalesced and touches each byte once:
//
//   axis 1 (along H): one thread per (field, column) keeps `run` in a
//     register and walks down the rows; the 32 threads of a warp read 32
//     neighbouring columns, so each row step is one 128-byte transaction.
//     Rows are loaded UNROLL at a time before the dependent min chain runs,
//     to keep several loads in flight per thread.
//     Trouble spot: in-step replans sweep R = 4 fields at 1024^2, which is
//     only 4 x 1024 column threads (128 warps) for 132 SMs, so this
//     direction is latency-bound there, not bandwidth-bound.
//   axis 2 (along W): one warp per (field, row) walks the row in 32-cell
//     chunks, one coalesced 128-byte load per chunk.  Inside a chunk the
//     recurrence is a segmented min-plus scan: a ballot finds the last
//     blocked lane at or before each lane, five shuffle rounds take the
//     segmented minimum of d[k] - k, and the carry from the previous chunk
//     (lane 31's run) enters lanes that no obstacle separates from it.
//     No transposed copy is made.
//
// Interface: plain C, loaded with ctypes.  The caller passes device pointers
// and the CUDA stream; the launch is asynchronous and allocates nothing.
// Returns cudaGetLastError() after the launch (0 = success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kUnroll = 8;
constexpr int kColThreads = 128;
constexpr int kRowThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void sweep_along_h(const int* __restrict__ d,
                              const uint8_t* __restrict__ blocked,
                              int* __restrict__ out, int R, int H, int W,
                              int reverse) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const long long plane = static_cast<long long>(H) * W;
  for (int r = blockIdx.y; r < R; r += gridDim.y) {
    const int* dp = d + r * plane + x;
    int* op = out + r * plane + x;
    const uint8_t* mp = blocked + x;
    int run = kInf;
    int i = 0;
    for (; i + kUnroll <= H; i += kUnroll) {
      int dv[kUnroll];
      uint8_t mv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long y = reverse ? H - 1 - (i + k) : i + k;
        dv[k] = dp[y * W];
        mv[k] = mp[y * W];
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long y = reverse ? H - 1 - (i + k) : i + k;
        run = min(run + 1, dv[k]);
        if (mv[k]) run = kInf;
        op[y * W] = min(run, kInf);
      }
    }
    for (; i < H; ++i) {
      const long long y = reverse ? H - 1 - i : i;
      run = min(run + 1, dp[y * W]);
      if (mp[y * W]) run = kInf;
      op[y * W] = min(run, kInf);
    }
  }
}

__global__ void sweep_along_w(const int* __restrict__ d,
                              const uint8_t* __restrict__ blocked,
                              int* __restrict__ out, long long rows, int H,
                              int W, int reverse) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (row >= rows) return;  // uniform across the warp
  const int y = static_cast<int>(row % H);
  const int* dp = d + row * W;
  int* op = out + row * W;
  const uint8_t* mp = blocked + static_cast<long long>(y) * W;
  const unsigned upto_lane = kFull >> (31 - lane);  // lanes 0..lane
  int carry = kInf;
  for (int base = 0; base < W; base += 32) {
    const int i = base + lane;  // position in scan order
    const bool valid = i < W;
    const int x = reverse ? W - 1 - i : i;
    // Lanes past the row's end hold a free INF cell: they sit after every
    // valid lane in scan order, so they never reach a valid lane's result.
    const int dv = valid ? dp[x] : kInf;
    const bool bl = valid && mp[x] != 0;
    const unsigned before = __ballot_sync(kFull, bl) & upto_lane;
    const int last_blocked = before ? 31 - __clz(before) : -1;
    // segmented min over lanes (last_blocked, lane] of d[k] - k
    int m = dv - lane;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, m, off);
      if (lane - off > last_blocked) m = min(m, o);
    }
    const int seg = m + lane;  // min over the segment of d[k] + (lane - k)
    int run;
    if (bl) {
      run = kInf;
    } else if (last_blocked >= 0) {
      run = seg;
    } else {
      run = min(carry + lane + 1, seg);
    }
    if (valid) op[x] = min(run, kInf);
    carry = __shfl_sync(kFull, run, 31);
  }
}

}  // namespace

extern "C" int sweep_scan(const void* d, const void* blocked, void* out,
                          long long R, long long H, long long W, int axis,
                          int reverse, void* stream) {
  if (R < 1 || H < 1 || W < 1 || H > 0x7fffffff || W > 0x7fffffff ||
      (axis != 1 && axis != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* dp = static_cast<const int*>(d);
  const uint8_t* mp = static_cast<const uint8_t*>(blocked);
  int* op = static_cast<int*>(out);
  if (axis == 1) {
    dim3 grid(static_cast<unsigned>((W + kColThreads - 1) / kColThreads),
              static_cast<unsigned>(R < 65535 ? R : 65535));
    sweep_along_h<<<grid, kColThreads, 0, s>>>(dp, mp, op, static_cast<int>(R),
                                               static_cast<int>(H),
                                               static_cast<int>(W), reverse);
  } else {
    const long long rows = R * H;
    const long long warps_per_block = kRowThreads / 32;
    const long long blocks = (rows + warps_per_block - 1) / warps_per_block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    sweep_along_w<<<static_cast<unsigned>(blocks), kRowThreads, 0, s>>>(
        dp, mp, op, rows, static_cast<int>(H), static_cast<int>(W), reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
