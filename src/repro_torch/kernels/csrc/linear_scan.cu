// Gated linear recurrence h_t = a_t ⊙ h_{t−1} + b_t over (rows, S, D), h_0 = b_0
// (B12), forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/linear_scan.py
// (_scan_launch → _scan_kernel): the forward launch, and the custom VJP's
// backward, which is the same launch over the reversed, shifted sequence
// followed by two elementwise products.
//
// Both directions are bound by device-memory bytes: one multiply and one add
// per element.  The forward must read a and b and write h (12 bytes an
// element); the backward reads a_{t+1}, dh_t and h_{t−1} and writes g = db and
// da = g ⊙ h_{t−1} (20 bytes an element).
//
// Design.  The TPU walks S tiles in order on one core with the carry in VMEM
// and closes each tile with an associative scan.  Here every (row, channel) is
// an independent sequence, so one thread owns one and walks S in order with
// the carry in a register: no carry ever leaves the thread, no second pass,
// no atomics, and every sum in one order (two launches give equal bits).
//   * D is the contiguous axis, so neighbouring threads read neighbouring
//     addresses at each step and every load and store coalesces.
//   * The walk is unrolled by kUnroll steps: the steps' loads are issued
//     together before the dependent chain of multiply-adds, so each thread
//     keeps 2·kUnroll (forward) or 3·kUnroll (backward) loads in flight.
//   * Ragged S and D need no padding: the channel index is bounded and a
//     remainder loop finishes the sequence.  Indices are 64-bit.
//   * The backward reads a_{t+1} in place, so no flipped or rolled copy of a
//     or dh is made, and fuses the epilogue da = g ⊙ h_{t−1} (h_{−1} = 0).
//   * Each step rounds the product and then the sum (no contracted
//     multiply-add), in the plain version's order (kernels/ref.py), so the
//     kernels give its bits.
// The weakness: parallelism is rows·D threads.  At the SSM path's (2, ·,
// 131,072) that fills the card; at the hybrid's (2, ·, 2,560) it is 5,120
// threads, a few per SM, and the walk is then bound by load latency, not
// bandwidth.  A chunked two-pass scan (chunk-local scans, then a carry pass
// over the chunk summaries) is the fix for that shape.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxGridY = 65535;

__global__ void linear_scan_fwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ h, int64_t rows,
                                       int64_t S, int64_t D) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= D) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t base = r * S * D + c;
    const float* ar = a + base;
    const float* br = b + base;
    float* hr = h + base;
    float carry = br[0];  // h_0 = b_0
    hr[0] = carry;
    int64_t t = 1;
    for (; t + kUnroll <= S; t += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = ar[(t + u) * D];
        bv[u] = br[(t + u) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        hr[(t + u) * D] = carry;
      }
    }
    for (; t < S; ++t) {
      carry = __fadd_rn(__fmul_rn(ar[t * D], carry), br[t * D]);
      hr[t * D] = carry;
    }
  }
}

__global__ void linear_scan_bwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ h,
                                       const float* __restrict__ dh,
                                       float* __restrict__ da,
                                       float* __restrict__ g_out,
                                       int64_t rows, int64_t S, int64_t D) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= D) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t base = r * S * D + c;
    const float* ar = a + base;
    const float* hr = h + base;
    const float* dr = dh + base;
    float* dar = da + base;
    float* gr = g_out + base;
    // g_{S−1} = dh_{S−1}
    int64_t t = S - 1;
    float g = dr[t * D];
    gr[t * D] = g;
    dar[t * D] = __fmul_rn(g, t > 0 ? hr[(t - 1) * D] : 0.0f);
    --t;
    // steps t, t−1, …, t−kUnroll+1, all with t − u − 1 ≥ 0
    for (; t - kUnroll >= 0; t -= kUnroll) {
      float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dv[u] = dr[(t - u) * D];
        av[u] = ar[(t - u + 1) * D];
        hv[u] = hr[(t - u - 1) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        g = __fadd_rn(dv[u], __fmul_rn(av[u], g));
        gr[(t - u) * D] = g;
        dar[(t - u) * D] = __fmul_rn(g, hv[u]);
      }
    }
    for (; t >= 0; --t) {
      g = __fadd_rn(dr[t * D], __fmul_rn(ar[(t + 1) * D], g));
      gr[t * D] = g;
      dar[t * D] = __fmul_rn(g, t > 0 ? hr[(t - 1) * D] : 0.0f);
    }
  }
}

// Threads a block: the most of 256, 128, 64 that still gives two blocks an
// SM (264 on an H100) over the channel tiles of every row, else 32; fewer
// threads a block spread few sequences over more SMs.
dim3 block_for(int64_t rows, int64_t D) {
  int threads = 256;
  while (threads > 32 && rows * ((D + threads - 1) / threads) < 264) {
    threads /= 2;
  }
  return dim3(threads);
}

dim3 grid_for(int64_t rows, int64_t D, int threads) {
  const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
  return dim3(static_cast<unsigned>((D + threads - 1) / threads),
              static_cast<unsigned>(gy));
}

}  // namespace

extern "C" int linear_scan_fwd(const float* a, const float* b, float* h,
                               int64_t rows, int64_t S, int64_t D,
                               cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block = block_for(rows, D);
  linear_scan_fwd_kernel<<<grid_for(rows, D, block.x), block, 0, stream>>>(
      a, b, h, rows, S, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_bwd(const float* a, const float* h,
                               const float* dh, float* da, float* g,
                               int64_t rows, int64_t S, int64_t D,
                               cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block = block_for(rows, D);
  linear_scan_bwd_kernel<<<grid_for(rows, D, block.x), block, 0, stream>>>(
      a, h, dh, da, g, rows, S, D);
  return static_cast<int>(cudaGetLastError());
}
