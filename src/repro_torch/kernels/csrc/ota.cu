// Over-the-air signal path: modulate (B1), fused receive (B2), demodulate
// (B3, B3′) and the worker-at-a-time accumulate (B13), for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ota.py:
//   * ota_modulate  (_mod_kernel)      s = conj(h)·θ + conj(λ)/ρ
//   * ota_receive   (_receive_kernel)  Θ = (Σ_w Re{h_w ⊙ s_w} + z·α⁻¹) / max(Σ_w |h_w|², 1e-12)
//   * ota_demodulate_dyn (_demod_dyn_kernel) and ota_demodulate
//     (_demod_kernel)                 Θ = (y + z·α⁻¹) / max(p2, 1e-12) over (d,)
//   * ota_accumulate (_accumulate_kernel)  y += h_re·s_re − h_im·s_im,
//                                          p2 += h_re² + h_im² over (d,)
//
// All are bound by device-memory bytes: a few flops per f32 element read
// once.  The design therefore reads every input byte once and writes every
// output byte once, and keeps intermediates in registers:
//   * modulate is one thread per element in a grid-stride loop; neighbouring
//     threads touch neighbouring addresses, so every load and store coalesces.
//     It and the unsplit receive round at each step in the plain version's
//     order (no contracted multiply-add), as B6's column plan does, so the
//     leafwise round (B1 then B2 a leaf) gives the packed round's bits where
//     the W sums run in the same order.
//   * receive is one thread per column j where the columns fill the card
//     (the paper MLP's d = 109,386: 428 blocks).  The thread walks the W
//     worker rows, keeping the superposition y and the pilot p2 in
//     registers, so the (d,) sums never reach device memory.  Within one row
//     neighbouring threads read neighbouring columns, so the loads coalesce.
//   * where they cannot (65,536 workers over d = 32: one block of 32
//     threads walking 65,536 rows), the receive splits the worker axis as
//     B6's row plan does (kernels/ota_round.py, row_tiling): a block is 8
//     warps over a tile of 32·k columns and a slice of the rows, a warp
//     takes whole rows, y/p2 meet across the warps in shared memory and go
//     to a (d, n_slices) partial; a finalize pass, one warp per column, sums
//     the partials lane-strided in a fixed order and applies Θ's epilogue
//     in the plain version's rounding order.  No float atomics.
// Loads are scalar: rows of a (W, d) plane start only 4-byte aligned when d
// is odd (the paper MLP has d = 109,386), so float4 loads across rows would
// be misaligned.  Indices are 64-bit: packed buffers exceed 2^31 elements.
// α⁻¹ is read through a device pointer, so the host never synchronises on it.
//   * demodulate is one thread per element, one body for two entries: B3
//     reads α⁻¹ through a device pointer (power control's data-dependent α),
//     B3′ takes it as a host float (a constant α, the guarded round's 1.0).
//     It rounds at each step in the plain version's order (no contracted
//     multiply-add), so it gives the plain version's bits.
//   * accumulate is one thread per element in a grid-stride loop: the two
//     running sums share the h planes, so one pass reads the six (d,) planes
//     once and writes y and p2 once (32 bytes an element).  Rounded in the
//     plain version's order, term first, then the add.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void modulate_kernel(const float* __restrict__ theta,
                                const float* __restrict__ lam_re,
                                const float* __restrict__ lam_im,
                                const float* __restrict__ h_re,
                                const float* __restrict__ h_im,
                                float* __restrict__ s_re,
                                float* __restrict__ s_im,
                                int64_t n, float inv_rho) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float t = theta[i];
    // the plain version's order, rounded at each step (no contracted
    // multiply-add), as B6 modulates in its registers
    s_re[i] = __fadd_rn(__fmul_rn(h_re[i], t), __fmul_rn(lam_re[i], inv_rho));
    s_im[i] = __fsub_rn(__fmul_rn(-h_im[i], t), __fmul_rn(lam_im[i], inv_rho));
  }
}

__device__ __forceinline__ float demod(float y, float z, float ia, float p2) {
  // the plain version's order, rounded at each step as it is
  return __fdiv_rn(__fadd_rn(y, __fmul_rn(z, ia)), fmaxf(p2, 1e-12f));
}

__global__ void receive_kernel(const float* __restrict__ s_re,
                               const float* __restrict__ s_im,
                               const float* __restrict__ h_re,
                               const float* __restrict__ h_im,
                               const float* __restrict__ noise_re,
                               const float* __restrict__ inv_alpha,
                               float* __restrict__ out,
                               int64_t n_workers, int64_t d) {
  const float ia = *inv_alpha;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < d; j += stride) {
    float y = 0.0f;
    float p2 = 0.0f;
    for (int64_t w = 0; w < n_workers; ++w) {
      const int64_t k = w * d + j;
      const float hr = h_re[k];
      const float hi = h_im[k];
      y = __fadd_rn(y, __fsub_rn(__fmul_rn(hr, s_re[k]),
                                 __fmul_rn(hi, s_im[k])));
      p2 = __fadd_rn(p2, __fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi)));
    }
    // ia == 0 (all workers energy-free) adds exactly 0 for a finite z
    out[j] = demod(y, noise_re[j], ia, p2);
  }
}

constexpr int kSplitWarps = 8;
constexpr int kSplitThreads = kSplitWarps * 32;
constexpr int kSplitMaxK = 4;
constexpr int64_t kMaxSlices = 65535;  // gridDim.y

// Block (tile, slice): columns [32·k·tile, +32·k), rows [rows·slice, +rows).
// With one slice it writes Θ; with several, the (d, n_slices) partials.
__global__ void __launch_bounds__(kSplitThreads)
receive_split_kernel(const float* __restrict__ s_re,
                     const float* __restrict__ s_im,
                     const float* __restrict__ h_re,
                     const float* __restrict__ h_im,
                     const float* __restrict__ noise_re,
                     const float* __restrict__ inv_alpha,
                     float* __restrict__ out, float* __restrict__ y_part,
                     float* __restrict__ p2_part, int64_t n_workers,
                     int64_t d, int k, int64_t rows_per_slice,
                     int64_t n_slices) {
  __shared__ float sy[kSplitWarps][kSplitMaxK * 32];
  __shared__ float sp[kSplitWarps][kSplitMaxK * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t slice = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * 32 * k;
  const int64_t r0 = slice * rows_per_slice;
  const int64_t r1 = r0 + rows_per_slice < n_workers ? r0 + rows_per_slice
                                                     : n_workers;
  float y[kSplitMaxK];
  float p2[kSplitMaxK];
#pragma unroll
  for (int j = 0; j < kSplitMaxK; ++j) {
    y[j] = 0.0f;
    p2[j] = 0.0f;
  }
#pragma unroll 4
  for (int64_t r = r0 + warp; r < r1; r += kSplitWarps) {
#pragma unroll
    for (int j = 0; j < kSplitMaxK; ++j) {
      const int64_t c = c0 + lane + 32 * j;
      if (j >= k || c >= d) continue;
      const int64_t i = r * d + c;
      const float hr = h_re[i];
      const float hi = h_im[i];
      y[j] += hr * s_re[i] - hi * s_im[i];
      p2[j] += hr * hr + hi * hi;
    }
  }
#pragma unroll
  for (int j = 0; j < kSplitMaxK; ++j) {
    sy[warp][lane + 32 * j] = y[j];
    sp[warp][lane + 32 * j] = p2[j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * k; t += kSplitThreads) {
    const int64_t c = c0 + t;
    if (c >= d) continue;
    float ys = 0.0f;
    float ps = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      ys += sy[w][t];
      ps += sp[w][t];
    }
    if (n_slices > 1) {
      y_part[c * n_slices + slice] = ys;
      p2_part[c * n_slices + slice] = ps;
    } else {
      out[c] = demod(ys, noise_re[c], *inv_alpha, ps);
    }
  }
}

// One warp per column: its n_slices partials, lane-strided, then a
// warp-shuffle tree, then Θ.
__global__ void receive_finalize_kernel(const float* __restrict__ y_part,
                                        const float* __restrict__ p2_part,
                                        const float* __restrict__ noise_re,
                                        const float* __restrict__ inv_alpha,
                                        float* __restrict__ out, int64_t d,
                                        int64_t n_slices) {
  const int64_t c = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (c >= d) return;  // the same for every lane of the warp
  float ys = 0.0f;
  float ps = 0.0f;
  for (int64_t s = lane; s < n_slices; s += 32) {
    ys += y_part[c * n_slices + s];
    ps += p2_part[c * n_slices + s];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ys += __shfl_down_sync(0xffffffffu, ys, off);
    ps += __shfl_down_sync(0xffffffffu, ps, off);
  }
  if (lane == 0) out[c] = demod(ys, noise_re[c], *inv_alpha, ps);
}

__global__ void demodulate_kernel(const float* __restrict__ y,
                                  const float* __restrict__ noise_re,
                                  const float* __restrict__ p2,
                                  const float* __restrict__ inv_alpha,
                                  float ia_host, float* __restrict__ out,
                                  int64_t n) {
  const float ia = inv_alpha != nullptr ? *inv_alpha : ia_host;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = demod(y[i], noise_re[i], ia, p2[i]);
  }
}

__global__ void accumulate_kernel(const float* __restrict__ y,
                                  const float* __restrict__ p2,
                                  const float* __restrict__ s_re,
                                  const float* __restrict__ s_im,
                                  const float* __restrict__ h_re,
                                  const float* __restrict__ h_im,
                                  float* __restrict__ y_out,
                                  float* __restrict__ p2_out, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float hr = h_re[i];
    const float hi = h_im[i];
    y_out[i] = __fadd_rn(y[i], __fsub_rn(__fmul_rn(hr, s_re[i]),
                                         __fmul_rn(hi, s_im[i])));
    p2_out[i] = __fadd_rn(p2[i], __fadd_rn(__fmul_rn(hr, hr),
                                           __fmul_rn(hi, hi)));
  }
}

}  // namespace

extern "C" int ota_modulate(const float* theta, const float* lam_re,
                            const float* lam_im, const float* h_re,
                            const float* h_im, float* s_re, float* s_im,
                            int64_t n, float inv_rho, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  modulate_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      theta, lam_re, lam_im, h_re, h_im, s_re, s_im, n, inv_rho);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ota_receive(const float* s_re, const float* s_im,
                           const float* h_re, const float* h_im,
                           const float* noise_re, const float* inv_alpha,
                           float* out, int64_t n_workers, int64_t d,
                           cudaStream_t stream) {
  if (d <= 0) return static_cast<int>(cudaSuccess);
  receive_kernel<<<grid_for(d), kThreads, 0, stream>>>(
      s_re, s_im, h_re, h_im, noise_re, inv_alpha, out, n_workers, d);
  return static_cast<int>(cudaGetLastError());
}

// B2 with the worker axis split: y_part/p2_part are (d, n_slices) scratch,
// used when n_slices > 1 (else may be null).
extern "C" int ota_receive_split(const float* s_re, const float* s_im,
                                 const float* h_re, const float* h_im,
                                 const float* noise_re,
                                 const float* inv_alpha, float* y_part,
                                 float* p2_part, float* out,
                                 int64_t n_workers, int64_t d, int k,
                                 int64_t rows_per_slice,
                                 cudaStream_t stream) {
  if (n_workers <= 0 || d <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k > kSplitMaxK || rows_per_slice < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (d + 32 * k - 1) / (32 * k);
  const int64_t n_slices = (n_workers + rows_per_slice - 1) / rows_per_slice;
  if (n_slices > kMaxSlices || n_tiles > INT32_MAX
      || (n_slices > 1 && (y_part == nullptr || p2_part == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(n_slices));
  receive_split_kernel<<<grid, kSplitThreads, 0, stream>>>(
      s_re, s_im, h_re, h_im, noise_re, inv_alpha, out, y_part, p2_part,
      n_workers, d, k, rows_per_slice, n_slices);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_slices == 1) return static_cast<int>(err);
  const int64_t blocks = (d + kSplitWarps - 1) / kSplitWarps;
  receive_finalize_kernel<<<static_cast<unsigned>(blocks), kSplitThreads, 0,
                            stream>>>(y_part, p2_part, noise_re, inv_alpha,
                                      out, d, n_slices);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ota_demodulate_dyn(const float* y, const float* noise_re,
                                  const float* p2, const float* inv_alpha,
                                  float* out, int64_t n, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  if (inv_alpha == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  demodulate_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      y, noise_re, p2, inv_alpha, 0.0f, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ota_demodulate(const float* y, const float* noise_re,
                              const float* p2, float* out, int64_t n,
                              float inv_alpha, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  demodulate_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      y, noise_re, p2, nullptr, inv_alpha, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ota_accumulate(const float* y, const float* p2,
                              const float* s_re, const float* s_im,
                              const float* h_re, const float* h_im,
                              float* y_out, float* p2_out, int64_t n,
                              cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  accumulate_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      y, p2, s_re, s_im, h_re, h_im, y_out, p2_out, n);
  return static_cast<int>(cudaGetLastError());
}
