// Wireless-scenario channel kernels: the AR(1) fading step (B9) and the
// participation-masked receive (B8), for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/phy_channel.py:
//   * fading_step        (_fading_step_kernel)
//       h' = redraw ? ρ·h + s·w : h            on the re and im planes
//   * ota_receive_masked (_receive_masked_kernel)
//       Θ = (Σ_{w active} Re{h_w ⊙ s_w} + z·α⁻¹) / max(Σ_{w active} |h_w|², 1e-12)
//
// Both are bound by device-memory bytes: a few flops per f32 element.
//   * fading_step is one thread per element in a grid-stride loop (the
//     modulate design of ota.cu).  `redraw` is a runtime int, so the gate can
//     be held against the plain version both ways.
//   * ota_receive_masked is the one-thread-per-column design of ota.cu's
//     receive.  The (W,) mask is staged in shared memory a tile of rows at a
//     time, and a masked row is skipped: its planes are never loaded, so a
//     dropped worker's NaN or Inf cannot reach the sums (the TPU kernel zeroes
//     them with `where`; skipping is the same contract and saves the row's
//     bytes).  The branch depends on the row only, so every thread of a warp
//     takes it the same way.  The column loop is block-uniform (j0 steps by
//     the grid), so the barriers around the staging are reached by every
//     thread of the block.
// Loads are scalar and indices 64-bit, as in ota.cu.  α⁻¹ is read through a
// device pointer: α⁻¹ = 0 (every active worker energy-free, or none active)
// adds exactly 0 for a finite z.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kMaskTile = 4096;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void fading_step_kernel(const float* __restrict__ h_re,
                                   const float* __restrict__ h_im,
                                   const float* __restrict__ w_re,
                                   const float* __restrict__ w_im,
                                   float* __restrict__ o_re,
                                   float* __restrict__ o_im, int64_t n,
                                   float rho, float scale, int redraw) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (redraw) {
      o_re[i] = rho * h_re[i] + scale * w_re[i];
      o_im[i] = rho * h_im[i] + scale * w_im[i];
    } else {
      o_re[i] = h_re[i];
      o_im[i] = h_im[i];
    }
  }
}

__global__ void receive_masked_kernel(const float* __restrict__ s_re,
                                      const float* __restrict__ s_im,
                                      const float* __restrict__ h_re,
                                      const float* __restrict__ h_im,
                                      const uint8_t* __restrict__ mask,
                                      const float* __restrict__ noise_re,
                                      const float* __restrict__ inv_alpha,
                                      float* __restrict__ out,
                                      int64_t n_workers, int64_t d) {
  __shared__ uint8_t active[kMaskTile];
  const float ia = *inv_alpha;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * blockDim.x; j0 < d;
       j0 += stride) {
    const int64_t j = j0 + threadIdx.x;
    const bool live = j < d;
    float y = 0.0f;
    float p2 = 0.0f;
    for (int64_t w0 = 0; w0 < n_workers; w0 += kMaskTile) {
      const int64_t rows =
          n_workers - w0 < kMaskTile ? n_workers - w0 : kMaskTile;
      __syncthreads();  // the previous tile is no longer read
      for (int64_t t = threadIdx.x; t < rows; t += blockDim.x) {
        active[t] = mask[w0 + t];
      }
      __syncthreads();
      if (live) {
        for (int64_t t = 0; t < rows; ++t) {
          if (!active[t]) continue;
          const int64_t k = (w0 + t) * d + j;
          const float hr = h_re[k];
          const float hi = h_im[k];
          y += hr * s_re[k] - hi * s_im[k];
          p2 += hr * hr + hi * hi;
        }
      }
    }
    if (live) out[j] = (y + noise_re[j] * ia) / fmaxf(p2, 1e-12f);
  }
}

}  // namespace

extern "C" int fading_step(const float* h_re, const float* h_im,
                           const float* w_re, const float* w_im, float* o_re,
                           float* o_im, int64_t n, float rho, float scale,
                           int redraw, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  fading_step_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      h_re, h_im, w_re, w_im, o_re, o_im, n, rho, scale, redraw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ota_receive_masked(const float* s_re, const float* s_im,
                                  const float* h_re, const float* h_im,
                                  const uint8_t* mask, const float* noise_re,
                                  const float* inv_alpha, float* out,
                                  int64_t n_workers, int64_t d,
                                  cudaStream_t stream) {
  if (d <= 0) return static_cast<int>(cudaSuccess);
  receive_masked_kernel<<<grid_for(d), kThreads, 0, stream>>>(
      s_re, s_im, h_re, h_im, mask, noise_re, inv_alpha, out, n_workers, d);
  return static_cast<int>(cudaGetLastError());
}
