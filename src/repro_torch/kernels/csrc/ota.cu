// Over-the-air signal path: modulate (B1) and fused receive (B2), for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/ota.py:
//   * ota_modulate  (_mod_kernel)      s = conj(h)·θ + conj(λ)/ρ
//   * ota_receive   (_receive_kernel)  Θ = (Σ_w Re{h_w ⊙ s_w} + z·α⁻¹) / max(Σ_w |h_w|², 1e-12)
//
// Both are bound by device-memory bytes: a few flops per f32 element read
// once.  The design therefore reads every input byte once and writes every
// output byte once, and keeps intermediates in registers:
//   * modulate is one thread per element in a grid-stride loop; neighbouring
//     threads touch neighbouring addresses, so every load and store coalesces.
//   * receive is one thread per column j.  The thread walks the W worker
//     rows, keeping the superposition y and the pilot p2 in registers, so the
//     (d,) sums never reach device memory.  Within one row neighbouring
//     threads read neighbouring columns, so the loads coalesce.
// Loads are scalar: rows of a (W, d) plane start only 4-byte aligned when d
// is odd (the paper MLP has d = 109,386), so float4 loads across rows would
// be misaligned.  Indices are 64-bit: packed buffers exceed 2^31 elements.
// α⁻¹ is read through a device pointer, so the host never synchronises on it.
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
    s_re[i] = h_re[i] * t + lam_re[i] * inv_rho;
    s_im[i] = -h_im[i] * t - lam_im[i] * inv_rho;
  }
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
      y += hr * s_re[k] - hi * s_im[k];
      p2 += hr * hr + hi * hi;
    }
    // ia == 0 (all workers energy-free) adds exactly 0 for a finite z
    out[j] = (y + noise_re[j] * ia) / fmaxf(p2, 1e-12f);
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
