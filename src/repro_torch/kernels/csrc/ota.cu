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
//   * receive is one thread per column j.  The thread walks the W worker
//     rows, keeping the superposition y and the pilot p2 in registers, so the
//     (d,) sums never reach device memory.  Within one row neighbouring
//     threads read neighbouring columns, so the loads coalesce.
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
    out[i] = __fdiv_rn(__fadd_rn(y[i], __fmul_rn(noise_re[i], ia)),
                       fmaxf(p2[i], 1e-12f));
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
