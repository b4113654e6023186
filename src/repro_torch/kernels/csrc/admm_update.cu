// Fused ADMM state updates: the dual update (B4) and the flip rule (B5), for
// sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/admm_update.py:
//   * admm_dual_update (_dual_kernel)   r = θ − Θ
//       λ_re' = λ_re + ρ(h_re·r − z),  λ_im' = λ_im + ρ·h_im·r      (Eq. 11)
//   * admm_flip_lambda (_flip_kernel)   t = −(∂f + ρ|h|²(θ − Θ))
//       λ = h·t / max(|h|², 1e-12)                          (Sec. 2 flip rule)
//
// Both are bound by device-memory bytes: a handful of flops per f32 element.
// One thread per element of the (W, d) planes, in a grid-stride loop, reads
// each input byte once and writes each output byte once.  The global model Θ
// is read as its (d,) vector at i % d; the Pallas wrapper instead
// materialises the (W, d) broadcast, which costs two extra planes of bytes
// per call.  The downlink noise z is a (W, d) plane only under an analog
// downlink; otherwise the caller passes a null pointer and the kernel uses 0
// without reading anything.  Indices are 64-bit and loads scalar (rows of a
// (W, d) plane are only 4-byte aligned when d is odd).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void dual_update_kernel(const float* __restrict__ lam_re,
                                   const float* __restrict__ lam_im,
                                   const float* __restrict__ h_re,
                                   const float* __restrict__ h_im,
                                   const float* __restrict__ theta,
                                   const float* __restrict__ Theta,
                                   const float* __restrict__ noise_re,
                                   float* __restrict__ out_re,
                                   float* __restrict__ out_im,
                                   int64_t n, int64_t d, float rho) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float r = theta[i] - Theta[i % d];
    const float z = noise_re != nullptr ? noise_re[i] : 0.0f;
    out_re[i] = lam_re[i] + rho * (h_re[i] * r - z);
    out_im[i] = lam_im[i] + rho * h_im[i] * r;
  }
}

__global__ void flip_lambda_kernel(const float* __restrict__ grad,
                                   const float* __restrict__ theta,
                                   const float* __restrict__ Theta_prev,
                                   const float* __restrict__ h_re,
                                   const float* __restrict__ h_im,
                                   float* __restrict__ out_re,
                                   float* __restrict__ out_im,
                                   int64_t n, int64_t d, float rho) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float hr = h_re[i];
    const float hi = h_im[i];
    const float h2 = hr * hr + hi * hi;
    const float t = -(grad[i] + rho * h2 * (theta[i] - Theta_prev[i % d]));
    const float s = t / fmaxf(h2, 1e-12f);
    out_re[i] = hr * s;
    out_im[i] = hi * s;
  }
}

}  // namespace

extern "C" int admm_dual_update(const float* lam_re, const float* lam_im,
                                const float* h_re, const float* h_im,
                                const float* theta, const float* Theta,
                                const float* noise_re, float* out_re,
                                float* out_im, int64_t n, int64_t d, float rho,
                                cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  dual_update_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      lam_re, lam_im, h_re, h_im, theta, Theta, noise_re, out_re, out_im, n, d,
      rho);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int admm_flip_lambda(const float* grad, const float* theta,
                                const float* Theta_prev, const float* h_re,
                                const float* h_im, float* out_re,
                                float* out_im, int64_t n, int64_t d, float rho,
                                cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  flip_lambda_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      grad, theta, Theta_prev, h_re, h_im, out_re, out_im, n, d, rho);
  return static_cast<int>(cudaGetLastError());
}
