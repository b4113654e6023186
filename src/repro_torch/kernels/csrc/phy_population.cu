// Population-scale phy step (B10), for sm_90a: AR(1) small-scale fading,
// random-waypoint mobility, on-arrival shadowing redraw and log-distance path
// gain for an N-worker population, in one pass over flat (N,) planes.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/phy_population.py
// (population_step, _population_step_kernel).  Per worker i:
//   h'    = redraw ? ρ·h + s·w : h                      (re and im)
//   δ     = dest − pos,  dist = |δ|,  arrived = dist ≤ step
//   pos'  = arrived ? dest : pos + step·δ/max(dist, 1e-9)
//   dest' = arrived ? fresh : dest
//   sh'   = (shadow_redraw && arrived) ? shadow_fresh : shadow
//   gain  = exp(pexp·log(norm_d / max(|pos'|, ref_d)))·sh'
// Every random input (innovations w, fresh waypoints, fresh shadowing) is
// drawn by the caller, so the kernel is elementwise.
//
// Bound by device-memory bytes: 12 planes in and 8 out, about 30 flops and
// two transcendentals per worker.  One thread per worker in a grid-stride
// loop reads each input once and writes each output once; x and y arrive as
// separate contiguous planes, so neighbouring threads touch neighbouring
// addresses in every plane.  Indices are 64-bit.  The path gain uses
// expf/logf as the TPU kernel does (the JAX chain's pow differs from it in
// the last bits).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

struct Params {
  float rho, scale, step, ref_d, norm_d, pexp;
  int redraw, shadow_redraw;
};

__global__ void population_step_kernel(
    const float* __restrict__ h_re, const float* __restrict__ h_im,
    const float* __restrict__ w_re, const float* __restrict__ w_im,
    const float* __restrict__ pos_x, const float* __restrict__ pos_y,
    const float* __restrict__ dest_x, const float* __restrict__ dest_y,
    const float* __restrict__ fresh_x, const float* __restrict__ fresh_y,
    const float* __restrict__ shadow, const float* __restrict__ shadow_fresh,
    float* __restrict__ o_h_re, float* __restrict__ o_h_im,
    float* __restrict__ o_pos_x, float* __restrict__ o_pos_y,
    float* __restrict__ o_dest_x, float* __restrict__ o_dest_y,
    float* __restrict__ o_shadow, float* __restrict__ o_gain, int64_t n,
    Params p) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    if (p.redraw) {
      o_h_re[i] = p.rho * h_re[i] + p.scale * w_re[i];
      o_h_im[i] = p.rho * h_im[i] + p.scale * w_im[i];
    } else {
      o_h_re[i] = h_re[i];
      o_h_im[i] = h_im[i];
    }

    const float px = pos_x[i];
    const float py = pos_y[i];
    const float dx = dest_x[i];
    const float dy = dest_y[i];
    const float ddx = dx - px;
    const float ddy = dy - py;
    const float dist = sqrtf(ddx * ddx + ddy * ddy);
    const bool arrived = dist <= p.step;
    const float denom = fmaxf(dist, 1e-9f);
    const float nx = arrived ? dx : px + p.step * (ddx / denom);
    const float ny = arrived ? dy : py + p.step * (ddy / denom);
    o_pos_x[i] = nx;
    o_pos_y[i] = ny;
    o_dest_x[i] = arrived ? fresh_x[i] : dx;
    o_dest_y[i] = arrived ? fresh_y[i] : dy;

    const float sh = (p.shadow_redraw && arrived) ? shadow_fresh[i] : shadow[i];
    o_shadow[i] = sh;
    const float r = fmaxf(sqrtf(nx * nx + ny * ny), p.ref_d);
    o_gain[i] = expf(p.pexp * logf(p.norm_d / r)) * sh;
  }
}

}  // namespace

extern "C" int population_step(
    const float* h_re, const float* h_im, const float* w_re,
    const float* w_im, const float* pos_x, const float* pos_y,
    const float* dest_x, const float* dest_y, const float* fresh_x,
    const float* fresh_y, const float* shadow, const float* shadow_fresh,
    float* o_h_re, float* o_h_im, float* o_pos_x, float* o_pos_y,
    float* o_dest_x, float* o_dest_y, float* o_shadow, float* o_gain,
    int64_t n, float rho, float scale, int redraw, float step, float ref_d,
    float norm_d, float pexp, int shadow_redraw, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const Params p{rho, scale, step, ref_d, norm_d, pexp, redraw, shadow_redraw};
  population_step_kernel<<<grid_for(n), kThreads, 0, stream>>>(
      h_re, h_im, w_re, w_im, pos_x, pos_y, dest_x, dest_y, fresh_x, fresh_y,
      shadow, shadow_fresh, o_h_re, o_h_im, o_pos_x, o_pos_y, o_dest_x,
      o_dest_y, o_shadow, o_gain, n, p);
  return static_cast<int>(cudaGetLastError());
}
