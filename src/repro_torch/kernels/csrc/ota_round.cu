// One-pass OTA round: B6 ota_round_stats and B7 ota_round_theta, for sm_90a.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/ota_round.py
// (_round_kernel, reached from ota_round_stats and ota_round_theta through
// _round_call).  One pass over the (W, d) worker planes:
//   [AR(1) step  h' = redraw ? ρ_f·h + scale·w : h, written for every row]
//   modulate     s = conj(tx)·θ + conj(λ)/ρ   (tx = h_tx if given, else h')
//   energy       E_w = Σ_d |s|²  of the UNMASKED signal, for every row
//   mask         a masked row adds nothing to the sums below (where, not ×)
//   superpose    y = Σ_w Re{h'_w ⊙ s_w},  p2 = Σ_w |h'_w|²
//   [B7 only]    Θ = (y + z·α⁻¹) / max(p2, 1e-12)
//
// Bound by device-memory bytes: every input plane is read once and every
// output written once, with a few flops per element.  The function has two
// reductions, over W for y/p2 and over d for the energy, and must do well
// both at (100, 109,386) and at (65,536, 32).  One thread per column (B2's
// design) gives 32 threads for the second shape, so the tiling is 2-D:
//   * a block is 8 warps and owns a tile of 32·k columns (k ≤ 4 chosen by
//     the host from d) and a slice of the worker rows.  A warp takes whole
//     rows (row r0 + warp, + 8, ...); its lanes take neighbouring columns,
//     so every load coalesces.
//   * the energy of a row over the tile is a warp-shuffle sum: no shared
//     memory, no barrier.  With one column tile it is the row's energy; with
//     several, a (W, n_tiles) partial that the finalize pass sums.
//   * y/p2 accumulate per column in registers over the warp's rows, then
//     across the 8 warps through shared memory.  With one worker slice that
//     is the result (and B7 applies its epilogue there); with several, a
//     (d, n_slices) partial that the finalize pass sums.
//   * the finalize pass is one warp per output element over its partials.
// Registers set the occupancy: at 59 a thread only 4 blocks fit an SM, and
// the 855 blocks of (100, 109,386) take 1.6 waves.  `__launch_bounds__`
// asks for 8 blocks an SM (at most 32 registers, a 16-byte spill): one wave,
// 98 µs against 130 µs there, 33 µs against 30 µs at (65,536, 32)
// (tools/sweep_ota_round.py on an H100 SXM).
// Sums run in a fixed order, so the result is bitwise the same run to run
// (no float atomics).  Loads are scalar: rows of 109,386 floats are only
// 4-byte aligned.  Indices are 64-bit.  α⁻¹ is read through a device
// pointer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxK = 4;
constexpr int kMinBlocksPerSm = 8;
constexpr int64_t kMaxSlices = 65535;  // gridDim.y

struct RoundArgs {
  const float* theta;
  const float* lam_re;
  const float* lam_im;
  const float* h_re;
  const float* h_im;
  const float* tx_re;    // null: modulate with the (stepped) channel
  const float* tx_im;
  const float* w_re;     // null: no channel step
  const float* w_im;
  const uint8_t* mask;   // null: every row active
  const float* noise;    // B7: (d,) matched-filter noise
  const float* inv_alpha;  // B7: one float on the device
  float* y;              // (d,) or, with several slices, (d, n_slices)
  float* p2;
  float* energy;         // (W,) or (W, n_tiles); null for B7
  float* theta_out;      // B7: (d,); null for B6
  float* h_new_re;       // with the channel step
  float* h_new_im;
  int64_t n_workers;
  int64_t d;
  int64_t rows_per_slice;
  int64_t n_slices;
  int64_t n_tiles;
  int k;
  float inv_rho;
  float rho_f;
  float scale;
  int redraw;
};

__device__ __forceinline__ float demod(float y, float z, float ia, float p2) {
  // the plain version's order, rounded at each step as it is
  return __fdiv_rn(__fadd_rn(y, __fmul_rn(z, ia)), fmaxf(p2, 1e-12f));
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
round_kernel(const RoundArgs a) {
  __shared__ float sy[kWarps][kMaxK * 32];
  __shared__ float sp[kWarps][kMaxK * 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  const int64_t slice = blockIdx.y;
  const int64_t c0 = tile * (32 * static_cast<int64_t>(a.k));
  const int64_t r0 = slice * a.rows_per_slice;
  const int64_t r1 = r0 + a.rows_per_slice < a.n_workers
                         ? r0 + a.rows_per_slice : a.n_workers;
  float y[kMaxK];
  float p2[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    y[j] = 0.0f;
    p2[j] = 0.0f;
  }
  for (int64_t r = r0 + warp; r < r1; r += kWarps) {
    // depends on the row only: every lane of the warp branches alike
    const bool active = a.mask == nullptr || a.mask[r] != 0;
    float e = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      const int64_t c = c0 + lane + 32 * j;
      if (j >= a.k || c >= a.d) continue;
      const int64_t i = r * a.d + c;
      float hr = a.h_re[i];
      float hi = a.h_im[i];
      if (a.w_re != nullptr) {
        if (a.redraw) {
          hr = a.rho_f * hr + a.scale * a.w_re[i];
          hi = a.rho_f * hi + a.scale * a.w_im[i];
        }
        a.h_new_re[i] = hr;
        a.h_new_im[i] = hi;
      }
      const float txr = a.tx_re != nullptr ? a.tx_re[i] : hr;
      const float txi = a.tx_im != nullptr ? a.tx_im[i] : hi;
      const float t = a.theta[i];
      const float sr = txr * t + a.lam_re[i] * a.inv_rho;
      const float si = -txi * t - a.lam_im[i] * a.inv_rho;
      e += sr * sr + si * si;
      if (active) {
        y[j] += hr * sr - hi * si;
        p2[j] += hr * hr + hi * hi;
      }
    }
    if (a.energy != nullptr) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        e += __shfl_down_sync(0xffffffffu, e, off);
      }
      if (lane == 0) {
        a.energy[a.n_tiles > 1 ? r * a.n_tiles + tile : r] = e;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    sy[warp][lane + 32 * j] = y[j];
    sp[warp][lane + 32 * j] = p2[j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 32 * a.k; t += kThreads) {
    const int64_t c = c0 + t;
    if (c >= a.d) continue;
    float ys = 0.0f;
    float ps = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ys += sy[w][t];
      ps += sp[w][t];
    }
    if (a.n_slices > 1) {
      a.y[c * a.n_slices + slice] = ys;
      a.p2[c * a.n_slices + slice] = ps;
    } else if (a.theta_out != nullptr) {
      a.theta_out[c] = demod(ys, a.noise[c], *a.inv_alpha, ps);
    } else {
      a.y[c] = ys;
      a.p2[c] = ps;
    }
  }
}

// One warp per output: a column's y/p2 over its n_slices partials (first d
// warps, when there are several slices), then a row's energy over its
// n_tiles partials (when there are several tiles).
__global__ void round_finalize_kernel(const RoundArgs a, float* y_out,
                                      float* p2_out, float* energy_out) {
  const int64_t gw = (static_cast<int64_t>(blockIdx.x) * blockDim.x
                      + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t n_col = a.n_slices > 1 ? a.d : 0;
  const int64_t n_row = (a.energy != nullptr && a.n_tiles > 1)
                            ? a.n_workers : 0;
  if (gw < n_col) {
    const int64_t c = gw;
    float ys = 0.0f;
    float ps = 0.0f;
    for (int64_t s = lane; s < a.n_slices; s += 32) {
      ys += a.y[c * a.n_slices + s];
      ps += a.p2[c * a.n_slices + s];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ys += __shfl_down_sync(0xffffffffu, ys, off);
      ps += __shfl_down_sync(0xffffffffu, ps, off);
    }
    if (lane == 0) {
      if (a.theta_out != nullptr) {
        a.theta_out[c] = demod(ys, a.noise[c], *a.inv_alpha, ps);
      } else {
        y_out[c] = ys;
        p2_out[c] = ps;
      }
    }
  } else if (gw < n_col + n_row) {
    const int64_t r = gw - n_col;
    float es = 0.0f;
    for (int64_t t = lane; t < a.n_tiles; t += 32) {
      es += a.energy[r * a.n_tiles + t];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      es += __shfl_down_sync(0xffffffffu, es, off);
    }
    if (lane == 0) energy_out[r] = es;
  }
}

// Launch the pass and, where partials need summing, the finalize pass.
// `y_out`/`p2_out`/`energy_out` are the (d,)/(W,) results; a.y/a.p2/a.energy
// point at the partial buffers where there are several slices/tiles, else at
// the results themselves.
int launch_round(RoundArgs a, float* y_out, float* p2_out, float* energy_out,
                 cudaStream_t stream) {
  if (a.n_workers <= 0 || a.d <= 0) return static_cast<int>(cudaSuccess);
  if (a.k < 1 || a.k > kMaxK || a.rows_per_slice < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.n_tiles = (a.d + 32 * a.k - 1) / (32 * a.k);
  a.n_slices = (a.n_workers + a.rows_per_slice - 1) / a.rows_per_slice;
  if (a.n_slices > kMaxSlices || a.n_tiles > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(a.n_tiles),
                  static_cast<unsigned>(a.n_slices));
  round_kernel<<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_col = a.n_slices > 1 ? a.d : 0;
  const int64_t n_row = (a.energy != nullptr && a.n_tiles > 1)
                            ? a.n_workers : 0;
  if (n_col + n_row > 0) {
    const int64_t blocks = (n_col + n_row + kWarps - 1) / kWarps;
    round_finalize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            stream>>>(a, y_out, p2_out, energy_out);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// B6.  y_part/p2_part: (d, n_slices) scratch, used when n_slices > 1;
// e_part: (W, n_tiles) scratch, used when n_tiles > 1 (else may be null).
extern "C" int ota_round_stats(
    const float* theta, const float* lam_re, const float* lam_im,
    const float* h_re, const float* h_im, const float* tx_re,
    const float* tx_im, const float* w_re, const float* w_im,
    const uint8_t* mask, float* y_part, float* p2_part, float* e_part,
    float* y, float* p2, float* energy, float* h_new_re, float* h_new_im,
    int64_t n_workers, int64_t d, int k, int64_t rows_per_slice,
    float inv_rho, float rho_f, float scale, int redraw,
    cudaStream_t stream) {
  RoundArgs a{};
  a.theta = theta; a.lam_re = lam_re; a.lam_im = lam_im;
  a.h_re = h_re; a.h_im = h_im; a.tx_re = tx_re; a.tx_im = tx_im;
  a.w_re = w_re; a.w_im = w_im; a.mask = mask;
  a.h_new_re = h_new_re; a.h_new_im = h_new_im;
  a.n_workers = n_workers; a.d = d; a.k = k;
  a.rows_per_slice = rows_per_slice; a.inv_rho = inv_rho; a.rho_f = rho_f;
  a.scale = scale; a.redraw = redraw;
  const int64_t n_tiles = k > 0 ? (d + 32 * k - 1) / (32 * k) : 0;
  const int64_t n_slices =
      rows_per_slice > 0 ? (n_workers + rows_per_slice - 1) / rows_per_slice
                         : 0;
  a.y = n_slices > 1 ? y_part : y;
  a.p2 = n_slices > 1 ? p2_part : p2;
  a.energy = n_tiles > 1 ? e_part : energy;
  if ((n_slices > 1 && (y_part == nullptr || p2_part == nullptr))
      || (n_tiles > 1 && e_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_round(a, y, p2, energy, stream);
}

// B7.  y_part/p2_part: (d, n_slices) scratch, used when n_slices > 1.
extern "C" int ota_round_theta(
    const float* theta, const float* lam_re, const float* lam_im,
    const float* h_re, const float* h_im, const float* tx_re,
    const float* tx_im, const float* w_re, const float* w_im,
    const uint8_t* mask, const float* noise, const float* inv_alpha,
    float* y_part, float* p2_part, float* theta_out, float* h_new_re,
    float* h_new_im, int64_t n_workers, int64_t d, int k,
    int64_t rows_per_slice, float inv_rho, float rho_f, float scale,
    int redraw, cudaStream_t stream) {
  RoundArgs a{};
  a.theta = theta; a.lam_re = lam_re; a.lam_im = lam_im;
  a.h_re = h_re; a.h_im = h_im; a.tx_re = tx_re; a.tx_im = tx_im;
  a.w_re = w_re; a.w_im = w_im; a.mask = mask;
  a.noise = noise; a.inv_alpha = inv_alpha; a.theta_out = theta_out;
  a.h_new_re = h_new_re; a.h_new_im = h_new_im;
  a.n_workers = n_workers; a.d = d; a.k = k;
  a.rows_per_slice = rows_per_slice; a.inv_rho = inv_rho; a.rho_f = rho_f;
  a.scale = scale; a.redraw = redraw;
  const int64_t n_slices =
      rows_per_slice > 0 ? (n_workers + rows_per_slice - 1) / rows_per_slice
                         : 0;
  if (n_slices > 1 && (y_part == nullptr || p2_part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.y = y_part;
  a.p2 = p2_part;
  a.energy = nullptr;
  return launch_round(a, nullptr, nullptr, nullptr, stream);
}
