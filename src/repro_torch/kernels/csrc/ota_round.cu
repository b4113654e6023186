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
// at (100, 109,386), at (65,536, 32) and at two workers over 10⁸–10⁹
// columns (the LLM rounds).  Two plans, each its own kernel; the host picks
// one from the shape (kernels/ota_round.py, tiling()).
//
// The row plan (many workers).  One thread per column (B2's design) gives
// 32 threads for (65,536, 32), so the tiling is 2-D:
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
// (tools/sweep_ota_round.py on an H100 SXM).  Loads are scalar: rows of
// 109,386 floats are only 4-byte aligned.
//
// The column plan (few workers: W below the host's threshold, at most
// kColMaxWorkers).  Warps that take whole rows leave 6 of 8 idle at W = 2,
// and a 128-column tile makes 5·10⁶ blocks and as many energy partials at
// the LLM D.  Here every thread owns columns and walks all W rows itself:
//   * y and p2 stay in its registers and go straight out (B7: Θ at once):
//     no shared memory, no barrier, no (d, n_slices) partial.
//   * 16-byte loads (float4) where d % 4 == 0 and every plane is 16-byte
//     aligned (the host checks; both LLM D's qualify), else the same kernel
//     body with scalar loads.  Each thread has W rows × 5–9 planes of
//     16 bytes in flight an iteration.
//   * the grid is a fixed number of blocks per SM, striding over the column
//     groups, so a row's energy accumulates in a register over the whole
//     stride.  Each block then sums its W energies in a fixed order (warp
//     shuffle, then the 8 warps through shared memory) into a (W, n_blocks)
//     partial of ~10³ columns, which a second kernel sums with one block
//     per row in a fixed tree: microseconds, not a warp walking 5·10⁶
//     partials.
//   * its own `__launch_bounds__`, not the row plan's 32-register cap: 3
//     blocks an SM (at most 85 registers; 80 at 16-byte loads), and a grid
//     of 3 blocks an SM, one wave.  At (2, 637,554,688) that is 10.29 ms
//     against a 9.14 ms bound; a cap of 128 (89 used, 2 blocks an SM) or
//     64 (a 40-byte spill), or 1–8 blocks an SM, is no faster
//     (tools/sweep_ota_round.py on an H100 SXM).
//   * every product and sum is rounded as the plain version rounds it
//     (kernels/ref.py: no contracted multiply-add, the rows summed in
//     order), so y, p2, Θ and h' are the plain version's bits wherever its
//     sum over W runs in row order, as it does at W = 2.
//
// Sums run in a fixed order in both plans, so the result is bitwise the
// same run to run (no float atomics).  Indices are 64-bit.  α⁻¹ is read
// through a device pointer.
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

// ---- the column plan ----

constexpr int kColThreads = 256;
constexpr int kColWarps = kColThreads / 32;
constexpr int kColMaxWorkers = 16;
constexpr int kColMinBlocksPerSm = 3;  // at most 85 registers a thread

// V consecutive floats at p: one 16-byte load for V = 4 (p 16-byte aligned)
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// Thread g owns columns [V·g, V·g + V), then g + gridDim·blockDim, ...; it
// walks all W rows for each.  a.energy is the (W, n_tiles) partial, one
// column per block (n_tiles == gridDim.x), or the (W,) result for one block.
template <int V>
__global__ void __launch_bounds__(kColThreads, kColMinBlocksPerSm)
round_cols_kernel(const RoundArgs a) {
  __shared__ float se[kColWarps][kColMaxWorkers];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_rows = static_cast<int>(a.n_workers);
  const float ia = a.theta_out != nullptr ? *a.inv_alpha : 0.0f;
  float e[kColMaxWorkers];
#pragma unroll
  for (int r = 0; r < kColMaxWorkers; ++r) e[r] = 0.0f;
  const int64_t n_groups = a.d / V;  // V = 4 only where d % 4 == 0
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kColThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kColThreads
                   + threadIdx.x;
       g < n_groups; g += stride) {
    const int64_t c = g * V;
    float y[V];
    float p2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      y[j] = 0.0f;
      p2[j] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kColMaxWorkers; ++r) {
      if (r >= n_rows) break;
      const int64_t i = r * a.d + c;
      float hr[V], hi[V], t[V], lr[V], li[V], txr[V], txi[V];
      load_v<V>(a.h_re + i, hr);
      load_v<V>(a.h_im + i, hi);
      load_v<V>(a.theta + i, t);
      load_v<V>(a.lam_re + i, lr);
      load_v<V>(a.lam_im + i, li);
      if (a.w_re != nullptr) {
        if (a.redraw) {
          float wr[V], wi[V];
          load_v<V>(a.w_re + i, wr);
          load_v<V>(a.w_im + i, wi);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            hr[j] = __fadd_rn(__fmul_rn(a.rho_f, hr[j]),
                              __fmul_rn(a.scale, wr[j]));
            hi[j] = __fadd_rn(__fmul_rn(a.rho_f, hi[j]),
                              __fmul_rn(a.scale, wi[j]));
          }
        }
        store_v<V>(a.h_new_re + i, hr);
        store_v<V>(a.h_new_im + i, hi);
      }
      if (a.tx_re != nullptr) {
        load_v<V>(a.tx_re + i, txr);
        load_v<V>(a.tx_im + i, txi);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          txr[j] = hr[j];
          txi[j] = hi[j];
        }
      }
      // depends on the row only: every thread branches alike
      const bool active = a.mask == nullptr || a.mask[r] != 0;
      float er = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float sr = __fadd_rn(__fmul_rn(txr[j], t[j]),
                                   __fmul_rn(lr[j], a.inv_rho));
        const float si = __fsub_rn(__fmul_rn(-txi[j], t[j]),
                                   __fmul_rn(li[j], a.inv_rho));
        er = __fadd_rn(er, __fadd_rn(__fmul_rn(sr, sr), __fmul_rn(si, si)));
        if (active) {
          y[j] = __fadd_rn(y[j], __fsub_rn(__fmul_rn(hr[j], sr),
                                           __fmul_rn(hi[j], si)));
          p2[j] = __fadd_rn(p2[j], __fadd_rn(__fmul_rn(hr[j], hr[j]),
                                             __fmul_rn(hi[j], hi[j])));
        }
      }
      e[r] += er;
    }
    if (a.theta_out != nullptr) {
      float z[V];
      float th[V];
      load_v<V>(a.noise + c, z);
#pragma unroll
      for (int j = 0; j < V; ++j) th[j] = demod(y[j], z[j], ia, p2[j]);
      store_v<V>(a.theta_out + c, th);
    } else {
      store_v<V>(a.y + c, y);
      store_v<V>(a.p2 + c, p2);
    }
  }
  if (a.energy == nullptr) return;  // B7: the same for every thread
#pragma unroll
  for (int r = 0; r < kColMaxWorkers; ++r) {
    if (r >= n_rows) break;
    float v = e[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) se[warp][r] = v;
  }
  __syncthreads();
  if (threadIdx.x < n_rows) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += se[w][threadIdx.x];
    a.energy[a.n_tiles > 1 ? threadIdx.x * a.n_tiles + blockIdx.x
                           : threadIdx.x] = s;
  }
}

// One block per row: the row's energy over its n_parts block partials,
// each thread a strided run of them, then a warp-shuffle tree and the 8
// warps in order.
__global__ void __launch_bounds__(kColThreads)
round_energy_kernel(const float* __restrict__ part,
                    float* __restrict__ energy, int64_t n_parts) {
  __shared__ float sw[kColWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* row = part + static_cast<int64_t>(blockIdx.x) * n_parts;
  float v = 0.0f;
  for (int64_t t = threadIdx.x; t < n_parts; t += kColThreads) v += row[t];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  if (lane == 0) sw[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kColWarps; ++w) s += sw[w];
    energy[blockIdx.x] = s;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Launch the column plan on n_blocks blocks and, with an energy of several
// blocks, its finalize.  a.n_tiles is n_blocks; a.energy the partial when
// n_blocks > 1, else the result.
int launch_cols(RoundArgs a, int vec, float* energy_out,
                cudaStream_t stream) {
  if (a.n_workers <= 0 || a.d <= 0) return static_cast<int>(cudaSuccess);
  if (a.n_workers > kColMaxWorkers || a.n_tiles < 1
      || a.n_tiles > INT32_MAX || (vec != 1 && vec != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec == 4) {
    const void* planes[] = {a.theta, a.lam_re, a.lam_im, a.h_re, a.h_im,
                            a.tx_re, a.tx_im, a.w_re, a.w_im, a.noise,
                            a.y, a.p2, a.theta_out, a.h_new_re, a.h_new_im};
    bool ok = a.d % 4 == 0;
    for (const void* p : planes) ok = ok && aligned16(p);  // null is aligned
    if (!ok) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const unsigned blocks = static_cast<unsigned>(a.n_tiles);
  if (vec == 4) {
    round_cols_kernel<4><<<blocks, kColThreads, 0, stream>>>(a);
  } else {
    round_cols_kernel<1><<<blocks, kColThreads, 0, stream>>>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.energy != nullptr && a.n_tiles > 1) {
    round_energy_kernel<<<static_cast<unsigned>(a.n_workers), kColThreads,
                          0, stream>>>(a.energy, energy_out, a.n_tiles);
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

// B6 on the column plan.  e_part: (W, n_blocks) scratch, used when
// n_blocks > 1 (else may be null).  vec: 4 (16-byte loads) or 1.
extern "C" int ota_round_stats_cols(
    const float* theta, const float* lam_re, const float* lam_im,
    const float* h_re, const float* h_im, const float* tx_re,
    const float* tx_im, const float* w_re, const float* w_im,
    const uint8_t* mask, float* e_part, float* y, float* p2, float* energy,
    float* h_new_re, float* h_new_im, int64_t n_workers, int64_t d, int vec,
    int64_t n_blocks, float inv_rho, float rho_f, float scale, int redraw,
    cudaStream_t stream) {
  RoundArgs a{};
  a.theta = theta; a.lam_re = lam_re; a.lam_im = lam_im;
  a.h_re = h_re; a.h_im = h_im; a.tx_re = tx_re; a.tx_im = tx_im;
  a.w_re = w_re; a.w_im = w_im; a.mask = mask;
  a.h_new_re = h_new_re; a.h_new_im = h_new_im;
  a.y = y; a.p2 = p2;
  a.n_workers = n_workers; a.d = d; a.n_tiles = n_blocks; a.n_slices = 1;
  a.inv_rho = inv_rho; a.rho_f = rho_f; a.scale = scale; a.redraw = redraw;
  if (n_blocks > 1 && e_part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.energy = n_blocks > 1 ? e_part : energy;
  return launch_cols(a, vec, energy, stream);
}

// B7 on the column plan: Θ straight from each thread's registers.
extern "C" int ota_round_theta_cols(
    const float* theta, const float* lam_re, const float* lam_im,
    const float* h_re, const float* h_im, const float* tx_re,
    const float* tx_im, const float* w_re, const float* w_im,
    const uint8_t* mask, const float* noise, const float* inv_alpha,
    float* theta_out, float* h_new_re, float* h_new_im, int64_t n_workers,
    int64_t d, int vec, int64_t n_blocks, float inv_rho, float rho_f,
    float scale, int redraw, cudaStream_t stream) {
  RoundArgs a{};
  a.theta = theta; a.lam_re = lam_re; a.lam_im = lam_im;
  a.h_re = h_re; a.h_im = h_im; a.tx_re = tx_re; a.tx_im = tx_im;
  a.w_re = w_re; a.w_im = w_im; a.mask = mask;
  a.noise = noise; a.inv_alpha = inv_alpha; a.theta_out = theta_out;
  a.h_new_re = h_new_re; a.h_new_im = h_new_im;
  a.n_workers = n_workers; a.d = d; a.n_tiles = n_blocks; a.n_slices = 1;
  a.inv_rho = inv_rho; a.rho_f = rho_f; a.scale = scale; a.redraw = redraw;
  a.energy = nullptr;
  return launch_cols(a, vec, nullptr, stream);
}
