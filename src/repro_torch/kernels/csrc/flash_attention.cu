// Flash attention (B11): the causal online-softmax forward and its two
// backward kernels, for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   * flash_attention_fwd  <- _flash_forward (_fwd_kernel, :67)
//       o = softmax(q·kᵀ·scale) · v, and the f32 residual lse = m + log(l)
//   * flash_attention_dq   <- _flash_backward's first call (_dq_kernel,
//     :169)
//       dq = Σ_k p∘(do·vᵀ − δ) · k · scale,  p = exp(q·kᵀ·scale − lse)
//   * flash_attention_dkv  <- _flash_backward's second call (_dkv_kernel,
//     :208)
//       dv = pᵀ·do,  dk = dsᵀ·q · scale,  ds = p∘(do·vᵀ − δ)
// with q (BH, S, hd), k/v (BH, T, hd) in bf16 or f32, lse and δ (BH, S) f32,
// and every output in the input dtype (lse in f32).  Each C entry point
// picks its route from the dtype: bf16 runs the tensor-core kernels, f32
// the SIMT kernels.
//
// What it keeps out of device memory, as the TPU kernel does: no (S, T)
// tensor exists in any of the three.  The forward writes o and lse only;
// both backward kernels recompute p from lse.  δ = Σ_d do∘o comes from the
// caller (one f32 (BH, S) plane).
//
// What bounds it.  At the trainer's shape (BH = 2·32, S = T = 4096, hd = 128,
// causal) the forward does 2·64·4096²·128 = 275 GFLOP on 0.3 GB of
// operands: 278 µs at the card's 989 TFLOP/s bf16 tensor-core rate against
// ~80 µs to move its device-memory bytes, so it is bound by operations, not
// bytes; dq does 1.5× the forward's work (417 µs) and dk/dv 2× (556 µs).
//
// bf16: the tensor cores (`tc` below).  Each block is three warpgroups:
// one producer thread keeps TMA loads in flight through a two-stage ring
// guarded by mbarriers (full: the bytes landed; empty: both consumers are
// done with the stage), and two consumer warpgroups own 64 rows each and
// run wgmma with f32 accumulators (setmaxnreg moves registers from the
// producer to them: 24 against 240).  Tiles arrive swizzled (32, 64 or
// 128 bytes, following hd; two 64-wide boxes a row at hd = 128), as
// wgmma's shared-memory descriptors read them (hopper.cuh).
//   * forward: 128 query rows a block, Q resident, K and V streamed in
//     tiles of 128 keys.  S = Q·Kᵀ reads both from shared memory; the
//     online softmax runs on the accumulator registers; O += P·V takes P
//     straight from those registers as its A operand (a bf16 hi + lo pair,
//     below) and V from shared memory in its MN-major (transposed) form.
//   * dq: 128 query rows, Q and dO resident, K and V in tiles of 64 keys:
//     S = Q·Kᵀ and dP = dO·Vᵀ from shared memory, dS = P∘(dP − δ) in
//     registers, dQ += dS·K with dS as the register operand.
//   * dk/dv: 128 keys a block (64 a consumer), K and V resident, Q, dO,
//     lse and δ streamed in tiles of 64 query rows.  The transposed tiles
//     Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ put pᵀ and dsᵀ in the A-operand registers,
//     so dV += Pᵀ·dO and dK += dSᵀ·Q take only their B operand from shared
//     memory.
// The TPU kernel keeps p and ds in f32 for its second products; a wgmma
// operand is bf16, which rounds each term by up to 2⁻⁸ of itself, and one
// rounding put o, dq, dk and dv 0.6–1.9× over their tolerance (rtol 1e-2,
// atol 1e-3 of the largest value) on the ragged test shapes.  So P and dS
// enter as a hi + lo pair, hi = bf16(x) and lo = bf16(x − hi), two wgmmas
// into one accumulator (~2⁻¹⁶ per term): the forward does 3 products of a
// tile where 2 would do, dq 4 of 3, dk/dv 6 of 4.  Every sum is f32.
//
// f32: the SIMT cores (at most 67 TFLOP/s), in f32 throughout.  The tensor
// cores would take f32 operands only as TF32, which rounds each to 10
// mantissa bits (up to ~5e-4 relative): over the 1e-4 the f32 route is held
// to (the reduced models, the f32 witness model, the card tests), so f32
// stays here.  Tiles of 64 query rows × 64 keys staged in shared memory as
// f32 (rows padded to hd + 4 floats so 16-byte loads of neighbouring rows
// fall in distinct banks), 256 threads, each thread a 4 × 4 register
// micro-tile of the score tile read with 16-byte loads along hd.
//
// Both routes: causal tiles strictly above the diagonal are never visited
// (the TPU kernel's pl.when); the forward and dq grids start with the
// heaviest query tiles (the last ones) and dk/dv with the heaviest key
// tiles (the first), so the causal tail is short; masks are by absolute
// index with the cols < T and rows < S bounds, so ragged S and T are
// handled in the kernel without padded copies (TMA fills rows past the end
// with zeros).  Blocks share nothing and use no atomics: every sum has one
// fixed order, and two launches agree bit for bit.  Indices into the
// planes are 64-bit.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;   // 16 × 16: tx = tid % 16, ty = tid / 16
constexpr int kBQ = 64;         // query rows of a tile
constexpr int kBK = 64;         // keys of a tile
constexpr int kPLd = kBK + 1;  // row stride of a (kBQ, kBK) tile of p or ds:
                                // neighbouring rows in distinct banks
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Rows [r0, r0 + R) of a (n_rows, D) row-major plane into smem[R][D + 4] as
// f32, zero past n_rows; 16-byte global loads, 16 bytes per thread.
template <typename T, int D, int R>
__device__ __forceinline__ void load_tile(float* __restrict__ smem,
                                          const T* __restrict__ src,
                                          int64_t r0, int64_t n_rows) {
  constexpr int kLd = D + 4;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kThreads) {
    const int row = idx / kChunks;
    const int col = (idx % kChunks) * kVec;
    float* dst = smem + row * kLd + col;
    if (r0 + row < n_rows) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (r0 + row) * D + col);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(to_f32(vals[e]), to_f32(vals[e + 1]),
                        to_f32(vals[e + 2]), to_f32(vals[e + 3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        *reinterpret_cast<float4*>(dst + e) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }
}

// acc[i][j] += Σ_d A[ty + 16i][d] · B[tx + 16j][d] over two tiles in
// smem[64][D + 4]: the thread's 4 × 4 share of A·Bᵀ, in order of d.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int tx,
                                         int ty) {
  constexpr int kLd = D + 4;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kLd + d);
      b[i] = *reinterpret_cast<const float4*>(B + (tx + 16 * i) * kLd + d);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// Whether score (row, col) takes part: col < T, row < S and, when causal,
// col ≤ row (the TPU kernel's _causal_mask with its cols < T bound).
__device__ __forceinline__ bool admitted(int64_t row, int64_t col, int64_t S,
                                         int64_t T, int causal) {
  return col < T && row < S && (!causal || col <= row);
}

// Reductions over the 16 lanes that share a row (lanes differ in tx only).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Key tiles a query tile starting at q0 visits: all of them, or under the
// causal mask those that start at or before its last row.
__device__ __forceinline__ int kv_tiles(int64_t q0, int64_t T, int causal) {
  int64_t n = (T + kBK - 1) / kBK;
  if (causal) {
    const int64_t last = (q0 + kBQ - 1) / kBK + 1;
    n = n < last ? n : last;
  }
  return static_cast<int>(n);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int64_t S, int64_t Tk,
                     float scale, int causal) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;   // output columns of a thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* Ps = Vs + kBK * kLd;      // [kBQ][kPLd]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  load_tile<T, D, kBQ>(Qs, q + bh * S * D, q0, S);
  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = kv_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * kBK;
    __syncthreads();   // the previous tile's Ks, Vs, Ps are consumed
    load_tile<T, D, kBK>(Ks, kb, k0, Tk);
    load_tile<T, D, kBK>(Vs, vb, k0, Tk);
    __syncthreads();
    float s[4][4] = {};
    tile_dot<D>(s, Qs, Ks, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        s[i][j] = admitted(row, col, S, Tk, causal) ? s[i][j] * scale
                                                    : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = Vs[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * kPLd + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float lv = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      orow[tx + 16 * c] = from_f32<T>(acc[i][c] / lv);
    }
    if (tx == 0) lse[bh * S + row] = m[i] + logf(lv);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int64_t S, int64_t Tk, float scale, int causal) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kBQ * kLd;
  float* Ks = dOs + kBQ * kLd;
  float* Vs = Ks + kBK * kLd;
  float* dSs = Vs + kBK * kLd;     // [kBQ][kPLd]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;

  load_tile<T, D, kBQ>(Qs, q + bh * S * D, q0, S);
  load_tile<T, D, kBQ>(dOs, dout + bh * S * D, q0, S);
  float row_lse[4], row_delta[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    row_lse[i] = row < S ? lse[bh * S + row] : 0.f;
    row_delta[i] = row < S ? delta[bh * S + row] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }
  const int n_kt = kv_tiles(q0, Tk, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = static_cast<int64_t>(kt) * kBK;
    __syncthreads();
    load_tile<T, D, kBK>(Ks, kb, k0, Tk);
    load_tile<T, D, kBK>(Vs, vb, k0, Tk);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, Qs, Ks, tx, ty);
    tile_dot<D>(dp, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        const float p = admitted(row, col, S, Tk, causal)
                            ? expf(s[i][j] * scale - row_lse[i])
                            : 0.f;
        dSs[(ty + 16 * i) * kPLd + tx + 16 * j] = p * (dp[i][j] - row_delta[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float kv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = Ks[kk * kLd + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * kPLd + kk];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    if (row >= S) continue;
    T* out = dq + (bh * S + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      out[tx + 16 * c] = from_f32<T>(acc[i][c] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int64_t S, int64_t Tk, float scale,
                     int causal) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kBK * kLd;
  float* Qs = Vs + kBK * kLd;
  float* dOs = Qs + kBQ * kLd;
  float* Ps = dOs + kBQ * kLd;     // [kBQ][kPLd]
  float* dSs = Ps + kBQ * kPLd;    // [kBQ][kPLd]
  float* lse_s = dSs + kBQ * kPLd; // [kBQ]
  float* delta_s = lse_s + kBQ;    // [kBQ]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t bh = blockIdx.y;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kBK;
  const T* qb = q + bh * S * D;
  const T* dob = dout + bh * S * D;

  load_tile<T, D, kBK>(Ks, k + bh * Tk * D, k0, Tk);
  load_tile<T, D, kBK>(Vs, v + bh * Tk * D, k0, Tk);
  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;
  }
  // under the causal mask a key tile sees gradient only from the query
  // tiles whose last row reaches its first key
  const int64_t n_qt = (S + kBQ - 1) / kBQ;
  const int64_t first = causal ? k0 / kBQ : 0;
  for (int64_t qt = first; qt < n_qt; ++qt) {
    const int64_t q0 = qt * kBQ;
    __syncthreads();
    load_tile<T, D, kBQ>(Qs, qb, q0, S);
    load_tile<T, D, kBQ>(dOs, dob, q0, S);
    if (threadIdx.x < kBQ) {
      const int64_t row = q0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[bh * S + row] : 0.f;
      delta_s[threadIdx.x] = row < S ? delta[bh * S + row] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot<D>(s, Qs, Ks, tx, ty);
    tile_dot<D>(dp, dOs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int64_t row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t col = k0 + tx + 16 * j;
        const float p = admitted(row, col, S, Tk, causal)
                            ? expf(s[i][j] * scale - lse_s[r])
                            : 0.f;
        Ps[r * kPLd + tx + 16 * j] = p;
        dSs[r * kPLd + tx + 16 * j] = p * (dp[i][j] - delta_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < kBQ; ++rr) {
      float dov[kCols], qv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dov[c] = dOs[rr * kLd + tx + 16 * c];
        qv[c] = Qs[rr * kLd + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[rr * kPLd + ty + 16 * i];
        const float ds = dSs[rr * kPLd + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc_v[i][c] = fmaf(p, dov[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds, qv[c], acc_k[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = k0 + ty + 16 * i;
    if (row >= Tk) continue;
    T* dkr = dk + (bh * Tk + row) * D;
    T* dvr = dv + (bh * Tk + row) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dkr[tx + 16 * c] = from_f32<T>(acc_k[i][c] * scale);
      dvr[tx + 16 * c] = from_f32<T>(acc_v[i][c]);
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (3 * 64 * (D + 4) + kBQ * kPLd);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 4) + kBQ * kPLd);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (4 * 64 * (D + 4) + 2 * kBQ * kPLd + 2 * kBQ);
}

// Opt the kernel into more than 48 KB of dynamic shared memory, then launch.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t BH, int64_t S, int64_t Tk, float scale,
                int causal, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  return launch(flash_fwd_kernel<T, D>, grid, fwd_smem(D), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk,
                scale, causal);
}

template <typename T, int D>
cudaError_t dq_call(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int64_t BH, int64_t S, int64_t Tk, float scale,
                    int causal, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(BH));
  return launch(flash_dq_kernel<T, D>, grid, dq_smem(D), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), S, Tk, scale, causal);
}

template <typename T, int D>
cudaError_t dkv_call(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int64_t BH, int64_t S, int64_t Tk,
                     float scale, int causal, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((Tk + kBK - 1) / kBK),
                  static_cast<unsigned>(BH));
  return launch(flash_dkv_kernel<T, D>, grid, dkv_smem(D), st,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), S, Tk,
                scale, causal);
}

// ---------------------------------------------------------------------------
// The bf16 kernels on the tensor cores (see the note at the top).
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;             // threads of a warpgroup
constexpr int kThreadsTC = 3 * kWG;  // one producer and two consumers
constexpr int kConsumers = 2 * kWG;
constexpr int kStages = 2;           // ring of streamed tiles
constexpr int kBM = 128;             // query rows of a forward / dq block
constexpr int kBNf = 128;            // keys of a forward tile
constexpr int kBNq = 64;             // keys of a dq tile
constexpr int kBK = 128;             // keys of a dk/dv block
constexpr int kBMk = 64;             // query rows of a dk/dv tile
constexpr float kLog2e = 1.4426950408889634f;

// Tile geometry at head width D: TMA boxes of `swz`-byte rows (the swizzle
// follows the row: 32, 64 or 128 bytes), two boxes side by side at D = 128.
template <int D>
struct Geo {
  static constexpr int swz = D >= 64 ? 128 : 2 * D;
  static constexpr int box = swz / 2;   // bf16 values of a box row
  static constexpr int boxes = D / box;
  static __host__ __device__ constexpr uint32_t tile(int rows) {
    return rows * D * 2;
  }
};

__host__ __device__ constexpr uint32_t align1k(uint32_t x) {
  return (x + 1023u) & ~1023u;
}

// Descriptor of k-step kk (16 columns) of rows [r0, r0 + 64) of a K-major
// tile of `rows` rows at shared address t.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t t, int rows, int r0,
                                           int kk) {
  using G = Geo<D>;
  const int col = kk * 16;
  return hopper::desc(t + (col / G::box) * rows * G::swz + r0 * G::swz +
                          (col % G::box) * 2,
                      16, 8 * G::swz, G::swz);
}

// Descriptor of k-step kk (rows 16kk … 16kk + 15, every column) of an
// MN-major tile of `rows` rows at shared address t.
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t t, int rows, int kk) {
  using G = Geo<D>;
  return hopper::desc(t + kk * 16 * G::swz, rows * G::swz, 8 * G::swz,
                      G::swz);
}

// Every box of a rows × D tile of a (BH, L, D) tensor at (row, bh).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int rows, int64_t row,
                                          int64_t bh) {
  using G = Geo<D>;
#pragma unroll
  for (int b = 0; b < G::boxes; ++b) {
    hopper::tma_load_3d(dst + b * rows * G::swz, m, bar, b * G::box,
                        static_cast<int>(row), static_cast<int>(bh));
  }
}

// The A-operand fragments of a 64 × (16·K) accumulator (see hopper.cuh) as
// a hi + lo pair of bf16 values: hi = bf16(x), lo = bf16(x − hi), so the
// two products together carry x to ~2⁻¹⁶ of itself.
template <int K, int R>
__device__ __forceinline__ void to_operands(uint32_t (&hi)[K][4],
                                            uint32_t (&lo)[K][4],
                                            const float (&d)[R]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x0 = d[8 * kk + 2 * j], x1 = d[8 * kk + 2 * j + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      hi[kk][j] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][j] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// Where accumulator element i of this thread sits in its 64-row tile.
__device__ __forceinline__ int acc_row(int i) {
  const int lane = threadIdx.x % 32;
  return 16 * ((threadIdx.x % kWG) / 32) + lane / 4 + 8 * ((i / 2) % 2);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2;
}

// Rows [row0, row0 + 64) of a (BH·L, D) plane from a 64 × D accumulator,
// times `mul`, rows at or past L skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out,
                                           const float (&d)[D / 2],
                                           int64_t row0, int64_t L,
                                           float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row0 + acc_row(2 * h);
    if (row >= L) continue;
    bf16* dst = out + row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + acc_col(4 * j)) =
          __floats2bfloat162_rn(d[4 * j + 2 * h] * mul,
                                d[4 * j + 2 * h + 1] * mul);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory of a block, as byte offsets from its 1024-aligned base:
// the resident tiles, the ring's stages, then the mbarriers.
template <int D>
struct FwdSmem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t ring = Geo<D>::tile(kBM);
  static constexpr uint32_t stage = 2 * Geo<D>::tile(kBNf);   // K, V
  static constexpr uint32_t bars = ring + kStages * stage;
  static constexpr uint32_t bytes = bars + 64 + 1024;
  static __device__ uint32_t k(int st) { return ring + st * stage; }
  static __device__ uint32_t v(int st) {
    return k(st) + Geo<D>::tile(kBNf);
  }
};
template <int D>
struct DqSmem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = Geo<D>::tile(kBM);
  static constexpr uint32_t ring = 2 * Geo<D>::tile(kBM);
  static constexpr uint32_t stage = 2 * Geo<D>::tile(kBNq);   // K, V
  static constexpr uint32_t bars = ring + kStages * stage;
  static constexpr uint32_t bytes = bars + 64 + 1024;
  static __device__ uint32_t k(int st) { return ring + st * stage; }
  static __device__ uint32_t v(int st) {
    return k(st) + Geo<D>::tile(kBNq);
  }
};
template <int D>
struct DkvSmem {
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = Geo<D>::tile(kBK);
  static constexpr uint32_t ring = 2 * Geo<D>::tile(kBK);
  // Q, dO, then lse and δ (kBMk f32 each)
  static constexpr uint32_t stage =
      align1k(2 * Geo<D>::tile(kBMk) + 2 * kBMk * 4);
  static constexpr uint32_t bars = ring + kStages * stage;
  static constexpr uint32_t bytes = bars + 64 + 1024;
  static __device__ uint32_t q(int st) { return ring + st * stage; }
  static __device__ uint32_t dout(int st) {
    return q(st) + Geo<D>::tile(kBMk);
  }
  static __device__ uint32_t lse(int st) {
    return dout(st) + Geo<D>::tile(kBMk);
  }
  static __device__ uint32_t delta(int st) { return lse(st) + kBMk * 4; }
};

// mbarriers at `bars`: [0] the block's resident tiles, [1 + st] stage st
// full, [1 + kStages + st] stage st empty.
__device__ __forceinline__ uint32_t bar_at(uint32_t bars, int i) {
  return bars + 8 * i;
}
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_at(bars, 0), 1);
    for (int st = 0; st < kStages; ++st) {
      hopper::mbar_init(bar_at(bars, 1 + st), 1);
      hopper::mbar_init(bar_at(bars, 1 + kStages + st), kConsumers);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}
// The producer's wait for stage `it % kStages` to be free before its
// (it / kStages + 1)-th fill.
__device__ __forceinline__ void wait_free(uint32_t bars, int it) {
  if (it >= kStages) {
    hopper::mbar_wait(bar_at(bars, 1 + kStages + it % kStages),
                      ((it / kStages) + 1) & 1);
  }
}
__device__ __forceinline__ void wait_full(uint32_t bars, int it) {
  hopper::mbar_wait(bar_at(bars, 1 + it % kStages), (it / kStages) & 1);
}
__device__ __forceinline__ void release(uint32_t bars, int it) {
  hopper::mbar_arrive(bar_at(bars, 1 + kStages + it % kStages));
}
__device__ __forceinline__ uint32_t smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return align1k(hopper::smem_addr(smem_raw));
}

// Key tiles of `bn` keys that query rows [q0, q0 + kBM) visit: all of
// them, or under the causal mask those up to the block's last row.
__device__ __forceinline__ int key_tiles(int64_t q0, int64_t S, int64_t Tk,
                                         int bn, int causal) {
  int64_t n = (Tk + bn - 1) / bn;
  if (causal) {
    const int64_t last = (q0 + kBM - 1 < S - 1 ? q0 + kBM - 1 : S - 1);
    n = n < last / bn + 1 ? n : last / bn + 1;
  }
  return static_cast<int>(n);
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                 float* __restrict__ lse, int64_t S, int64_t Tk, float scale,
                 int causal) {
  using L = FwdSmem<D>;
  const uint32_t base = smem_base();
  const uint32_t bars = base + L::bars;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBM;
  const int n_kt = key_tiles(q0, S, Tk, kBNf, causal);
  init_bars(bars);

  if (threadIdx.x < kWG) {   // producer
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar_at(bars, 0), Geo<D>::tile(kBM));
      load_tile<D>(base + L::q, &mq, bar_at(bars, 0), kBM, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        wait_free(bars, kt);
        const uint32_t full = bar_at(bars, 1 + kt % kStages);
        hopper::mbar_expect_tx(full, 2 * Geo<D>::tile(kBNf));
        load_tile<D>(base + L::k(kt % kStages), &mk, full, kBNf,
                     static_cast<int64_t>(kt) * kBNf, bh);
        load_tile<D>(base + L::v(kt % kStages), &mv, full, kBNf,
                     static_cast<int64_t>(kt) * kBNf, bh);
      }
    }
  } else {                   // consumers: 64 query rows each
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / kWG - 1;
    const int64_t r0 = q0 + 64 * wg;   // first row of this warpgroup
    const float sl2 = scale * kLog2e;
    float acc[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(bar_at(bars, 0), 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      const int64_t k0 = static_cast<int64_t>(kt) * kBNf;
      wait_full(bars, kt);
      float s[kBNf / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::mma_ss<kBNf>(s, kmajor<D>(base + L::q, kBM, 64 * wg, kk),
                             kmajor<D>(base + L::k(st), kBNf, 0, kk), kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      if ((causal && k0 + kBNf - 1 > r0) || k0 + kBNf > Tk) {
#pragma unroll
        for (int i = 0; i < kBNf / 2; ++i) {
          const int64_t col = k0 + acc_col(i), row = r0 + acc_row(i);
          if (col >= Tk || (causal && col > row)) s[i] = kNegInf;
        }
      }
      float mx[2] = {m[0], m[1]}, corr[2], mb[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kBNf / 2; ++i) {
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = quad_max(mx[h]);
        corr[h] = exp2f((m[h] - mx[h]) * sl2);
        m[h] = mx[h];
        mb[h] = mx[h] * sl2;
      }
#pragma unroll
      for (int i = 0; i < kBNf / 2; ++i) {
        s[i] = exp2f(fmaf(s[i], sl2, -mb[(i / 2) % 2]));
        ls[(i / 2) % 2] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ls[h];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];
      uint32_t p_hi[kBNf / 16][4], p_lo[kBNf / 16][4];
      to_operands(p_hi, p_lo, s);
      hopper::wgmma_fence();
      hopper::fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < kBNf / 16; ++kk) {
        const uint64_t b = mnmajor<D>(base + L::v(st), kBNf, kk);
        hopper::mma_rs<D>(acc, p_hi[kk], b, 1);
        hopper::mma_rs<D>(acc, p_lo[kk], b, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      release(bars, kt);
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lv = fmaxf(quad_sum(l[h]), 1e-30f);
      inv[h] = 1.f / lv;
      const int64_t row = r0 + acc_row(2 * h);
      if (row < S && threadIdx.x % 4 == 0) {
        lse[bh * S + row] = m[h] * scale + logf(lv);
      }
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= inv[(i / 2) % 2];
    store_rows<D>(o + bh * S * D, acc, r0, S, 1.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_dq_tc(const __grid_constant__ CUtensorMap mq,
                const __grid_constant__ CUtensorMap mk,
                const __grid_constant__ CUtensorMap mv,
                const __grid_constant__ CUtensorMap mdo,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                int64_t S, int64_t Tk, float scale, int causal) {
  using L = DqSmem<D>;
  const uint32_t base = smem_base();
  const uint32_t bars = base + L::bars;
  const int64_t bh = blockIdx.x;
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBM;
  const int n_kt = key_tiles(q0, S, Tk, kBNq, causal);
  init_bars(bars);

  if (threadIdx.x < kWG) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar_at(bars, 0), 2 * Geo<D>::tile(kBM));
      load_tile<D>(base + L::q, &mq, bar_at(bars, 0), kBM, q0, bh);
      load_tile<D>(base + L::dout, &mdo, bar_at(bars, 0), kBM, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        wait_free(bars, kt);
        const uint32_t full = bar_at(bars, 1 + kt % kStages);
        hopper::mbar_expect_tx(full, 2 * Geo<D>::tile(kBNq));
        load_tile<D>(base + L::k(kt % kStages), &mk, full, kBNq,
                     static_cast<int64_t>(kt) * kBNq, bh);
        load_tile<D>(base + L::v(kt % kStages), &mv, full, kBNq,
                     static_cast<int64_t>(kt) * kBNq, bh);
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    const int wg = threadIdx.x / kWG - 1;
    const int64_t r0 = q0 + 64 * wg;
    const float sl2 = scale * kLog2e;
    float lse2[2], dl[2], acc[D / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = r0 + acc_row(2 * h);
      lse2[h] = row < S ? lse[bh * S + row] * kLog2e : 0.f;
      dl[h] = row < S ? delta[bh * S + row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(bar_at(bars, 0), 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt % kStages;
      const int64_t k0 = static_cast<int64_t>(kt) * kBNq;
      wait_full(bars, kt);
      float s[kBNq / 2], dp[kBNq / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::mma_ss<kBNq>(s, kmajor<D>(base + L::q, kBM, 64 * wg, kk),
                             kmajor<D>(base + L::k(st), kBNq, 0, kk), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::mma_ss<kBNq>(dp, kmajor<D>(base + L::dout, kBM, 64 * wg, kk),
                             kmajor<D>(base + L::v(st), kBNq, 0, kk), kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      hopper::fence_operand(dp);
      const bool edge = (causal && k0 + kBNq - 1 > r0) || k0 + kBNq > Tk;
#pragma unroll
      for (int i = 0; i < kBNq / 2; ++i) {
        float p = exp2f(fmaf(s[i], sl2, -lse2[(i / 2) % 2]));
        if (edge) {
          const int64_t col = k0 + acc_col(i), row = r0 + acc_row(i);
          if (col >= Tk || (causal && col > row)) p = 0.f;
        }
        s[i] = p * (dp[i] - dl[(i / 2) % 2]);
      }
      uint32_t ds_hi[kBNq / 16][4], ds_lo[kBNq / 16][4];
      to_operands(ds_hi, ds_lo, s);
      hopper::wgmma_fence();
      hopper::fence_operand(acc);
#pragma unroll
      for (int kk = 0; kk < kBNq / 16; ++kk) {
        const uint64_t b = mnmajor<D>(base + L::k(st), kBNq, kk);
        hopper::mma_rs<D>(acc, ds_hi[kk], b, 1);
        hopper::mma_rs<D>(acc, ds_lo[kk], b, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      release(bars, kt);
    }
    store_rows<D>(dq + bh * S * D, acc, r0, S, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flash_dkv_tc(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const __grid_constant__ CUtensorMap mlse,
                 const __grid_constant__ CUtensorMap mdelta,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int64_t S,
                 int64_t Tk, float scale, int causal) {
  using L = DkvSmem<D>;
  const uint32_t base = smem_base();
  const uint32_t bars = base + L::bars;
  const int64_t bh = blockIdx.x;
  const int64_t k0 = static_cast<int64_t>(blockIdx.y) * kBK;
  // under the causal mask a key block sees gradient only from the query
  // tiles whose last row reaches its first key
  const int64_t n_qt = (S + kBMk - 1) / kBMk;
  const int64_t first = causal ? k0 / kBMk : 0;
  const int n_it = static_cast<int>(n_qt > first ? n_qt - first : 0);
  init_bars(bars);

  if (threadIdx.x < kWG) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bar_at(bars, 0), 2 * Geo<D>::tile(kBK));
      load_tile<D>(base + L::k, &mk, bar_at(bars, 0), kBK, k0, bh);
      load_tile<D>(base + L::v, &mv, bar_at(bars, 0), kBK, k0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int st = it % kStages;
        const int64_t q0 = (first + it) * kBMk;
        wait_free(bars, it);
        const uint32_t full = bar_at(bars, 1 + st);
        hopper::mbar_expect_tx(full, 2 * Geo<D>::tile(kBMk) + 2 * kBMk * 4);
        load_tile<D>(base + L::q(st), &mq, full, kBMk, q0, bh);
        load_tile<D>(base + L::dout(st), &mdo, full, kBMk, q0, bh);
        hopper::tma_load_1d(base + L::lse(st), &mlse, full,
                            static_cast<int>(bh * S + q0));
        hopper::tma_load_1d(base + L::delta(st), &mdelta, full,
                            static_cast<int>(bh * S + q0));
      }
    }
  } else {
    hopper::setmaxnreg_inc<240>();
    extern __shared__ uint8_t smem_raw[];
    // generic pointer to the aligned base, for the lse and δ reads
    const uint8_t* gbase = smem_raw + (base - hopper::smem_addr(smem_raw));
    const int wg = threadIdx.x / kWG - 1;
    const int64_t kr0 = k0 + 64 * wg;   // first key of this warpgroup
    const float sl2 = scale * kLog2e;
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    hopper::mbar_wait(bar_at(bars, 0), 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % kStages;
      const int64_t q0 = (first + it) * kBMk;
      wait_full(bars, it);
      float s[kBMk / 2], dp[kBMk / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::mma_ss<kBMk>(s, kmajor<D>(base + L::k, kBK, 64 * wg, kk),
                             kmajor<D>(base + L::q(st), kBMk, 0, kk), kk);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        hopper::mma_ss<kBMk>(dp, kmajor<D>(base + L::v, kBK, 64 * wg, kk),
                             kmajor<D>(base + L::dout(st), kBMk, 0, kk), kk);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(s);
      hopper::fence_operand(dp);
      const float* lse_s =
          reinterpret_cast<const float*>(gbase + L::lse(st));
      const float* dl_s =
          reinterpret_cast<const float*>(gbase + L::delta(st));
      const bool edge = q0 + kBMk > S || (causal && q0 < kr0 + 63);
#pragma unroll
      for (int i = 0; i < kBMk / 2; ++i) {
        const int c = acc_col(i);   // query row of the tile
        float p = exp2f(fmaf(s[i], sl2, -lse_s[c] * kLog2e));
        if (edge) {
          const int64_t row = q0 + c, key = kr0 + acc_row(i);
          if (row >= S || (causal && key > row)) p = 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - dl_s[c]);
      }
      // dV's operands, then dK's while dV's products run: P's f32 tile is
      // gone before dS's operands exist
      uint32_t p_hi[kBMk / 16][4], p_lo[kBMk / 16][4];
      to_operands(p_hi, p_lo, s);
      hopper::wgmma_fence();
      hopper::fence_operand(acc_v);
      hopper::fence_operand(acc_k);
#pragma unroll
      for (int kk = 0; kk < kBMk / 16; ++kk) {
        const uint64_t b = mnmajor<D>(base + L::dout(st), kBMk, kk);
        hopper::mma_rs<D>(acc_v, p_hi[kk], b, 1);
        hopper::mma_rs<D>(acc_v, p_lo[kk], b, 1);
      }
      uint32_t ds_hi[kBMk / 16][4], ds_lo[kBMk / 16][4];
      to_operands(ds_hi, ds_lo, dp);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBMk / 16; ++kk) {
        const uint64_t b = mnmajor<D>(base + L::q(st), kBMk, kk);
        hopper::mma_rs<D>(acc_k, ds_hi[kk], b, 1);
        hopper::mma_rs<D>(acc_k, ds_lo[kk], b, 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc_v);
      hopper::fence_operand(acc_k);
      release(bars, it);
    }
    store_rows<D>(dk + bh * Tk * D, acc_k, kr0, Tk, scale);
    store_rows<D>(dv + bh * Tk * D, acc_v, kr0, Tk, 1.f);
  }
}

// --- host side --------------------------------------------------------------

// A (BH, L, D) bf16 tensor as a 3-D map with boxes of `rows` × Geo::box.
template <int D>
bool rows_map(CUtensorMap* m, const void* ptr, int64_t L, int64_t BH,
              int rows) {
  using G = Geo<D>;
  const cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(L) * D * 2};
  const cuuint32_t box[3] = {G::box, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = G::swz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : G::swz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return hopper::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                           const_cast<void*>(ptr), dims, strides, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (BH·S,) f32 plane as a 1-D map with boxes of kBMk values.
bool vec_map(CUtensorMap* m, const float* ptr, int64_t n) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {4};   // unused at rank 1
  const cuuint32_t box[1] = {kBMk};
  const cuuint32_t step[1] = {1};
  return hopper::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                           const_cast<float*>(ptr), dims, strides, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What TMA needs of the operands: 16-byte aligned bases, and every
// coordinate within int32.
bool tma_ok(int64_t BH, int64_t S, int64_t Tk,
            std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return hopper::encoder() != nullptr && BH * S < (int64_t(1) << 31) &&
         BH * Tk < (int64_t(1) << 31);
}

template <typename Kernel, typename... Args>
cudaError_t launch_tc(Kernel kernel, dim3 grid, uint32_t smem,
                      cudaStream_t st, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsTC, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t BH, int64_t S, int64_t Tk, float scale,
                int causal, cudaStream_t st) {
  if (!tma_ok(BH, S, Tk, {q, k, v, o})) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!rows_map<D>(&mq, q, S, BH, kBM) || !rows_map<D>(&mk, k, Tk, BH, kBNf) ||
      !rows_map<D>(&mv, v, Tk, BH, kBNf)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((S + kBM - 1) / kBM));
  return launch_tc(flash_fwd_tc<D>, grid, FwdSmem<D>::bytes, st, mq, mk, mv,
                   static_cast<bf16*>(o), lse, S, Tk, scale, causal);
}

template <int D>
cudaError_t dq_call(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dq, int64_t BH, int64_t S, int64_t Tk, float scale,
                    int causal, cudaStream_t st) {
  if (!tma_ok(BH, S, Tk, {q, k, v, dout, dq})) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!rows_map<D>(&mq, q, S, BH, kBM) || !rows_map<D>(&mk, k, Tk, BH, kBNq) ||
      !rows_map<D>(&mv, v, Tk, BH, kBNq) ||
      !rows_map<D>(&mdo, dout, S, BH, kBM)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((S + kBM - 1) / kBM));
  return launch_tc(flash_dq_tc<D>, grid, DqSmem<D>::bytes, st, mq, mk, mv,
                   mdo, lse, delta, static_cast<bf16*>(dq), S, Tk, scale,
                   causal);
}

template <int D>
cudaError_t dkv_call(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dk, void* dv, int64_t BH, int64_t S, int64_t Tk,
                     float scale, int causal, cudaStream_t st) {
  if (!tma_ok(BH, S, Tk, {q, k, v, dout, lse, delta, dk, dv})) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv, mdo, mlse, mdelta;
  if (!rows_map<D>(&mq, q, S, BH, kBMk) || !rows_map<D>(&mk, k, Tk, BH, kBK) ||
      !rows_map<D>(&mv, v, Tk, BH, kBK) ||
      !rows_map<D>(&mdo, dout, S, BH, kBMk) ||
      !vec_map(&mlse, lse, BH * S) || !vec_map(&mdelta, delta, BH * S)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(static_cast<unsigned>(BH),
                  static_cast<unsigned>((Tk + kBK - 1) / kBK));
  return launch_tc(flash_dkv_tc<D>, grid, DkvSmem<D>::bytes, st, mq, mk, mv,
                   mdo, mlse, mdelta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), S, Tk, scale, causal);
}

}  // namespace tc

// dtype: 0 = float32 (SIMT), 1 = bfloat16 (tensor cores).
// hd ∈ {16, 32, 64, 128}.
#define FLASH_DISPATCH(FN, ...)                                      \
  switch (dtype * 1000 + hd) {                                       \
    case 16: return FN<float, 16>(__VA_ARGS__);                      \
    case 32: return FN<float, 32>(__VA_ARGS__);                      \
    case 64: return FN<float, 64>(__VA_ARGS__);                      \
    case 128: return FN<float, 128>(__VA_ARGS__);                    \
    case 1016: return tc::FN<16>(__VA_ARGS__);                       \
    case 1032: return tc::FN<32>(__VA_ARGS__);                       \
    case 1064: return tc::FN<64>(__VA_ARGS__);                       \
    case 1128: return tc::FN<128>(__VA_ARGS__);                      \
    default: return cudaErrorInvalidValue;                           \
  }

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, float* lse,
                                   int64_t BH, int64_t S, int64_t Tk, int hd,
                                   int dtype, float scale, int causal,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, BH, S, Tk, scale, causal, st)
}

extern "C" int flash_attention_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  void* dq, int64_t BH, int64_t S, int64_t Tk,
                                  int hd, int dtype, float scale, int causal,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq_call, q, k, v, dout, lse, delta, dq, BH, S, Tk, scale,
                 causal, st)
}

extern "C" int flash_attention_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dk, void* dv, int64_t BH, int64_t S,
                                   int64_t Tk, int hd, int dtype, float scale,
                                   int causal, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkv_call, q, k, v, dout, lse, delta, dk, dv, BH, S, Tk,
                 scale, causal, st)
}
