// Flash attention (B11): the causal online-softmax forward and its two
// backward kernels, for sm_90a.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/flash_attention.py:
//   * flash_attention_fwd  <- _flash_forward (_fwd_kernel)
//       o = softmax(q·kᵀ·scale) · v, and the f32 residual lse = m + log(l)
//   * flash_attention_dq   <- _flash_backward's first call (_dq_kernel)
//       dq = Σ_k p∘(do·vᵀ − δ) · k · scale,  p = exp(q·kᵀ·scale − lse)
//   * flash_attention_dkv  <- _flash_backward's second call (_dkv_kernel)
//       dv = pᵀ·do,  dk = dsᵀ·q · scale,  ds = p∘(do·vᵀ − δ)
// with q (BH, S, hd), k/v (BH, T, hd) in bf16 or f32, lse and δ (BH, S) f32,
// and every output in the input dtype (lse in f32).
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
// bytes; dq does 1.5× the forward's
// work and dk/dv 2×.  This first version computes in f32 on the SIMT cores
// (at most 67 TFLOP/s), not on the tensor cores, so it sits far above that
// bound; moving the two products of each tile onto mma/wgmma is the next
// step.  What the design does within SIMT:
//   * tiles of 64 query rows × 64 keys staged in shared memory as f32 (rows
//     padded to hd + 4 floats so 16-byte loads of neighbouring rows fall in
//     distinct banks), 256 threads, each thread a 4 × 4 register micro-tile
//     of the score tile read with 16-byte loads along hd;
//   * causal tiles strictly above the diagonal are never visited (the TPU
//     kernel's pl.when), and the forward and dq grids start with the
//     heaviest query tiles (the last ones) so the causal tail is short;
//   * masks are by absolute index with the cols < T and rows < S bounds, so
//     ragged S and T are handled in the kernel without padded copies.
// Blocks share nothing and use no atomics: every sum has one fixed order,
// and two launches agree bit for bit.  Indices into the planes are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 × 16: tx = tid % 16, ty = tid / 16
constexpr int kBQ = 64;         // query rows of a tile
constexpr int kBK = 64;         // keys of a tile
constexpr int kPLd = kBK + 1;  // row stride of a (kBQ, kBK) tile of p or ds:
                                // neighbouring rows in distinct banks
constexpr float kNegInf = -1e30f;   // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
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

// dtype: 0 = float32, 1 = bfloat16.  hd ∈ {16, 32, 64, 128}.
#define FLASH_DISPATCH(FN, ...)                                      \
  switch (dtype * 1000 + hd) {                                       \
    case 16: return FN<float, 16>(__VA_ARGS__);                      \
    case 32: return FN<float, 32>(__VA_ARGS__);                      \
    case 64: return FN<float, 64>(__VA_ARGS__);                      \
    case 128: return FN<float, 128>(__VA_ARGS__);                    \
    case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);            \
    case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);            \
    case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);            \
    case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);           \
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
