// Gated linear recurrence h_t = a_t ⊙ h_{t−1} + b_t over (rows, S, D), h_0 = b_0
// (B12), forward and backward, for sm_90a.
//
// Replaces the Pallas TPU kernel in src/repro/kernels/linear_scan.py
// (_scan_launch → _scan_kernel): the forward launch, and the custom VJP's
// backward, which is the same launch over the reversed, shifted sequence
// followed by two elementwise products.
//
// Both directions are bound by device-memory bytes: one multiply and one add
// per element.  The forward must read a and b and write h (12 bytes an
// element); the backward reads a_{t+1}, dh_t and h_{t−1} and writes g = db and
// da = g ⊙ h_{t−1} (20 bytes an element).
//
// The TPU walks S tiles in order on one core with the carry in VMEM and
// closes each tile with an associative scan.  Here every (row, channel) is
// an independent sequence walked in order by one thread with the carry in a
// register: no carry ever leaves the thread, no second pass, no atomics, and
// every step rounds the product and then the sum (no contracted
// multiply-add) in the plain version's order (kernels/ref.py), so both plans
// give its bits and two launches give equal bits.  Indices are 64-bit.  The
// two plans differ in who loads (kernels/linear_scan.py's scan_tiling picks
// one by shape):
//
// * thread (many sequences: the SSM's (2, ·, 131,072)).  The thread that
//   walks also loads: the walk is unrolled by kUnroll steps whose loads are
//   issued together before the dependent chain, 2·kUnroll (forward) or
//   3·kUnroll (backward) loads in flight a thread.  D is the contiguous axis,
//   so neighbouring threads read neighbouring addresses and every access
//   coalesces; ragged S and D need no padding (bounded channel index and a
//   remainder loop).  Parallelism is rows·D threads: 262,144 fill the card,
//   but 5,120 (the hybrid's (2, ·, 2,560)) keep ~330 kB in flight over the
//   whole card, far from what 3.35 TB/s needs, and the walk is then bound by
//   load latency.
// * staged (few sequences).  Loading and walking are split: a block owns
//   one row and a tile of cb ∈ {8, 16, 32} channels, and has two warps.
//   The producer (lane 0 of warp 1) streams the sequence axis through a ring
//   of `stages` shared-memory stages with TMA, one box of T steps × cb
//   channels a plane a stage, each stage landing on its own mbarrier.  The
//   walker (warp 0) walks channel c0 + c on lane c with the carry in a
//   register, reading the next kUnroll steps from shared memory (immediate
//   offsets: cb is a template parameter) while the current ones run through
//   the chain, and writes each output over an input it has consumed in the
//   same box; it then tells the producer, which stores those boxes with TMA
//   and refills the slot.  So the walker spends ~5 instructions a step (8
//   in the backward), no address arithmetic on device memory, and never
//   issues or waits on a copy.  A stage still costs the walker a fixed
//   fraction of a µs, so few sequences take long stages and many take short
//   ones in a ring that leaves two blocks room on an SM (the planner's
//   choice; tools/sweep_scan.py).  The backward walks the stages in reverse,
//   reading a_{t+1} and h_{t−1} from boxes shifted one step forward and
//   back, so no carry crosses a stage and no flipped copy exists: the box
//   past S arrives as zeros (a_S = 0, so with the carry started at −0 the
//   first step gives g_{S−1} = dh_{S−1} exactly) and the box before 0 gives
//   h_{−1} = 0.  Ragged S: TMA zero-fills past the end, rows past S are
//   walked on zeros in the forward (the backward starts at S − 1), and TMA
//   stores nothing past S or D.  TMA needs 16-byte aligned planes and a
//   16-byte row stride (D % 4 == 0): the entry points refuse other shapes
//   and the wrapper keeps them on the thread plan.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int kUnroll = 8;
constexpr int kMaxGridY = 65535;
constexpr int kMaxSmem = 232448;   // 227 KB a block

__global__ void linear_scan_fwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ h, int64_t rows,
                                       int64_t S, int64_t D) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= D) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t base = r * S * D + c;
    const float* ar = a + base;
    const float* br = b + base;
    float* hr = h + base;
    float carry = br[0];  // h_0 = b_0
    hr[0] = carry;
    int64_t t = 1;
    for (; t + kUnroll <= S; t += kUnroll) {
      float av[kUnroll], bv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = ar[(t + u) * D];
        bv[u] = br[(t + u) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        hr[(t + u) * D] = carry;
      }
    }
    for (; t < S; ++t) {
      carry = __fadd_rn(__fmul_rn(ar[t * D], carry), br[t * D]);
      hr[t * D] = carry;
    }
  }
}

__global__ void linear_scan_bwd_kernel(const float* __restrict__ a,
                                       const float* __restrict__ h,
                                       const float* __restrict__ dh,
                                       float* __restrict__ da,
                                       float* __restrict__ g_out,
                                       int64_t rows, int64_t S, int64_t D) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= D) return;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const int64_t base = r * S * D + c;
    const float* ar = a + base;
    const float* hr = h + base;
    const float* dr = dh + base;
    float* dar = da + base;
    float* gr = g_out + base;
    // g_{S−1} = dh_{S−1}
    int64_t t = S - 1;
    float g = dr[t * D];
    gr[t * D] = g;
    dar[t * D] = __fmul_rn(g, t > 0 ? hr[(t - 1) * D] : 0.0f);
    --t;
    // steps t, t−1, …, t−kUnroll+1, all with t − u − 1 ≥ 0
    for (; t - kUnroll >= 0; t -= kUnroll) {
      float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        dv[u] = dr[(t - u) * D];
        av[u] = ar[(t - u + 1) * D];
        hv[u] = hr[(t - u - 1) * D];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        g = __fadd_rn(dv[u], __fmul_rn(av[u], g));
        gr[(t - u) * D] = g;
        dar[(t - u) * D] = __fmul_rn(g, hv[u]);
      }
    }
    for (; t >= 0; --t) {
      g = __fadd_rn(dr[t * D], __fmul_rn(ar[(t + 1) * D], g));
      gr[t * D] = g;
      dar[t * D] = __fmul_rn(g, t > 0 ? hr[(t - 1) * D] : 0.0f);
    }
  }
}

// Threads a block: the most of 256, 128, 64 that still gives two blocks an
// SM (264 on an H100) over the channel tiles of every row, else 32; fewer
// threads a block spread few sequences over more SMs.
dim3 block_for(int64_t rows, int64_t D) {
  int threads = 256;
  while (threads > 32 && rows * ((D + threads - 1) / threads) < 264) {
    threads /= 2;
  }
  return dim3(threads);
}

dim3 grid_for(int64_t rows, int64_t D, int threads) {
  const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
  return dim3(static_cast<unsigned>((D + threads - 1) / threads),
              static_cast<unsigned>(gy));
}

// --- the staged plan --------------------------------------------------------

// The shared-memory ring of a staged block: `stages` stages of `planes`
// boxes of T × cb floats, then two mbarriers a stage (full: its boxes have
// landed; done: the walker has written its outputs).  Each box sits
// between kUnroll rows of padding on either side, so the walk reads the
// next chunk of kUnroll steps (forward: after the box's last row; backward:
// before its first) without a bound check; the padded rows are never used.
// kUnroll·cb·4 bytes is a multiple of 128, so every box is 128-byte aligned.
struct Ring {
  int cb, T, stages, planes;
  __host__ __device__ uint32_t box_bytes() const {
    return static_cast<uint32_t>(T * cb * 4);
  }
  __host__ __device__ uint32_t pad_bytes() const {
    return static_cast<uint32_t>(kUnroll * cb * 4);
  }
  __host__ __device__ uint32_t box_stride() const {
    return (box_bytes() + 2 * pad_bytes() + 127) / 128 * 128;
  }
  // byte offset of row 0 of box p of slot s
  __host__ __device__ uint32_t box(int s, int p) const {
    return static_cast<uint32_t>(s * planes + p) * box_stride() + pad_bytes();
  }
  __host__ __device__ uint32_t full(int s) const {
    return static_cast<uint32_t>(stages * planes) * box_stride() + s * 8;
  }
  __host__ __device__ uint32_t done(int s) const { return full(stages + s); }
  __host__ __device__ uint32_t bytes() const { return full(2 * stages); }
};

// The producer: lane 0 of warp 1.  It loads sequence stage j(k) of row r,
// channels c0 …, for the k-th stage walked (j = k forward, n − 1 − k
// backward; plane p's box starts at step j·T + shift[p]) into slot
// k % stages, and once the walker is done with a stage stores its output
// boxes (rows past S and channels past D are not written) and, when their
// bytes have been read, refills the slot.  Its waits never hold the walker
// while the ring has a stage in hand.
template <int P, int O>
__device__ __forceinline__ void produce(const Ring& ring, uint32_t base,
                                        const CUtensorMap* const (&maps)[P],
                                        const int (&shift)[P],
                                        const CUtensorMap* const (&outs)[O],
                                        const int (&out_box)[O], int n,
                                        bool reverse, int64_t c0, int64_t r) {
  for (int p = 0; p < P; ++p) hopper::prefetch_map(maps[p]);
  for (int o = 0; o < O; ++o) hopper::prefetch_map(outs[o]);
  const int stages = ring.stages;
  for (int k = 0; k < n + stages; ++k) {
    const int slot = k % stages;
    const int retire = k - stages;  // the stage walked in this slot before
    if (retire >= 0) {
      hopper::mbar_wait(base + ring.done(slot), (retire / stages) & 1);
      const int64_t j = reverse ? n - 1 - retire : retire;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        hopper::tma_store_3d(outs[o], base + ring.box(slot, out_box[o]),
                             static_cast<int>(c0),
                             static_cast<int>(j * ring.T),
                             static_cast<int>(r));
      }
      hopper::bulk_commit();
    }
    if (k < n) {
      if (retire >= 0) hopper::bulk_wait_read<0>();
      const int64_t j = reverse ? n - 1 - k : k;
      const uint32_t bar = base + ring.full(slot);
      hopper::mbar_expect_tx(bar, P * ring.box_bytes());
#pragma unroll
      for (int p = 0; p < P; ++p) {
        hopper::tma_load_3d(base + ring.box(slot, p), maps[p], bar,
                            static_cast<int>(c0),
                            static_cast<int>(j * ring.T + shift[p]),
                            static_cast<int>(r));
      }
    }
  }
  hopper::bulk_wait<0>();
}

// Thread 0 sets up the barriers; both warps then see them.
__device__ __forceinline__ void init_ring(const Ring& ring, uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < ring.stages; ++s) {
      hopper::mbar_init(base + ring.full(s), 1);
      hopper::mbar_init(base + ring.done(s), 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The walker, warp 0, after writing the k-th stage's outputs: hand them to
// the async proxy and tell the producer.
__device__ __forceinline__ void stage_done(const Ring& ring, uint32_t base,
                                           int slot) {
  hopper::fence_async_smem();
  __syncwarp();
  if (threadIdx.x == 0) hopper::mbar_arrive(base + ring.done(slot));
}

// Block b walks row b / n_tiles, channels CB·(b % n_tiles) …: warp 0 walks,
// warp 1 feeds it.  Each stage is walked in whole chunks of kUnroll steps,
// the next chunk's a and b read before the current chunk's chain runs;
// h_t overwrites b_t in its box.  Rows past S in the last stage are walked
// on zeros and never stored.
template <int CB>
__global__ void __launch_bounds__(64)
    linear_scan_fwd_staged_kernel(const __grid_constant__ CUtensorMap ma,
                                  const __grid_constant__ CUtensorMap mb,
                                  const __grid_constant__ CUtensorMap mh,
                                  int64_t S, int64_t n_tiles, Ring ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = hopper::smem_addr(smem);
  const int T = ring.T, stages = ring.stages;
  const int64_t r = blockIdx.x / n_tiles;
  const int64_t c0 = (blockIdx.x % n_tiles) * CB;
  const int n = static_cast<int>((S + T - 1) / T);
  init_ring(ring, base);
  if (threadIdx.x >= 32) {
    if (threadIdx.x == 32) {
      const CUtensorMap* const maps[2] = {&ma, &mb};
      const int shift[2] = {0, 0};
      const CUtensorMap* const outs[1] = {&mh};
      const int out_box[1] = {1};
      produce<2, 1>(ring, base, maps, shift, outs, out_box, n, false, c0, r);
    }
    return;
  }
  const int ln = threadIdx.x & (CB - 1);  // lanes past CB mirror a lane
  // with a_0 set to +0 and the carry at −0, step 0 gives −0 + b_0 = b_0
  float carry = -0.0f;
  for (int k = 0; k < n; ++k) {
    const int slot = k % stages;
    hopper::mbar_wait(base + ring.full(slot), (k / stages) & 1);
    float* as = reinterpret_cast<float*>(smem + ring.box(slot, 0)) + ln;
    float* bs = reinterpret_cast<float*>(smem + ring.box(slot, 1)) + ln;
    if (k == 0) {
      as[0] = 0.0f;
      __syncwarp();
    }
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = as[u * CB];
      bv[u] = bs[u * CB];
    }
    for (int i = 0; i < T; i += kUnroll) {
      float an[kUnroll], bn[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        an[u] = as[(i + kUnroll + u) * CB];
        bn[u] = bs[(i + kUnroll + u) * CB];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
        bs[(i + u) * CB] = carry;
        av[u] = an[u];
        bv[u] = bn[u];
      }
    }
    stage_done(ring, base, slot);
  }
}

// The backward: the k-th stage walked holds steps t0 … t0 + T − 1
// (t0 = (n − 1 − k)·T); the a box starts at t0 + 1 and the h box at t0 − 1,
// so row i holds a_{t+1}, h_{t−1} and dh_t of step t = t0 + i.  g_t
// overwrites dh_t and da_t overwrites h_{t−1}, in place, and those boxes are
// stored at t0.  The first stage walked starts at step S − 1.
template <int CB>
__global__ void __launch_bounds__(64)
    linear_scan_bwd_staged_kernel(const __grid_constant__ CUtensorMap ma,
                                  const __grid_constant__ CUtensorMap mh,
                                  const __grid_constant__ CUtensorMap mdh,
                                  const __grid_constant__ CUtensorMap mda,
                                  const __grid_constant__ CUtensorMap mg,
                                  int64_t S, int64_t n_tiles, Ring ring) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = hopper::smem_addr(smem);
  const int T = ring.T, stages = ring.stages;
  const int64_t r = blockIdx.x / n_tiles;
  const int64_t c0 = (blockIdx.x % n_tiles) * CB;
  const int n = static_cast<int>((S + T - 1) / T);
  init_ring(ring, base);
  if (threadIdx.x >= 32) {
    if (threadIdx.x == 32) {
      const CUtensorMap* const maps[3] = {&ma, &mh, &mdh};
      const int shift[3] = {1, -1, 0};
      const CUtensorMap* const outs[2] = {&mda, &mg};
      const int out_box[2] = {1, 2};
      produce<3, 2>(ring, base, maps, shift, outs, out_box, n, true, c0, r);
    }
    return;
  }
  const int ln = threadIdx.x & (CB - 1);
  // a_S arrives as +0, so the first step is dh_{S−1} + (+0 · −0) = dh_{S−1}
  float g = -0.0f;
  for (int k = 0; k < n; ++k) {
    const int slot = k % stages;
    hopper::mbar_wait(base + ring.full(slot), (k / stages) & 1);
    const float* as =
        reinterpret_cast<const float*>(smem + ring.box(slot, 0)) + ln;
    float* hs = reinterpret_cast<float*>(smem + ring.box(slot, 1)) + ln;
    float* ds = reinterpret_cast<float*>(smem + ring.box(slot, 2)) + ln;
    const int64_t t0 = int64_t(n - 1 - k) * T;
    if (S - t0 < T) {  // the last stage of the sequence, walked first
      for (int i = static_cast<int>(S - t0) - 1; i >= 0; --i) {
        g = __fadd_rn(ds[i * CB], __fmul_rn(as[i * CB], g));
        hs[i * CB] = __fmul_rn(g, hs[i * CB]);
        ds[i * CB] = g;
      }
    } else {
      float av[kUnroll], hv[kUnroll], dv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        av[u] = as[(T - 1 - u) * CB];
        hv[u] = hs[(T - 1 - u) * CB];
        dv[u] = ds[(T - 1 - u) * CB];
      }
      for (int i = T - 1; i >= 0; i -= kUnroll) {
        float an[kUnroll], hn[kUnroll], dn[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          an[u] = as[(i - kUnroll - u) * CB];
          hn[u] = hs[(i - kUnroll - u) * CB];
          dn[u] = ds[(i - kUnroll - u) * CB];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          g = __fadd_rn(dv[u], __fmul_rn(av[u], g));
          hs[(i - u) * CB] = __fmul_rn(g, hv[u]);
          ds[(i - u) * CB] = g;
          av[u] = an[u];
          hv[u] = hn[u];
          dv[u] = dn[u];
        }
      }
    }
    stage_done(ring, base, slot);
  }
}

// A (rows, S, D) f32 plane as a 3-D map with boxes of T steps × cb channels;
// a load gives zeros for elements out of range (past D, before 0 or past
// S), and a store writes none of them.
bool plane_map(CUtensorMap* m, const float* p, int64_t rows, int64_t S,
               int64_t D, int cb, int T) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(S * D) * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cb),
                             static_cast<cuuint32_t>(T), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return hopper::encoder()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                           const_cast<float*>(p), dims, strides, box, step,
                           CU_TENSOR_MAP_INTERLEAVE_NONE,
                           CU_TENSOR_MAP_SWIZZLE_NONE,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE,
                           CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What the staged plan takes: cb ∈ {8, 16, 32}; T a multiple of kUnroll
// up to 256 (a box's most steps); at least two stages, in a ring that fits
// a block; D % 4 == 0 and 16-byte aligned planes (TMA's row stride and
// base); coordinates within int32.
bool staged_ok(const Ring& ring, int64_t rows, int64_t S, int64_t D,
               std::initializer_list<const void*> planes) {
  if (!(ring.cb == 8 || ring.cb == 16 || ring.cb == 32) ||
      ring.T < kUnroll || ring.T > 256 || ring.T % kUnroll != 0 ||
      ring.stages < 2 || ring.bytes() > kMaxSmem || D % 4 != 0 ||
      rows >= (int64_t(1) << 31) || S + ring.T >= (int64_t(1) << 31) ||
      D >= (int64_t(1) << 31) ||
      rows * ((D + ring.cb - 1) / ring.cb) >= (int64_t(1) << 31)) {
    return false;
  }
  for (const void* p : planes) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return hopper::encoder() != nullptr;
}

template <typename Kernel, typename... Args>
int launch_staged(Kernel kernel, const Ring& ring, int64_t blocks,
                  cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ring.bytes()));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), 64, ring.bytes(), stream>>>(
      args..., ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int linear_scan_fwd(const float* a, const float* b, float* h,
                               int64_t rows, int64_t S, int64_t D,
                               cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block = block_for(rows, D);
  linear_scan_fwd_kernel<<<grid_for(rows, D, block.x), block, 0, stream>>>(
      a, b, h, rows, S, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int linear_scan_bwd(const float* a, const float* h,
                               const float* dh, float* da, float* g,
                               int64_t rows, int64_t S, int64_t D,
                               cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block = block_for(rows, D);
  linear_scan_bwd_kernel<<<grid_for(rows, D, block.x), block, 0, stream>>>(
      a, h, dh, da, g, rows, S, D);
  return static_cast<int>(cudaGetLastError());
}

// cb channels a block, T steps a stage, `stages` stages in the ring.
extern "C" int linear_scan_fwd_staged(const float* a, const float* b,
                                      float* h, int64_t rows, int64_t S,
                                      int64_t D, int cb, int T, int stages,
                                      cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const Ring ring{cb, T, stages, 2};
  if (!staged_ok(ring, rows, S, D, {a, b, h})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap ma, mb, mh;
  if (!plane_map(&ma, a, rows, S, D, cb, T) ||
      !plane_map(&mb, b, rows, S, D, cb, T) ||
      !plane_map(&mh, h, rows, S, D, cb, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (D + cb - 1) / cb;
  const auto kernel = cb == 8    ? linear_scan_fwd_staged_kernel<8>
                      : cb == 16 ? linear_scan_fwd_staged_kernel<16>
                                 : linear_scan_fwd_staged_kernel<32>;
  return launch_staged(kernel, ring, rows * n_tiles, stream, ma, mb, mh, S,
                       n_tiles);
}

extern "C" int linear_scan_bwd_staged(const float* a, const float* h,
                                      const float* dh, float* da, float* g,
                                      int64_t rows, int64_t S, int64_t D,
                                      int cb, int T, int stages,
                                      cudaStream_t stream) {
  if (rows <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const Ring ring{cb, T, stages, 3};
  if (!staged_ok(ring, rows, S, D, {a, h, dh, da, g})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap ma, mh, mdh, mda, mg;
  if (!plane_map(&ma, a, rows, S, D, cb, T) ||
      !plane_map(&mh, h, rows, S, D, cb, T) ||
      !plane_map(&mdh, dh, rows, S, D, cb, T) ||
      !plane_map(&mda, da, rows, S, D, cb, T) ||
      !plane_map(&mg, g, rows, S, D, cb, T)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = (D + cb - 1) / cb;
  const auto kernel = cb == 8    ? linear_scan_bwd_staged_kernel<8>
                      : cb == 16 ? linear_scan_bwd_staged_kernel<16>
                                 : linear_scan_bwd_staged_kernel<32>;
  return launch_staged(kernel, ring, rows * n_tiles, stream, ma, mh, mdh,
                       mda, mg, S, n_tiles);
}
