// Fused base + adapter GEMM with a lane axis, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/lora_matmul/kernel.py::lora_matmul_kernel
//   (body _lora_mm_kernel).
//
// What it computes, for every lane l < L and row m < M:
//   y[l, m, :] = x[l, m, :] · W  +  scale[l] · ((t[l, m, :] ⊙ mask[l, :]) · B[l])
// with x (L, M, K) and W (K, N) in the model dtype (f32 or bf16), and
// t = x·A (L, M, r), B (L, r, N), scale (L,), mask (L, r) in f32. The base
// product accumulates in f32; the adapter term is computed in f32 FMA (never
// on the tensor cores, which would round t and B), added to that f32
// accumulator, and the sum is cast once, as the TPU kernel's last-k epilogue
// does. scale and mask are device tensors read at run time.
//
// The lane axis is native: W is shared by every lane, so the L·M rows form
// ONE product against W and a row's lane (l = row / M) is looked up only in
// the epilogue.
//
// Three kernels behind one entry point; the wrapper (ops.py::variant) picks
// one from shape, dtype and alignment alone, and each call is one launch.
// On an H100 (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32 outside it, 3.35 TB/s
// HBM) a 512-row prefill is bound by operations and a 4-row decode by the
// bytes of W:
//
// 1. wgmma (bf16, more than 16 rows, K and N multiples of 8, aligned):
//    TMA brings x tiles (K-major) and W tiles (N-major, never transposed or
//    copied) into a 4-stage ring of 128-byte-swizzled shared memory,
//    completing on mbarriers; one producer thread keeps the loads ahead of 1
//    or 2 consumer warpgroups, each running wgmma.mma_async m64nBNk16 (B
//    read transposed through its descriptor) into f32 registers, one k-tile
//    in flight behind the next. Ragged rows, K and N arrive as TMA's zero
//    fill; the store masks them. The producer also loads the epilogue's t
//    and B[lane] tiles by TMA before the first k-tile, so they are there
//    when the products end; the consumers then scale and mask t in place
//    and add (scale·t⊙mask)·B into the f32 accumulator by FMA, one pass per
//    lane in the tile and per 64 ranks. Tiles of 128 x 128 or 64 x 64
//    (ops.py::wgmma_tile).
// 2. splitk (bf16 or f32, at most 16 rows): each block owns a strip of
//    32·VEC columns and a chunk of K. Every thread streams 16-byte vectors
//    of W (8 bf16 or 4 f32 columns), neighbouring threads on neighbouring
//    columns, the next step's loads in flight during this step's products;
//    each W vector feeds every row from the block's x chunk in shared
//    memory. The block also adds its share of the adapter ranks (q ≡
//    split·8 + warp mod splits·8) in f32, each row with its own lane's B, so
//    B is read once. K is split so the grid fills the SMs once
//    (ops.py::splitk_plan). The last block of a strip, found with an
//    integer ticket, sums the f32 partials in split order, casts once and
//    resets the ticket: no float atomics, the same bits on every run.
// 3. simt (everything else: f32 with many rows, odd K or N, misaligned
//    views): f32 FMA tiles through shared memory, the first version.
//
// Rounding: each variant adds the adapter to f32 sums and casts once; where
// and in what grouping it adds it (term by term into the accumulator after
// the base product, or into split-K's per-split partials) reassociates f32
// sums only. A rank-r adapter zero-padded under the rank
// mask adds exact zeros in the same places as the truncated one, so the
// two give the same bits in every variant.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, as XLA's convert
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device
// (above 48 KB a kernel must ask), once per kernel and device.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

// ---------------------------------------------------------------------------
// 3. simt: plain f32 FMA tiles (the first version of this kernel)
// ---------------------------------------------------------------------------
// A block computes a BM x BN output tile with (BM/TM)·(BN/TN) threads, each
// holding a TM x TN f32 accumulator; the k loop stages a BK-deep slice of x
// (transposed, padded against bank conflicts) and of W in shared memory.
// Ragged M/N/K edges are masked in the loads and the store.
template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
lora_mm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ t, const float* __restrict__ b,
               const float* __restrict__ scale, const float* __restrict__ mask,
               T* __restrict__ y, int rows, int M, int K, int N, int r) {
  constexpr int TX = BN / TN;           // threads along n
  constexpr int NT = TX * (BM / TM);    // threads per block
  __shared__ float xs[BK][BM + 1];      // x tile, k-major
  __shared__ float ws[BK][BN];          // W tile

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // consecutive threads read consecutive k of one x row (coalesced)
    for (int i = tid; i < BM * BK; i += NT) {
      const int mm = i / BK, kk = i % BK;
      const int g = row0 + mm, kg = k0 + kk;
      xs[kk][mm] = (g < rows && kg < K) ? to_f32(x[(size_t)g * K + kg]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += NT) {
      const int kk = i / BN, nn = i % BN;
      const int kg = k0 + kk, n = col0 + nn;
      ws[kk][nn] = (kg < K && n < N) ? to_f32(w[(size_t)kg * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float xv[TM], wv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) xv[i] = xs[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) wv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: acc + scale[l] · ((t ⊙ mask[l]) · B[l]), all f32, one cast
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int g = row0 + ty * TM + i;
    if (g >= rows) continue;
    const int lane = g / M;
    const float* trow = t + (size_t)g * r;
    const float* mrow = mask + (size_t)lane * r;
    const float* bl = b + (size_t)lane * r * N;
    const float s = scale[lane];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = col0 + tx + j * TX;
      if (n >= N) continue;
      float ad = 0.f;
      for (int q = 0; q < r; ++q) ad = fmaf(trow[q] * mrow[q], bl[(size_t)q * N + n], ad);
      y[(size_t)g * N + n] = from_f32<T>(acc[i][j] + s * ad);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
cudaError_t launch_simt(const void* x, const void* w, const void* t, const void* b,
                        const void* scale, const void* mask, void* y, int rows,
                        int M, int K, int N, int r, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (rows + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  lora_mm_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(t), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<T*>(y), rows, M, K, N, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t simt(const void* x, const void* w, const void* t, const void* b,
                 const void* scale, const void* mask, void* y, int rows, int M,
                 int K, int N, int r, cudaStream_t stream) {
  if (rows >= 32)
    return launch_simt<T, 64, 64, 16, 4, 4>(x, w, t, b, scale, mask, y, rows, M, K, N, r, stream);
  return launch_simt<T, 8, 32, 32, 1, 1>(x, w, t, b, scale, mask, y, rows, M, K, N, r, stream);
}

// ---------------------------------------------------------------------------
// 2. splitk: few rows, streams W once
// ---------------------------------------------------------------------------
constexpr int SK_TX = 32;        // threads along N (one warp)
constexpr int SK_TY = 8;         // warps along K
constexpr int SK_THREADS = SK_TX * SK_TY;
constexpr int SK_UNROLL = 4;     // loads per thread per step (two steps in flight)
constexpr int SK_SMEM_MAX = 64 * 1024;

__device__ __forceinline__ void unpack(const uint4& v, float* f, const float*) {
  f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, const __nv_bfloat16*) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Rank q's adapter operands for rows m0 .. m0 + RB: tq[i] = scale[l]·t[m, q]
// ·mask[l, q] and bq[i] = B[l][q, col .. col + VEC) with m = m0 + i and
// l = m / M (nothing for q >= r).
template <int RB, int VEC>
__device__ __forceinline__ void adapter_load(float* tq, float4 (*bq)[VEC / 4],
                                             const float* __restrict__ t,
                                             const float* __restrict__ b,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ mask, int q, int m0,
                                             int rows, int M, int N, int r, int col) {
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int m = m0 + i, lane = m / M;
    tq[i] = 0.f;
    if (m < rows && q < r) {
      tq[i] = scale[lane] * (t[(size_t)m * r + q] * mask[(size_t)lane * r + q]);
      const float4* bp = reinterpret_cast<const float4*>(b + ((size_t)lane * r + q) * N + col);
#pragma unroll
      for (int v = 0; v < VEC / 4; ++v) bq[i][v] = __ldcs(bp + v);
    }
  }
}

// One block: columns [strip·COLS, +COLS) and K rows [split·chunk, +chunk),
// plus the ranks q ≡ split·SK_TY + warp (mod splits·SK_TY) of the adapter.
// rows <= RMAX; the dynamic shared memory holds x's chunk as f32. Up to 4
// rows, two blocks fit on an SM (the plan in ops.py counts on it).
template <typename T, int RMAX>
__global__ void __launch_bounds__(SK_THREADS, RMAX <= 4 ? 2 : 1)
splitk_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ t, const float* __restrict__ b,
              const float* __restrict__ scale, const float* __restrict__ mask,
              T* __restrict__ y, float* __restrict__ part, int* __restrict__ tickets,
              int rows, int M, int K, int N, int r, int chunk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int COLS = SK_TX * VEC;
  constexpr int RB = RMAX < 4 ? RMAX : 4;   // rows per reduction round
  extern __shared__ float xs[];             // [rows][chunk]
  __shared__ float4 red[SK_TY][RB][COLS / 4];   // each warp's sums
  __shared__ int is_last;

  const int tx = threadIdx.x % SK_TX, ty = threadIdx.x / SK_TX;
  const int strip = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int k0 = split * chunk;
  const int kn = min(chunk, K - k0);
  const int col = strip * COLS + tx * VEC;
  const bool active = col < N;   // N % VEC == 0: a vector is wholly in or out
  // W: rows ty, ty + SK_TY, ... of the chunk, SK_UNROLL at a time, the next
  // step's loads issued before this step's products. The first step's go
  // out before anything else, so x and the adapter load under them.
  const uint4* wp = reinterpret_cast<const uint4*>(w + (size_t)k0 * N + col);
  const size_t step = (size_t)N / VEC;    // one W row, in uint4
  uint4 cur[SK_UNROLL];
#pragma unroll
  for (int u = 0; u < SK_UNROLL; ++u) {
    const int kk = ty + u * SK_TY;
    cur[u] = active && kk < kn ? __ldcs(wp + (size_t)kk * step) : make_uint4(0, 0, 0, 0);
  }

  // The adapter, in f32: scale[l]·(t⊙mask)[m, q] · B[l][q, cols] for this
  // warp's ranks q ≡ split·SK_TY + ty (mod splits·SK_TY), each row with its
  // own lane's B, RB rows at a time. The first rank's operands for the
  // first RB rows load now, under the W loads.
  const int q_first = split * SK_TY + ty, q_step = splits * SK_TY;
  float tq[RB];
  float4 bq[RB][VEC / 4];
  adapter_load<RB, VEC>(tq, bq, t, b, scale, mask, active ? q_first : r, 0, rows, M, N, r, col);

  // x's chunk, as f32 (loads SK_UNROLL at a time: one after another, their
  // latencies would add up)
  for (int i0 = threadIdx.x; i0 < rows * kn; i0 += SK_UNROLL * SK_THREADS) {
    float v[SK_UNROLL];
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) {
      const int i = i0 + u * SK_THREADS;
      v[u] = i < rows * kn ? to_f32(x[(size_t)(i / kn) * K + k0 + i % kn]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) {
      const int i = i0 + u * SK_THREADS;
      if (i < rows * kn) xs[(i / kn) * chunk + i % kn] = v[u];
    }
  }
  __syncthreads();

  float acc[RMAX][VEC];
#pragma unroll
  for (int m = 0; m < RMAX; ++m)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[m][e] = 0.f;

  if (active) {
    for (int q = q_first; q < r; q += q_step) {
#pragma unroll
      for (int m0 = 0; m0 < RMAX; m0 += RB) {
        if (q != q_first || m0 != 0)
          adapter_load<RB, VEC>(tq, bq, t, b, scale, mask, q, m0, rows, M, N, r, col);
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          if (m0 + i < rows) {
#pragma unroll
            for (int v = 0; v < VEC / 4; ++v) {
              float* a = acc[m0 + i] + 4 * v;
              a[0] = fmaf(tq[i], bq[i][v].x, a[0]);
              a[1] = fmaf(tq[i], bq[i][v].y, a[1]);
              a[2] = fmaf(tq[i], bq[i][v].z, a[2]);
              a[3] = fmaf(tq[i], bq[i][v].w, a[3]);
            }
          }
        }
      }
    }
    for (int k = ty; k < kn; k += SK_UNROLL * SK_TY) {
      uint4 nxt[SK_UNROLL];
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u) {
        const int kk = k + (SK_UNROLL + u) * SK_TY;
        nxt[u] = kk < kn ? __ldcs(wp + (size_t)kk * step) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u) {
        const int kk = k + u * SK_TY;
        if (kk < kn) {
          float f[VEC];
          unpack(cur[u], f, w);
#pragma unroll
          for (int m = 0; m < RMAX; ++m) {
            if (m < rows) {
              const float xv = xs[m * chunk + kk];
#pragma unroll
              for (int e = 0; e < VEC; ++e) acc[m][e] = fmaf(xv, f[e], acc[m][e]);
            }
          }
        }
        cur[u] = nxt[u];
      }
    }
  }

  // this split's partial: the warps' sums, added in warp order, RB rows a
  // round; each thread sums 4 columns of one row. Then the last block of
  // the strip to finish (integer ticket) sums every split's partial in
  // split order.
#pragma unroll
  for (int m0 = 0; m0 < RMAX; m0 += RB) {
    if (m0 >= rows) break;
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int v = 0; v < VEC / 4; ++v)
        red[ty][i][tx * (VEC / 4) + v] =
            make_float4(acc[m0 + i][4 * v], acc[m0 + i][4 * v + 1], acc[m0 + i][4 * v + 2],
                        acc[m0 + i][4 * v + 3]);
    __syncthreads();
    for (int i = threadIdx.x; i < RB * COLS / 4; i += SK_THREADS) {
      const int m = m0 + i / (COLS / 4), c = i % (COLS / 4), n = strip * COLS + 4 * c;
      if (m >= rows || n >= N) continue;
      float4 s = red[0][i / (COLS / 4)][c];
#pragma unroll
      for (int j = 1; j < SK_TY; ++j) {
        const float4 p = red[j][i / (COLS / 4)][c];
        s.x += p.x; s.y += p.y; s.z += p.z; s.w += p.w;
      }
      *reinterpret_cast<float4*>(&part[((size_t)split * rows + m) * N + n]) = s;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&tickets[strip], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = threadIdx.x; i < rows * COLS / 4; i += SK_THREADS) {
    const int m = i / (COLS / 4), n = strip * COLS + 4 * (i % (COLS / 4));
    if (n >= N) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp0 = 0; sp0 < splits; sp0 += SK_UNROLL) {
      float4 p[SK_UNROLL];
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u)
        if (sp0 + u < splits)
          p[u] = __ldcg(reinterpret_cast<const float4*>(
              &part[((size_t)(sp0 + u) * rows + m) * N + n]));
#pragma unroll
      for (int u = 0; u < SK_UNROLL; ++u)
        if (sp0 + u < splits) {   // in split order
          s.x += p[u].x; s.y += p[u].y; s.z += p[u].z; s.w += p[u].w;
        }
    }
    T* yp = y + (size_t)m * N + n;
    yp[0] = from_f32<T>(s.x); yp[1] = from_f32<T>(s.y);
    yp[2] = from_f32<T>(s.z); yp[3] = from_f32<T>(s.w);
  }
  if (threadIdx.x == 0) tickets[strip] = 0;   // ready for the next launch
}

template <typename T, int RMAX>
cudaError_t launch_splitk(const void* x, const void* w, const void* t, const void* b,
                          const void* scale, const void* mask, void* y, void* part,
                          void* tickets, int rows, int M, int K, int N, int r,
                          int chunk, int splits, cudaStream_t stream) {
  constexpr int COLS = SK_TX * (16 / sizeof(T));
  cudaError_t e = allow_smem<splitk_kernel<T, RMAX>>(SK_SMEM_MAX);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)rows * chunk * sizeof(float);
  if (smem > SK_SMEM_MAX) return cudaErrorInvalidValue;
  dim3 grid((N + COLS - 1) / COLS, splits);
  splitk_kernel<T, RMAX><<<grid, SK_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(t), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<T*>(y), static_cast<float*>(part), static_cast<int*>(tickets),
      rows, M, K, N, r, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t splitk(const void* x, const void* w, const void* t, const void* b,
                   const void* scale, const void* mask, void* y, void* part,
                   void* tickets, int rows, int M, int K, int N, int r, int chunk,
                   int splits, cudaStream_t stream) {
  if (rows <= 4)
    return launch_splitk<T, 4>(x, w, t, b, scale, mask, y, part, tickets, rows, M, K,
                               N, r, chunk, splits, stream);
  if (rows <= 16)
    return launch_splitk<T, 16>(x, w, t, b, scale, mask, y, part, tickets, rows, M, K,
                                N, r, chunk, splits, stream);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// 1. wgmma: tensor cores, TMA ring, f32 adapter epilogue
// ---------------------------------------------------------------------------
constexpr int WG_BK = 64;        // k per stage: one 128-byte swizzle row of bf16
constexpr int WG_STAGES = 4;

template <int BM, int BN>
struct WgTile {
  static constexpr int CONSUMERS = BM / 64;                // warpgroups of wgmma
  static constexpr int THREADS = 128 * (CONSUMERS + 1);    // + the producer's
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;           // BN/64 boxes of 64 x 64
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = WG_STAGES * STAGE;
  static constexpr int T_BYTES = BM * 64 * 4;             // t: two 32-rank boxes
  static constexpr int EPILOGUE = T_BYTES + 64 * BN * 4;   // t and B[lane], f32
  static constexpr int SMEM = 1024 + RING + EPILOGUE + (2 * WG_STAGES + 1) * 8;
  static_assert(BN % 64 == 0 && BM % 64 == 0, "tile");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Waits until the barrier's phase of this parity has completed. A wait of
// more than ~2^34 cycles (seconds) traps: a lost load then fails the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start, leading and
// stride byte offsets in 16-byte units. For x (K-major) the stride is one
// 8-row group (1024 B) and the leading offset is unused; for W (N-major,
// read transposed) the leading offset steps from one 64-column box to the
// next and the stride from one group of 8 k-rows to the next (1024 B).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lead, uint32_t stride) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32 registers) += A (64 x 16, K-major) · B (16 x N, N-major)
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (BN == 128) wgmma_m64n128(d, da, db);
  else wgmma_m64n64(d, da, db);
}

// The epilogue's operands for ranks [q0, q0 + 64) of one lane, by TMA: the
// tile's rows of t (two boxes of 32 ranks, 128-byte swizzled) and B[lane]'s
// 64 x BN block, both zero-filled past r, rows and N.
template <int BM, int BN>
__device__ __forceinline__ void load_adapter(unsigned char* epi, const CUtensorMap* map_t,
                                             const CUtensorMap* map_b, uint64_t* bar, int lane,
                                             int q0, int row0, int col0) {
  mbar_expect_tx(bar, WgTile<BM, BN>::EPILOGUE);
  tma_load_2d(epi, map_t, bar, q0, row0);
  tma_load_2d(epi + BM * 128, map_t, bar, q0 + 32, row0);
  tma_load_3d(epi + WgTile<BM, BN>::T_BYTES, map_b, bar, col0, q0, lane);
}

// scale · (t ⊙ mask) in place for rows ra and ra + 8 of the staged t tile
// (zero for rows of other lanes): the four threads of a row take a quarter
// of its 16-byte chunks each. Chunk q/4 of row ra sits at (q/4 % 8) ^ (ra % 8) of
// its 32-rank box (the 128-byte swizzle).
template <int BM>
__device__ __forceinline__ void mask_rows(float* ts, int ra, int c4, int ga, int gb, int rows,
                                          int M, int lane, const float* __restrict__ mask,
                                          float sc, int q0, int r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h, g = h == 0 ? ga : gb;
    const bool keep = g < rows && g / M == lane;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c4 + 4 * i, q = 4 * c;   // this thread's chunks of 16
      float4* p =
          reinterpret_cast<float4*>(ts + (c / 8) * BM * 32 + row * 32 + ((c % 8) ^ (row % 8)) * 4);
      float mk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) mk[u] = q0 + q + u < r ? mask[(size_t)lane * r + q0 + q + u] : 0.f;
      const float4 v = *p;
      *p = keep ? make_float4(v.x * mk[0] * sc, v.y * mk[1] * sc, v.z * mk[2] * sc,
                              v.w * mk[3] * sc)
                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// acc += (scale·t⊙mask)[rows ra, ra + 8; ranks q .. q + 4) · B[q .. q + 4;
// this thread's columns], in f32 FMA; acc is the wgmma fragment, per
// 32-column group g as [jj][row half][e] for columns 8(4g + jj) + 2·c4 + e
template <int BM, int BN>
__device__ __forceinline__ void adapter_qstep(float* acc, const float* ts, const float* bs, int q,
                                              int ra, int c4) {
  const float* tr = ts + (q / 32) * BM * 32 + (((q % 32) / 4) ^ (ra % 8)) * 4;
  const float4 ta = *reinterpret_cast<const float4*>(tr + ra * 32);
  const float4 tb = *reinterpret_cast<const float4*>(tr + (ra + 8) * 32);
  const float tav[4] = {ta.x, ta.y, ta.z, ta.w};
  const float tbv[4] = {tb.x, tb.y, tb.z, tb.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      const float* br = bs + (q + u) * BN + g * 32 + 2 * c4;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float2 bv = *reinterpret_cast<const float2*>(br + 8 * jj);
        float* a = acc + (4 * g + jj) * 4;
        a[0] = fmaf(tav[u], bv.x, a[0]);
        a[1] = fmaf(tav[u], bv.y, a[1]);
        a[2] = fmaf(tbv[u], bv.x, a[2]);
        a[3] = fmaf(tbv[u], bv.y, a[3]);
      }
    }
  }
}

// Block: BM rows x BN columns of y. Warpgroup 0 is the producer (one thread
// issues TMA); warpgroups 1.. each own 64 rows. Grid: (row tiles, column
// tiles), rows fastest, so the row tiles that share a W strip run together
// and W comes from HBM about once.
template <int BM, int BN>
__global__ void __launch_bounds__(WgTile<BM, BN>::THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_t, const __grid_constant__ CUtensorMap map_b,
             const float* __restrict__ scale, const float* __restrict__ mask,
             __nv_bfloat16* __restrict__ y, int rows, int M, int K, int N, int r) {
  using C = WgTile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled TMA boxes want 1024-byte alignment
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* epi = smem + C::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + C::EPILOGUE);
  uint64_t* empty = full + WG_STAGES;
  uint64_t* epi_bar = empty + WG_STAGES;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int ktiles = (K + WG_BK - 1) / WG_BK;
  const int lane_lo = row0 / M, lane_hi = min(rows - 1, row0 + BM - 1) / M;
  constexpr int NC = C::CONSUMERS * 128;     // consumer threads

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::CONSUMERS * 128);
    }
    mbar_init(epi_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer
    if (tid == 0) {
      // the epilogue's first operands, in flight under the whole main loop
      if (r > 0) load_adapter<BM, BN>(epi, &map_t, &map_b, epi_bar, lane_lo, 0, row0, col0);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % WG_STAGES;
        if (kt >= WG_STAGES) mbar_wait(&empty[s], (kt / WG_STAGES - 1) & 1);
        unsigned char* st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);   // OOB boxes count in full
        tma_load_2d(st, &map_x, &full[s], kt * WG_BK, row0);
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_2d(st + C::A_BYTES + c * 8192, &map_w, &full[s], col0 + 64 * c, kt * WG_BK);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns tile rows [64·cw, 64·cw + 64)
  const int cw = wg - 1;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % WG_STAGES;
    mbar_wait(&full[s], (kt / WG_STAGES) & 1);
    const unsigned char* a = smem + s * C::STAGE + cw * 64 * 128;
    const unsigned char* bw = smem + s * C::STAGE + C::A_BYTES;
    fence_operands<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)   // 16 k = 32 bytes of an x row, 16 rows of W
      wgmma_tile<BN>(acc, smem_desc(a + kk * 32, 16, 1024),
                     smem_desc(bw + kk * 16 * 128, 8192, 1024));
    wgmma_commit();
    // keep this k-tile's products in flight; the previous one's are done,
    // so its stage goes back to the producer
    wgmma_wait_one();
    fence_operands<BN / 2>(acc);
    if (kt > 0) mbar_arrive(&empty[(kt - 1) % WG_STAGES]);
  }
  wgmma_wait_all();
  fence_operands<BN / 2>(acc);

  // epilogue, per lane present in the tile and per 64 ranks, in f32 FMA:
  //   acc += Σ_q (scale[lane]·t⊙mask)[row, q] · B[lane][q, col]
  // This thread's wgmma fragment holds rows ra and ra + 8. The first pass's
  // operands were loaded under the main loop; a further pass (a tile
  // across lanes, or r > 64) loads its own.
  const int warp = tid / 32, ln = tid % 32, c4 = ln % 4;
  const int ra = cw * 64 + warp * 16 + ln / 4;
  const int ga = row0 + ra, gb = ga + 8;
  float* ts = reinterpret_cast<float*>(epi);
  const float* bs = reinterpret_cast<const float*>(epi + C::T_BYTES);
  int pass = 0;
  for (int lane = lane_lo; lane <= lane_hi; ++lane) {
    for (int q0 = 0; q0 < r; q0 += 64, ++pass) {
      if (pass > 0) {
        named_sync(1, NC);   // every consumer is done with the last pass
        if (threadIdx.x == 128)
          load_adapter<BM, BN>(epi, &map_t, &map_b, epi_bar, lane, q0, row0, col0);
      }
      mbar_wait(epi_bar, pass & 1);
      mask_rows<BM>(ts, ra, c4, ga, gb, rows, M, lane, mask, scale[lane], q0, r);
      __syncwarp();   // a row's four threads scaled a quarter of it each
      const int rq4 = (min(64, r - q0) + 3) & ~3;
      for (int q = 0; q < rq4; q += 4) adapter_qstep<BM, BN>(acc, ts, bs, q, ra, c4);
    }
  }

  // one cast, masked store of bf16 pairs
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = col0 + 8 * j + 2 * c4;
    if (n >= N) continue;
    if (ga < rows)
      *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)ga * N + n]) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    if (gb < rows)
      *reinterpret_cast<__nv_bfloat162*>(&y[(size_t)gb * N + n]) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major tensor of `rank` dims (dims and box innermost first), zero
// fill out of bounds. Built per call: a map cached by pointer would read
// stale shapes after the pointer is freed and reused.
bool encode(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
            int rank, const uint64_t* dims, const uint32_t* box, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdims[3], strides[2];
  cuuint32_t gbox[3], elem[3];
  uint64_t stride = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    elem[i] = 1;
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  return fn(map, type, rank, const_cast<void*>(base), gdims, strides, gbox, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
cudaError_t launch_wgmma(const void* x, const void* w, const void* t, const void* b,
                         const void* scale, const void* mask, void* y, int rows, int M,
                         int K, int N, int r, int L, cudaStream_t stream) {
  using C = WgTile<BM, BN>;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const uint64_t dx[2] = {(uint64_t)K, (uint64_t)rows}, dw[2] = {(uint64_t)N, (uint64_t)K};
  const uint64_t dt[2] = {(uint64_t)r, (uint64_t)rows};
  const uint64_t db[3] = {(uint64_t)N, (uint64_t)r, (uint64_t)L};
  const uint32_t bx[2] = {WG_BK, BM}, bw[2] = {64, WG_BK}, bt[2] = {32, BM};
  const uint32_t bb[3] = {BN, 64, 1};
  CUtensorMap map_x, map_w, map_t = {}, map_b = {};
  if (!encode(&map_x, bf16, 2, x, 2, dx, bx, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&map_w, bf16, 2, w, 2, dw, bw, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (r > 0 && (!encode(&map_t, f32, 4, t, 2, dt, bt, CU_TENSOR_MAP_SWIZZLE_128B) ||
                 !encode(&map_b, f32, 4, b, 3, db, bb, CU_TENSOR_MAP_SWIZZLE_NONE))))
    return cudaErrorInvalidValue;
  cudaError_t e = allow_smem<wgmma_kernel<BM, BN>>(C::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((rows + BM - 1) / BM, (N + BN - 1) / BN);
  wgmma_kernel<BM, BN><<<grid, C::THREADS, C::SMEM, stream>>>(
      map_x, map_w, map_t, map_b, static_cast<const float*>(scale),
      static_cast<const float*>(mask), static_cast<__nv_bfloat16*>(y), rows, M, K, N, r);
  return cudaGetLastError();
}

}  // namespace

// variant: 0 = simt, 1 = splitk, 2 = wgmma (chosen by ops.py::variant).
// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer; rows = L·M. p0, p1: the split-K chunk and split count, or the
// wgmma tile's rows and columns; part and tickets are split-K's scratch
// (tickets zero on entry, and again on return). Returns cudaGetLastError()
// after the launch (0 = ok).
extern "C" int lora_matmul_launch(int variant, int dtype, const void* x, const void* w,
                                  const void* t, const void* b, const void* scale,
                                  const void* mask, void* y, void* part, void* tickets,
                                  int rows, int M, int K, int N, int r, int p0, int p1,
                                  void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (variant == 0 && dtype == 0)
    e = simt<float>(x, w, t, b, scale, mask, y, rows, M, K, N, r, s);
  else if (variant == 0 && dtype == 1)
    e = simt<__nv_bfloat16>(x, w, t, b, scale, mask, y, rows, M, K, N, r, s);
  else if (variant == 1 && dtype == 0)
    e = splitk<float>(x, w, t, b, scale, mask, y, part, tickets, rows, M, K, N, r, p0, p1, s);
  else if (variant == 1 && dtype == 1)
    e = splitk<__nv_bfloat16>(x, w, t, b, scale, mask, y, part, tickets, rows, M, K, N, r,
                              p0, p1, s);
  else if (variant == 2 && dtype == 1 && p0 == 128 && p1 == 128)
    e = launch_wgmma<128, 128>(x, w, t, b, scale, mask, y, rows, M, K, N, r, rows / M, s);
  else if (variant == 2 && dtype == 1 && p0 == 64 && p1 == 64)
    e = launch_wgmma<64, 64>(x, w, t, b, scale, mask, y, rows, M, K, N, r, rows / M, s);
  return static_cast<int>(e);
}

extern "C" const char* lora_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
