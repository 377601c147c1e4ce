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
// product accumulates in f32; the adapter term is added to that f32
// accumulator and the sum is cast once, as the TPU kernel's last-k epilogue
// does. scale and mask are device tensors read at run time, so swapping a
// lane's adapter or rank never rebuilds anything.
//
// The TPU kernel reached a lane axis only through vmap of pallas_call. Here
// the lane axis is native: W is shared by every lane, so the L·M rows form
// ONE GEMM against W (W is streamed once per row tile, not once per lane)
// and a row's lane (l = row / M) is looked up only in the epilogue.
//
// What bounds it on an H100 (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32
// non-tensor, 3.35 TB/s HBM):
//   prefill (L=1, M=512, 896 -> 4864): 4.5 GFLOP, 16 MB -> ~5 us, both
//     bounds close; decode (L=4, M=1): W alone is 8.7 MB -> ~4 us, bytes.
// This first version is the simple, right one: plain f32 FMA tiles through
// shared memory, no tensor cores, no TMA, no pipelining. It runs far above
// both bounds; wgmma + TMA is a later redesign.
//
// Tiling: a block computes a BM x BN output tile with (BM/TM)·(BN/TN)
// threads, each holding a TM x TN f32 accumulator in registers; the k loop
// stages a BK-deep slice of x (transposed, padded against bank conflicts)
// and of W in shared memory. Ragged M/N/K edges are masked in the loads and
// the store; the wrapper pads nothing. Two tile shapes: 64x64 for prefill
// rows, 8x32 for decode (few rows: more column blocks to fill the SMs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
void launch(const void* x, const void* w, const void* t, const void* b,
            const void* scale, const void* mask, void* y, int rows, int M,
            int K, int N, int r, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (rows + BM - 1) / BM);
  dim3 block((BM / TM) * (BN / TN));
  lora_mm_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(t), static_cast<const float*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(mask),
      static_cast<T*>(y), rows, M, K, N, r);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* t, const void* b,
              const void* scale, const void* mask, void* y, int rows, int M,
              int K, int N, int r, cudaStream_t stream) {
  if (rows >= 32)
    launch<T, 64, 64, 16, 4, 4>(x, w, t, b, scale, mask, y, rows, M, K, N, r, stream);
  else
    launch<T, 8, 32, 32, 1, 1>(x, w, t, b, scale, mask, y, rows, M, K, N, r, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every pointer is a contiguous device
// buffer; rows = L·M. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int lora_matmul_launch(int dtype, const void* x, const void* w,
                                  const void* t, const void* b,
                                  const void* scale, const void* mask,
                                  void* y, int rows, int M, int K, int N,
                                  int r, void* stream) {
  if (rows <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, w, t, b, scale, mask, y, rows, M, K, N, r, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, w, t, b, scale, mask, y, rows, M, K, N, r, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lora_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
