// Causal GQA flash attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (body _fa_kernel).
//
// What it computes: for batch b, query head h (reading kv head
// h / (H / Hkv)) and query row i,
//   out[b, i, h, :] = Σ_j p_ij · v[b, j, hk, :] / max(Σ_j p_ij, 1e-30)
// with s_ij = (q_i · k_j) · sm_scale and p_ij = exp(s_ij − m_i) inside the
// mask and exactly 0 outside it. Positions are absolute, with the q rows
// aligned to the END of the kv axis (q_pos = i + Sk − Sq): causal keeps
// k_pos ≤ q_pos, a sliding window keeps k_pos > q_pos − window. Inputs are
// the models' (B, S, H, D) layout, read in place (no transposes, no
// padding: ragged Sq/Sk edges are masked here, so the reference wrapper's
// separate q/kv padding, which shifts rows when block_q ≠ block_k, has no
// counterpart). Output is in the input dtype; all arithmetic is f32.
//
// What bounds it on an H100: at the prefill shape (B=4, H=14, Hkv=2,
// S=128, D=64, bf16) it moves about 2 MB and does about 0.1 GFLOP under the
// causal mask, under 1 us either way; launch cost dominates. This first
// version is the simple, right one: f32 FMA through shared memory, no
// tensor cores. Long sequences would want mma/wgmma and a pipelined kv
// loop — a later redesign.
//
// Tiling: grid (ceil(Sq/32), H, B); one block of 4 warps owns 32 query
// rows, 8 per warp. The TPU's sequential kv grid axis becomes a loop over
// 32-key blocks inside the block; m, l and the output accumulator stay in
// registers (lane j of a warp holds columns j, j+32, ... of its rows).
// Per kv block: K and V tiles are staged in shared memory (K rows padded by
// one float so the score loop is free of bank conflicts), each lane scores
// one key, warp shuffles give the row max and sum, and p goes through a
// per-warp shared row into the P·V product. Under the causal mask or a
// window the loop visits only kv blocks that hold a visible key; skipping a
// fully masked block is exact (it leaves m, l and acc unchanged).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per kv step (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int H,
          int Hkv, float sm_scale, int causal, int window) {
  constexpr int NJ = D / 32;           // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                    // BQ x D
  float* ks = qs + BQ * D;             // BK x (D + 1)
  float* vs = ks + BK * (D + 1);       // BK x D
  float* ps = vs + BK * D;             // BQ x BK

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int bi = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t q_stride = (size_t)H * D;     // one sequence position
  const size_t kv_stride = (size_t)Hkv * D;
  const T* qp = q + (size_t)bi * Sq * q_stride + (size_t)h * D;
  const T* kp = k + (size_t)bi * Sk * kv_stride + (size_t)hk * D;
  const T* vp = v + (size_t)bi * Sk * kv_stride + (size_t)hk * D;
  T* op = o + (size_t)bi * Sq * q_stride + (size_t)h * D;

  for (int i = threadIdx.x; i < BQ * D; i += NWARPS * 32) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    qs[i] = qi < Sq ? to_f32(qp[(size_t)qi * q_stride + d]) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][NJ];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[rr][j] = 0.f;
  }

  // q rows sit at the END of the kv axis
  const int off = Sk - Sq;
  const int q_first = q0 + off;
  const int q_last = min(q0 + BQ, Sq) - 1 + off;
  int kv_hi = Sk;
  int kv_lo = 0;
  if (causal) kv_hi = min(Sk, q_last + 1);
  if (window > 0) kv_lo = max(0, q_first - window + 1);

  for (int k0 = (kv_lo / BK) * BK; k0 < kv_hi; k0 += BK) {
    __syncthreads();   // the previous step's readers are done with ks/vs
    for (int i = threadIdx.x; i < BK * D; i += NWARPS * 32) {
      const int kk = i / D, d = i % D;
      const int kj = k0 + kk;
      const bool in = kj < Sk;
      ks[kk * (D + 1) + d] = in ? to_f32(kp[(size_t)kj * kv_stride + d]) : 0.f;
      vs[kk * D + d] = in ? to_f32(vp[(size_t)kj * kv_stride + d]) : 0.f;
    }
    __syncthreads();

    const int kpos = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int row = warp * RPW + rr;
      const int qpos = q0 + row + off;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qs[row * D + d], ks[lane * (D + 1) + d], s);
      s *= sm_scale;
      const bool keep = kpos < Sk && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
      s = keep ? s : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(s));
      // a fully masked row keeps m = NEG_INF, where exp(s − m) would be 1:
      // p is forced to 0 outside the mask
      const float p = keep ? expf(s - m_new) : 0.f;
      const float corr = expf(m[rr] - m_new);
      l[rr] = corr * l[rr] + warp_sum(p);
      m[rr] = m_new;
      ps[row * BK + lane] = p;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float a = acc[rr][j] * corr;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(ps[row * BK + kk], vs[kk * D + lane + 32 * j], a);
        acc[rr][j] = a;
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qi = q0 + warp * RPW + rr;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[(size_t)qi * q_stride + lane + 32 * j] = from_f32<T>(acc[rr][j] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, float sm_scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, Hkv, sm_scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int Hkv, float sm_scale,
             int causal, int window, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o are (B, Sq, H, D) and k/v are
// (B, Sk, Hkv, D), contiguous on the device. window <= 0 means none.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      float sm_scale, int causal, int window,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(D, q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
