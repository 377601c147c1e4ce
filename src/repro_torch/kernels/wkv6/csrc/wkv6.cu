// Chunked RWKV6 (WKV6) recurrence from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6/kernel.py::wkv6_kernel (body _wkv6_kernel).
//
// What it computes, per batch b and head h, over t < S (K = head dim):
//   S_t = diag(e^{logw_t}) · S_{t-1} + k_t v_tᵀ          (S_0 = 0, K x K)
//   y_t = r_tᵀ · (S_{t-1} + diag(u) · k_t v_tᵀ)
// returning y (B, S, H, K) in the input dtype and the final state
// (B, H, K, K) in f32 [K index, V index]. Inputs are the models' layout
// (B, S, H, K), read in place: no transposes and no padding copies (the
// ragged tail of the last chunk is masked here, as k = 0, v = 0, r = 0 and
// logw = 0 rows, which is what the reference wrapper pads with).
//
// The algorithm is the TPU kernel's chunked form: per chunk of Q rows,
// with cum the inclusive cumsum of logw along the chunk and cum_excl the
// exclusive one,
//   y   = A · v + (r ⊙ e^{cum_excl}) · S_prev
//   A_ij = Σ_k r_ik k_jk e^{cum_excl_ik − cum_jk}   (j < i),
//   A_ii = Σ_k r_ik u_k k_ik                        (the diagonal bonus)
//   S   = diag(e^{cum_Q}) · S_prev + (k ⊙ e^{cum_Q − cum})ᵀ · v
// The TPU kernel splits e^{cum_excl − cum} into r ⊙ e^{cum_excl} times
// k ⊙ e^{−cum} at a chunk of 128, and e^{−cum} overflows f32 once a
// channel's decay summed over the chunk passes about −88 (per-step
// log-decays below about −0.7); any split of it overflows at some decay.
// Here each score takes the exponent per channel, e^{cum_excl_ic − cum_jc},
// which is ≤ 0 for j < i because logw ≤ 0, so no factor can overflow at
// any decay. So is every other exponent (e^{cum_excl}, e^{cum_Q − cum},
// e^{cum_Q}). The chunk is Q = 16 rows, which keeps that per-score
// exponential to Q²/2·K per chunk. The result does not depend on the chunk
// length, up to rounding.
//
// What bounds it on an H100: at the served shape (B 4, H 64, K 64, S 128,
// f32) the function needs about 5·K² flops per step and head (the
// per-step form; this chunked form at Q = 16 does 4·Q²·K + 4·Q·K² per
// chunk, the same 2.6 MFLOP per head), 0.67 GFLOP in all (10 us at
// 67 TFLOP/s f32), and it moves 46 MB (14 us at 3.35 TB/s): bytes bound
// it. This design runs the chunks of a head one after another, so with one
// block per head its time is the latency of S/Q dependent chunk steps
// rather than either bound.
//
// Design (a simple, right first version; f32 FMA, no tensor cores):
// grid (H, B), one block of 256 threads per (b, h) — 256 blocks at the
// served shape, two resident per SM. The K x K f32 state (16 KB at K 64)
// lives in shared memory for the whole sequence; the TPU's sequential
// chunk grid axis is a loop inside the block. Per chunk:
//   A. load the r, k, v, logw tiles (Q x K, coalesced along K);
//   B. one thread per channel takes the cumsum of logw along the chunk;
//   C. one warp per row forms the decayed r tile and transposed k tile
//      and, by a warp sum, the row's diagonal bonus;
//   D. one thread per (i, j) forms the causal score A_ij, taking the
//      decay e^{cum_excl_ic − cum_jc} channel by channel;
//   E. thread (row group, column) accumulates y = A·v + rdec·S for its
//      rows, reading A and rdec as float4 broadcasts;
//   F. the same threads decay and update their state rows in place.
// Shared tiles read across threads at varying rows are padded by one float
// (bank conflicts); those read as float4 are 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int Q = 16;        // rows per chunk
constexpr int QP = Q + 4;    // row stride of the transposed k tile
constexpr int NT = 256;      // threads per block
constexpr int NWARPS = NT / 32;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory layout, in floats; every offset is a multiple of 4
template <int K>
struct Smem {
  static constexpr int KP = K + 1;
  static constexpr int ST = 0;                        // state, K x K
  static constexpr int RQ = ST + K * K;               // r ⊙ e^{cum_excl}, Q x K
  static constexpr int QKP = ((Q * KP + 3) / 4) * 4;  // a Q x KP tile
  static constexpr int RI = RQ + Q * K;               // r, Q x KP
  static constexpr int KI = RI + QKP;                 // k, Q x KP
  static constexpr int KT = KI + QKP;                 // (k ⊙ e^{cum_Q − cum})ᵀ, K x QP
  static constexpr int VS = KT + K * QP;              // v, Q x K
  static constexpr int CS = VS + Q * K;               // logw, then its cumsum, Q x KP
  static constexpr int AT = CS + QKP;                 // scores, Q x Q
  static constexpr int DG = AT + Q * Q;               // diagonal bonus, Q
  static constexpr int US = DG + Q;                   // u, K
  static constexpr int DC = US + K;                   // e^{cum_Q}, K
  static constexpr int TOTAL = DC + K;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

template <typename T, int K>
__global__ void __launch_bounds__(NT)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H) {
  using L = Smem<K>;
  constexpr int KP = L::KP;
  constexpr int G = NT / K;          // row groups in phases E and F
  constexpr int RPT = Q / G > 0 ? Q / G : 1;   // y rows per thread
  static_assert(NT % K == 0 && Q % 4 == 0 && K % 4 == 0, "shapes");
  extern __shared__ __align__(16) float smem[];
  float* st = smem + L::ST;
  float* rq = smem + L::RQ;
  float* ri = smem + L::RI;
  float* ki = smem + L::KI;
  float* kt = smem + L::KT;
  float* vs = smem + L::VS;
  float* cs = smem + L::CS;
  float* at = smem + L::AT;
  float* dg = smem + L::DG;
  float* us = smem + L::US;
  float* dc = smem + L::DC;

  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int cv = tid % K;            // column owned in phases E and F
  const int g = tid / K;             // row group in phases E and F
  const size_t row_stride = (size_t)H * K;           // one time step
  const size_t base = (size_t)bi * S * row_stride + (size_t)h * K;

  for (int e = tid; e < K * K; e += NT) st[e] = 0.f;
  for (int c = tid; c < K; c += NT) us[c] = u[h * K + c];

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();   // the previous chunk's readers are done
    // A. tiles; rows past S are k = v = r = 0 and logw = 0
    for (int e = tid; e < Q * K; e += NT) {
      const int t = e / K, c = e % K;
      const bool in = t0 + t < S;
      const size_t off = base + (size_t)(t0 + t) * row_stride + c;
      ri[t * KP + c] = in ? to_f32(r[off]) : 0.f;
      ki[t * KP + c] = in ? to_f32(k[off]) : 0.f;
      vs[t * K + c] = in ? to_f32(v[off]) : 0.f;
      cs[t * KP + c] = in ? to_f32(w[off]) : 0.f;
    }
    __syncthreads();
    // B. inclusive cumsum of logw along the chunk, one thread per channel
    for (int c = tid; c < K; c += NT) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < Q; ++t) {
        acc += cs[t * KP + c];
        cs[t * KP + c] = acc;
      }
    }
    __syncthreads();
    // C. decayed tiles and the diagonal bonus, one warp per row
    for (int t = warp; t < Q; t += NWARPS) {
      float part = 0.f;
      for (int c = lane; c < K; c += 32) {
        const float cq = cs[(Q - 1) * KP + c];
        const float cu = cs[t * KP + c];
        const float ce = t > 0 ? cs[(t - 1) * KP + c] : 0.f;
        const float rr = ri[t * KP + c];
        const float kk = ki[t * KP + c];
        part = fmaf(rr * us[c], kk, part);
        rq[t * K + c] = rr * expf(ce);
        kt[c * QP + t] = kk * expf(cq - cu);
        if (t == Q - 1) dc[c] = expf(cq);
      }
      part = warp_sum(part);
      if (lane == 0) dg[t] = part;
    }
    __syncthreads();
    // D. strictly causal scores, the diagonal bonus on the diagonal; for
    // j < i, cum_excl_i = cum_{i-1} ≤ cum_j, so every exponent is ≤ 0
    for (int e = tid; e < Q * Q; e += NT) {
      const int i = e / Q, j = e % Q;
      float s = 0.f;
      if (j < i) {
        const float* ce = cs + (i - 1) * KP;
        const float* cj = cs + j * KP;
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          s = fmaf(ri[i * KP + c] * ki[j * KP + c], expf(ce[c] - cj[c]), s);
      } else if (j == i) {
        s = dg[i];
      }
      at[e] = s;
    }
    __syncthreads();
    // E. y = A·v + (r ⊙ e^{cum_excl})·S_prev for rows g, g + G, ...
    if (g < Q) {
      float acc[RPT];
#pragma unroll
      for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
#pragma unroll
      for (int j0 = 0; j0 < Q; j0 += 4) {
        float vj[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) vj[q] = vs[(j0 + q) * K + cv];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(&at[(g + G * q) * Q + j0]);
          acc[q] = fmaf(a.x, vj[0], acc[q]);
          acc[q] = fmaf(a.y, vj[1], acc[q]);
          acc[q] = fmaf(a.z, vj[2], acc[q]);
          acc[q] = fmaf(a.w, vj[3], acc[q]);
        }
      }
#pragma unroll 4
      for (int c0 = 0; c0 < K; c0 += 4) {
        float sv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) sv[q] = st[(c0 + q) * K + cv];
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const float4 a = *reinterpret_cast<const float4*>(&rq[(g + G * q) * K + c0]);
          acc[q] = fmaf(a.x, sv[0], acc[q]);
          acc[q] = fmaf(a.y, sv[1], acc[q]);
          acc[q] = fmaf(a.z, sv[2], acc[q]);
          acc[q] = fmaf(a.w, sv[3], acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int t = t0 + g + G * q;
        if (t < S) y[base + (size_t)t * row_stride + cv] = from_f32<T>(acc[q]);
      }
    }
    __syncthreads();   // every read of the previous state is done
    // F. S = diag(e^{cum_Q})·S + (k ⊙ e^{cum_Q − cum})ᵀ·v, rows g, g + G, ...
    {
      float vcol[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) vcol[j] = vs[j * K + cv];
      for (int c = g; c < K; c += G) {
        float s = st[c * K + cv] * dc[c];
#pragma unroll
        for (int j0 = 0; j0 < Q; j0 += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&kt[c * QP + j0]);
          s = fmaf(kk.x, vcol[j0], s);
          s = fmaf(kk.y, vcol[j0 + 1], s);
          s = fmaf(kk.z, vcol[j0 + 2], s);
          s = fmaf(kk.w, vcol[j0 + 3], s);
        }
        st[c * K + cv] = s;
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)bi * H + h) * K * K;
  for (int e = tid; e < K * K; e += NT) so[e] = st[e];
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* state, int B, int S, int H,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<K>::BYTES;   // 43.8 KB at K = 64
  static_assert(smem <= 48 * 1024, "needs the opt-in above 48 KB");
  dim3 grid(H, B);
  wkv6_kernel<T, K><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int K, const void* r, const void* k, const void* v,
             const void* w, const void* u, void* y, void* state, int B,
             int S, int H, cudaStream_t s) {
  switch (K) {
    case 16: return launch<T, 16>(r, k, v, w, u, y, state, B, S, H, s);
    case 32: return launch<T, 32>(r, k, v, w, u, y, state, B, S, H, s);
    case 64: return launch<T, 64>(r, k, v, w, u, y, state, B, S, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, logw and y). r/k/v/logw/y are
// (B, S, H, K), u is (H, K) f32 and state (B, H, K, K) f32, all contiguous
// on the device. Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int wkv6_launch(int dtype, const void* r, const void* k,
                           const void* v, const void* w, const void* u,
                           void* y, void* state, int B, int S, int H, int K,
                           void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(K, r, k, v, w, u, y, state, B, S, H, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(K, r, k, v, w, u, y, state, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
