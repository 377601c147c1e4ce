// Chunked RWKV6 (WKV6) recurrence from a zero state, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6/kernel.py::wkv6_kernel (body _wkv6_kernel).
//
// What it computes, per batch b and head h, over t < S (K = head dim):
//   S_t = diag(e^{logw_t}) · S_{t-1} + k_t v_tᵀ          (S_0 = 0, K x K)
//   y_t = r_tᵀ · (S_{t-1} + diag(u) · k_t v_tᵀ)
// returning y (B, S, H, K) in r's dtype and the final state (B, H, K, K)
// in f32 [K index, V index]. Inputs are the models' layout (B, S, H, K),
// read in place: no transposes and no padding copies (the ragged tail of
// the last chunk is masked here, as k = 0, v = 0, r = 0 and logw = 0
// rows, which is what the reference wrapper pads with). r, k and v share
// one dtype (f32 or bf16); logw is f32 or that same dtype. Every operand
// is widened to f32 on load (exact for bf16), all arithmetic is f32 (no
// TF32: it would break the f32 tolerance of rel 1e-5), and y is rounded
// to r's dtype once.
//
// The algorithm is the TPU kernel's chunked form, at chunks of Q = 16
// rows; with w_t = e^{logw_t} ≤ 1 per channel,
//   y   = A · v + (r ⊙ Π_{t<i} w_t) · S_prev
//   A_ij = Σ_c r_ic k_jc Π_{j<t<i} w_tc         (j < i)
//   A_ii = Σ_c r_ic u_c k_ic                     (the diagonal bonus)
//   S   = diag(Π_t w_t) · S_prev + (k ⊙ Π_{t>j} w_t)ᵀ · v
// Each score's decay is taken per channel: Π_{j<t<i} w_tc is
// e^{cum_excl_ic − cum_jc}, a product of factors e^{logw} ≤ 1 (every
// exponent ≤ 0), so no factor can overflow at any decay (the TPU kernel
// splits it into r ⊙ e^{cum_excl} times k ⊙ e^{−cum}, and e^{−cum}
// overflows f32 once a channel's decay summed over its 128-row chunk
// passes about −88). The products underflow to 0 where the decay is
// strong, as the exact values do. The result does not depend on the chunk
// length, up to rounding.
//
// What bounds it on an H100 (SXM data sheet, 700 W): at the served shape
// (B 4, S 128, H 64, K 64; bf16 r, k, v and f32 logw, as the model calls
// it) the function needs about 5·K² f32 flops per step and head, 0.67
// GFLOP (10.0 us at 67 TFLOP/s), and moves 29 MB (8.8 us at 3.35 TB/s):
// operations bound it.
//
// Design: the value columns are independent (column j of y and of the
// state depends only on column j of v and of the state), so each block
// owns one (b, h, slice of VS value columns): grid (H·K/VS, B). Every
// block of a head recomputes the chunk's decays and its Q x Q scores
// from r, k and logw, and keeps only its K x VS slice of the state, in
// registers. The wrapper's plan (ops.py::plan) takes the whole head (VS
// = 64) once the H·B heads cover more than half of the SMs, as at
// rwkv6-7b's served prefill (B 4, 256 blocks), and half heads (VS = 32,
// twice the blocks) below that: each extra block of a head repeats the
// producers' work, which pays only while SMs would otherwise idle.
//   Only the state carries from chunk to chunk; the decays and scores of
// a chunk do not depend on it. So the block's warps are specialised and
// pipelined, with one block barrier per chunk: while the consumer warps
// take chunk c through the state, the four producer warps prepare chunk
// c + 1, and the tiles of chunk c + 2 (r, k, logw and the v slice) arrive
// by cp.async into the other raw buffer:
//   producers (128 threads; named barrier 1 between their steps):
//     P. per channel, one thread the prefix and one the suffix: w =
//        e^{logw} down the chunk, r and k in f32, r ⊙ Π_{t<i} w,
//        k ⊙ Π_{t>j} w, Π_t w; and the v slice in f32;
//     A. the scores: thread (p, g) takes rows j = p and j = 15 − p (15
//        off-diagonal steps between them, so every thread does the same
//        work) over its four channels g, carrying k_j ⊙ Π w down the rows
//        i > j (one multiply and one FMA per channel and step), all 17
//        partial sums in registers, then summed over the 16 groups by
//        recursive halving (each lane ends with one sum to store);
//   consumers (4 channel quarters x VS/(32·VT) warps; named barrier 2):
//     Y. a warp holds one quarter of the K channels and 32·VT value
//        columns (VT per lane) of the state in registers, so every
//        shared-memory read of the decayed tiles and scores is one
//        broadcast to the whole warp. Its part of (r ⊙ Π w)·S_prev for
//        the 16 rows goes through shared memory to the warp of the same
//        columns that owns those rows (quarter q owns rows 4q .. 4q + 3);
//        then the state update of its slice; then A·v for its rows, and
//        y is stored.
// The chunk-parallel alternative (every chunk's intra-chunk terms at
// once, then a short scan of the chunk states) was not built: it would
// write each chunk's K x K state to device memory and read it back (16 KB
// per chunk and head, 33 MB at the served shape, more than the 29 MB the
// function itself moves), and what it parallelises, the chunk-independent
// decays and scores, this pipeline already overlaps with the state chain.
// Timing each phase alone (tools/wkv6_phase_probe.py) chose this layout:
// a first version with two producer warps, and lanes of one warp spread
// over the four quarters (sums by shuffles), was held back by the
// producers' chain and by the consumers' shared-memory wavefronts (four
// addresses per load). What holds this one back at the
// served shape is the SMs' throughput, not a chunk step's latency: a
// chunk step takes longer at B 4 (two blocks per SM) than at B 1, and
// the producers and consumers, each fast enough alone, share the SMs'
// issue slots and shared-memory bandwidth (PERF.md, section 7).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int Q = 16;        // rows per chunk

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills them when !pred (src-size 0, the
// source is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a lane's VT neighbouring outputs of one row, in one store where VT = 2
template <int VT, typename T>
__device__ __forceinline__ void store_row(T* dst, const float (&val)[VT]) {
#pragma unroll
  for (int t = 0; t < VT; ++t) dst[t] = from_f32<T>(val[t]);
}
template <>
__device__ __forceinline__ void store_row<2, float>(float* dst, const float (&val)[2]) {
  *reinterpret_cast<float2*>(dst) = make_float2(val[0], val[1]);
}
template <>
__device__ __forceinline__ void store_row<2, __nv_bfloat16>(__nv_bfloat16* dst,
                                                           const float (&val)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(val[0], val[1]);
}

// one level of a recursive-halving sum over lanes: in[m] and in[m + N]
// pair up, and out[m] = the kept one + the partner's other one, where
// the lane with bit O set keeps in[m + N]
template <int N, int O, int M>
__device__ __forceinline__ void halve(const float (&in)[M], float (&out)[N], int lane) {
  static_assert(M >= 2 * N, "halve");
  const bool hi = lane & O;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    const float send = hi ? in[m] : in[m + N];
    out[m] = (hi ? in[m + N] : in[m]) + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

constexpr int NP = 128;      // producer threads (four warps)

__device__ __forceinline__ void producer_sync() {   // named barrier 1
  asm volatile("bar.sync 1, %0;\n" ::"n"(NP));
}
template <int N>
__device__ __forceinline__ void consumer_sync() {   // named barrier 2
  asm volatile("bar.sync 2, %0;\n" ::"n"(N));
}

// shared memory, in bytes; every array starts on a 16-byte boundary
template <typename T, typename TW, int K, int VS>
struct Smem {
  // raw tiles as they arrive, two buffers
  static constexpr size_t RI = 0;                                   // r, 2 x Q x K
  static constexpr size_t KI = RI + 2 * Q * K * sizeof(T);          // k, 2 x Q x K
  static constexpr size_t WI = KI + 2 * Q * K * sizeof(T);          // logw, 2 x Q x K
  static constexpr size_t VI = WI + 2 * Q * K * sizeof(TW);         // v slice, 2 x Q x VS
  // the producers' own, f32
  static constexpr size_t RF = VI + 2 * Q * VS * sizeof(T);         // r, Q x K
  static constexpr size_t KF = RF + Q * K * 4;                      // k, Q x K
  static constexpr size_t WE = KF + Q * K * 4;                      // e^{logw}, Q x K
  // handed to the consumers, two sets, f32
  static constexpr size_t RD = WE + Q * K * 4;                      // r ⊙ Π_{t<i} w, 2 x Q x K
  static constexpr size_t KD = RD + 2 * Q * K * 4;                  // k ⊙ Π_{t>j} w, 2 x Q x K
  static constexpr size_t VF = KD + 2 * Q * K * 4;                  // v slice, 2 x Q x VS
  static constexpr size_t AS = VF + 2 * Q * VS * 4;                 // scores, 2 x Q x Q
  static constexpr size_t DQ = AS + 2 * Q * Q * 4;                  // Π_t w, 2 x K
  // the consumers' own: partial (r ⊙ Π w)·S_prev per quarter, 4 x Q x VS
  static constexpr size_t PX = DQ + 2 * K * 4;
  static constexpr size_t BYTES = PX + 4 * Q * VS * 4;
};

template <int VS, int VT>
__host__ __device__ constexpr int consumer_threads() {   // 4 quarters x whole warps of columns
  return 4 * 32 * ((VS + 32 * VT - 1) / (32 * VT));
}

template <typename T, typename TW, int K, int VS, int VT>
__global__ void __launch_bounds__(NP + consumer_threads<VS, VT>())
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H) {
  using L = Smem<T, TW, K, VS>;
  constexpr int CQ = K / 4;          // channels per consumer quarter
  constexpr int G = K / 4 < 16 ? K / 4 : 16;   // channel groups of the scores
  constexpr int CG = K / G;          // channels per score thread
  constexpr int NC = CG / 4;         // its float4 chunks
  constexpr int RC = K * (int)sizeof(T) / 16;    // 16-byte chunks per r/k row
  constexpr int WC = K * (int)sizeof(TW) / 16;   // per logw row
  constexpr int VC = VS * (int)sizeof(T) / 16;   // per v-slice row
  constexpr int NCT = consumer_threads<VS, VT>();
  static_assert(K % VS == 0 && CG % 4 == 0 && CQ % 4 == 0 && 8 * G <= NP && 2 * K <= NP,
                "shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ri = reinterpret_cast<T*>(smem + L::RI);
  T* ki = reinterpret_cast<T*>(smem + L::KI);
  TW* wi = reinterpret_cast<TW*>(smem + L::WI);
  T* vi = reinterpret_cast<T*>(smem + L::VI);
  float* rf = reinterpret_cast<float*>(smem + L::RF);
  float* kf = reinterpret_cast<float*>(smem + L::KF);
  float* we = reinterpret_cast<float*>(smem + L::WE);
  float* rd = reinterpret_cast<float*>(smem + L::RD);
  float* kd = reinterpret_cast<float*>(smem + L::KD);
  float* vf = reinterpret_cast<float*>(smem + L::VF);
  float* as = reinterpret_cast<float*>(smem + L::AS);
  float* dq = reinterpret_cast<float*>(smem + L::DQ);
  float* px = reinterpret_cast<float*>(smem + L::PX);

  constexpr int SLICES = K / VS;
  const int h = blockIdx.x / SLICES;
  const int v0 = (blockIdx.x % SLICES) * VS;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t row_stride = (size_t)H * K;           // one time step
  const size_t base = (size_t)bi * S * row_stride + (size_t)h * K;
  const int nchunks = (S + Q - 1) / Q;

  // the upper triangles of both score sets (never written) stay 0
  for (int e = tid; e < 2 * Q * Q; e += blockDim.x)
    if (e % Q > (e / Q) % Q) as[e] = 0.f;

  if (tid < NP) {
    // ---------------------------------------------------------------- producers
    auto load = [&](int ci) {   // chunk ci's raw tiles into buffer ci & 1
      const int t0 = ci * Q, buf = ci & 1;
      // one 16-byte unit per copy: row t, unit ch of an n-unit row
      auto tile = [&](auto* dst, const auto* src, int n, int col0, int width) {
        constexpr int E = 16 / sizeof(*src);
        for (int e = tid; e < Q * n; e += NP) {
          const int t = e / n, ch = e % n;
          cp_async16(dst + (buf * Q + t) * width + ch * E,
                     src + base + (size_t)min(t0 + t, S - 1) * row_stride + col0 + ch * E,
                     t0 + t < S);   // rows past S are zeros
        }
      };
      tile(ri, r, RC, 0, K);
      tile(ki, k, RC, 0, K);
      tile(wi, w, WC, 0, K);
      tile(vi, v, VC, v0, VS);
    };
    const int p = tid / G, g = tid % G;   // score thread: row pair, channel group
    float uc[CG];                         // u on its channels
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) uc[4 * n + e] = u[h * K + 4 * (g + G * n) + e];

    load(0);
    cp_async_commit();
    if (nchunks > 1) load(1);
    cp_async_commit();
    for (int ci = 0; ci < nchunks; ++ci) {   // prepare chunk ci
      const int buf = ci & 1;
      cp_async_wait<1>();   // chunk ci's copies (chunk ci + 1's may fly)
      producer_sync();
      const T* rb = ri + buf * Q * K;
      const T* kb = ki + buf * Q * K;
      const TW* wb = wi + buf * Q * K;
      // P. per channel: the prefix (threads x < K) or the suffix
      for (int x = tid; x < 2 * K; x += NP) {
        const int c = x % K;
        float wv[Q];
#pragma unroll
        for (int t = 0; t < Q; ++t) wv[t] = exp2f(to_f32(wb[t * K + c]) * 1.4426950408889634f);
        if (x < K) {
          float pre = 1.f;
#pragma unroll
          for (int t = 0; t < Q; ++t) {
            const float rr = to_f32(rb[t * K + c]);
            rf[t * K + c] = rr;
            we[t * K + c] = wv[t];
            rd[(buf * Q + t) * K + c] = rr * pre;
            pre *= wv[t];
          }
          dq[buf * K + c] = pre;
        } else {
          float suf = 1.f;
#pragma unroll
          for (int t = Q - 1; t >= 0; --t) {
            const float kk = to_f32(kb[t * K + c]);
            kf[t * K + c] = kk;
            kd[(buf * Q + t) * K + c] = kk * suf;
            suf *= wv[t];
          }
        }
      }
      for (int e = tid; e < Q * VS; e += NP) vf[buf * Q * VS + e] = to_f32(vi[buf * Q * VS + e]);
      producer_sync();
      if (ci + 2 < nchunks) load(ci + 2);   // this buffer is free now
      cp_async_commit();

      // A. scores: rows j = p and j = Q − 1 − p
      if (tid < 8 * G) {
        float e[CG];
        float part[Q + 1];
        auto load_k = [&](int j) {
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float4 a = *reinterpret_cast<const float4*>(&kf[j * K + 4 * (g + G * n)]);
            e[4 * n] = a.x;
            e[4 * n + 1] = a.y;
            e[4 * n + 2] = a.z;
            e[4 * n + 3] = a.w;
          }
        };
        auto dot_r = [&](int i) {
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float4 a = *reinterpret_cast<const float4*>(&rf[i * K + 4 * (g + G * n)]);
            s = fmaf(a.x, e[4 * n], s);
            s = fmaf(a.y, e[4 * n + 1], s);
            s = fmaf(a.z, e[4 * n + 2], s);
            s = fmaf(a.w, e[4 * n + 3], s);
          }
          return s;
        };
        // the two diagonal bonuses, Σ_c r_jc u_c k_jc
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          load_k(jj ? Q - 1 - p : p);
#pragma unroll
          for (int c = 0; c < CG; ++c) e[c] *= uc[c];
          part[Q - 1 + jj] = dot_r(jj ? Q - 1 - p : p);
        }
        // 15 steps: (i, p) for i = p + 1 .. Q − 1, then (i, Q − 1 − p)
        // for i = Q − p .. Q − 1, which is i = step + 1
        load_k(p);
#pragma unroll
        for (int step = 0; step < Q - 1; ++step) {
          if (step == Q - 1 - p) load_k(Q - 1 - p);
          const int i = step < Q - 1 - p ? p + 1 + step : step + 1;
          part[step] = dot_r(i);
#pragma unroll
          for (int n = 0; n < NC; ++n) {
            const float4 d = *reinterpret_cast<const float4*>(&we[i * K + 4 * (g + G * n)]);
            e[4 * n] *= d.x;
            e[4 * n + 1] *= d.y;
            e[4 * n + 2] *= d.z;
            e[4 * n + 3] *= d.w;
          }
        }
        // the sums over the G groups: part[Q] (row Q − 1 − p's bonus) by a
        // butterfly, parts 0 .. Q − 1 by recursive halving, after which
        // slot m of lane g holds the sum of part (Q/G)·g + m
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) part[Q] += __shfl_xor_sync(0xffffffffu, part[Q], o);
        // level by level: lanes o apart pair up, the lane with bit o set
        // keeps the upper half of the values (in new arrays, so that every
        // index is known at compile time)
        float h8[8], h4[4], h2[2], h1[1];
        halve<8, G / 2>(part, h8, g);
        halve<4, G / 4>(h8, h4, g);
        if constexpr (G >= 8) halve<2, G / 8>(h4, h2, g);
        if constexpr (G >= 16) halve<1, G / 16>(h2, h1, g);
        (void)h1;
        (void)h2;
        float* a = as + buf * Q * Q;
        auto put = [&](int m, float val) {   // part m's (i, j)
          const int j = m == Q - 1 ? p : m == Q ? Q - 1 - p : m < Q - 1 - p ? p : Q - 1 - p;
          const int i = m >= Q - 1 ? j : m < Q - 1 - p ? p + 1 + m : m + 1;
          a[i * Q + j] = val;
        };
        if constexpr (G >= 16) {
          put(g, h1[0]);
        } else if constexpr (G >= 8) {
          put(2 * g, h2[0]);
          put(2 * g + 1, h2[1]);
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m) put(4 * g + m, h4[m]);
        }
        if (g == 0) put(Q, part[Q]);
      }
      __syncthreads();   // chunk ci is ready; the consumers are done with ci − 1
    }
    cp_async_wait<0>();
  } else {
    // ---------------------------------------------------------------- consumers
    const int cw = (tid - NP) / 32;           // consumer warp
    const int cq = cw % 4;                    // its channel quarter
    const int vc = ((cw / 4) * 32 + (tid % 32)) * VT;   // first value column
    // lanes past the slice idle (none where the slice fills whole warps)
    const bool cols = VS % (32 * VT) == 0 || vc < VS;
    float st[VT][CQ];                         // state rows cq·CQ .., columns vc ..
#pragma unroll
    for (int t = 0; t < VT; ++t)
#pragma unroll
      for (int c = 0; c < CQ; ++c) st[t][c] = 0.f;

    for (int ci = 0; ci < nchunks; ++ci) {   // chunk ci through the state
      __syncthreads();   // chunk ci is ready
      const int buf = ci & 1, t0 = ci * Q;
      const float* rds = rd + buf * Q * K + cq * CQ;
      const float* kds = kd + buf * Q * K + cq * CQ;
      // Y. this quarter's part of (r ⊙ Π w)·S_prev, all 16 rows, to px:
      // eight rows at a time, channels outermost, so 8·VT sums advance
      // side by side
#pragma unroll
      for (int i0 = 0; i0 < Q; i0 += 8) {
        float yp[VT][8];
#pragma unroll
        for (int t = 0; t < VT; ++t)
#pragma unroll
          for (int i = 0; i < 8; ++i) yp[t][i] = 0.f;
#pragma unroll
        for (int c = 0; c < CQ; c += 4) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(&rds[(i0 + i) * K + c]);
#pragma unroll
            for (int t = 0; t < VT; ++t) {
              yp[t][i] = fmaf(a.x, st[t][c], yp[t][i]);
              yp[t][i] = fmaf(a.y, st[t][c + 1], yp[t][i]);
              yp[t][i] = fmaf(a.z, st[t][c + 2], yp[t][i]);
              yp[t][i] = fmaf(a.w, st[t][c + 3], yp[t][i]);
            }
          }
        }
        if (cols)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int t = 0; t < VT; ++t) px[(cq * Q + i0 + i) * VS + vc + t] = yp[t][i];
      }
      float vcol[VT][Q];
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int t = 0; t < VT; ++t) vcol[t][j] = cols ? vf[(buf * Q + j) * VS + vc + t] : 0.f;
      // the state update of this slice; rows outermost, so the CQ·VT sums
      // advance side by side
#pragma unroll
      for (int c = 0; c < CQ; c += 4) {
        const float4 d = *reinterpret_cast<const float4*>(&dq[buf * K + cq * CQ + c]);
#pragma unroll
        for (int t = 0; t < VT; ++t) {
          st[t][c] *= d.x;
          st[t][c + 1] *= d.y;
          st[t][c + 2] *= d.z;
          st[t][c + 3] *= d.w;
        }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
#pragma unroll
        for (int c = 0; c < CQ; c += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(&kds[j * K + c]);
#pragma unroll
          for (int t = 0; t < VT; ++t) {
            st[t][c] = fmaf(kk.x, vcol[t][j], st[t][c]);
            st[t][c + 1] = fmaf(kk.y, vcol[t][j], st[t][c + 1]);
            st[t][c + 2] = fmaf(kk.z, vcol[t][j], st[t][c + 2]);
            st[t][c + 3] = fmaf(kk.w, vcol[t][j], st[t][c + 3]);
          }
        }
      }
      consumer_sync<NCT>();   // every quarter's part is in px
      // rows 4·cq .. 4·cq + 3: the four parts, A·v, and the store
      const float* a = as + buf * Q * Q;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = 4 * cq + n;
        float yo[VT];
#pragma unroll
        for (int t = 0; t < VT; ++t) {
          yo[t] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) yo[t] += cols ? px[(q * Q + i) * VS + vc + t] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < Q; j += 4) {
          const float4 aa = *reinterpret_cast<const float4*>(&a[i * Q + j]);
#pragma unroll
          for (int t = 0; t < VT; ++t) {
            yo[t] = fmaf(aa.x, vcol[t][j], yo[t]);
            yo[t] = fmaf(aa.y, vcol[t][j + 1], yo[t]);
            yo[t] = fmaf(aa.z, vcol[t][j + 2], yo[t]);
            yo[t] = fmaf(aa.w, vcol[t][j + 3], yo[t]);
          }
        }
        if (cols && t0 + i < S) store_row<VT>(y + base + (size_t)(t0 + i) * row_stride + v0 + vc, yo);
      }
    }
    if (cols) {
      float* so = state_out + ((size_t)bi * H + h) * K * K + v0 + vc;
#pragma unroll
      for (int c = 0; c < CQ; ++c)
#pragma unroll
        for (int t = 0; t < VT; ++t) so[(size_t)(cq * CQ + c) * K + t] = st[t][c];
    }
  }
}

template <typename T, typename TW, int K, int VS, int VT>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, void* y, void* state, int B, int S, int H,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<T, TW, K, VS>::BYTES;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(wkv6_kernel<T, TW, K, VS, VT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(H * (K / VS), B);
  wkv6_kernel<T, TW, K, VS, VT><<<grid, NP + consumer_threads<VS, VT>(), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<T*>(y),
      static_cast<float*>(state), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TW>
int dispatch(int K, int VS, int VT, const void* r, const void* k, const void* v,
             const void* w, const void* u, void* y, void* state, int B,
             int S, int H, cudaStream_t s) {
  if (K == 16 && VS == 16 && VT == 1)
    return launch<T, TW, 16, 16, 1>(r, k, v, w, u, y, state, B, S, H, s);
  if (K == 32 && VS == 32 && VT == 1)
    return launch<T, TW, 32, 32, 1>(r, k, v, w, u, y, state, B, S, H, s);
  if (K == 64 && VS == 32 && VT == 1)
    return launch<T, TW, 64, 32, 1>(r, k, v, w, u, y, state, B, S, H, s);
  if (K == 64 && VS == 64 && VT == 2)
    return launch<T, TW, 64, 64, 2>(r, k, v, w, u, y, state, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename TW>
int smem_of(int K, int VS) {
  if (K == 16 && VS == 16) return (int)Smem<T, TW, 16, 16>::BYTES;
  if (K == 32 && VS == 32) return (int)Smem<T, TW, 32, 32>::BYTES;
  if (K == 64 && VS == 32) return (int)Smem<T, TW, 64, 32>::BYTES;
  if (K == 64 && VS == 64) return (int)Smem<T, TW, 64, 64>::BYTES;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and y); wdtype: the same codes
// for logw, which is f32 or r's dtype. r/k/v/logw/y are (B, S, H, K), u is
// (H, K) f32 and state (B, H, K, K) f32, all contiguous on the device and
// 16-byte aligned. VS: value columns per block; VT: per consumer thread
// (the (K, VS, VT) cases of dispatch). Returns cudaGetLastError() after
// the launch (0 = ok).
extern "C" int wkv6_launch(int dtype, int wdtype, const void* r, const void* k,
                           const void* v, const void* w, const void* u,
                           void* y, void* state, int B, int S, int H, int K,
                           int VS, int VT, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && wdtype == 0)
    return dispatch<float, float>(K, VS, VT, r, k, v, w, u, y, state, B, S, H, s);
  if (dtype == 1 && wdtype == 1)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(K, VS, VT, r, k, v, w, u, y, state, B, S, H, s);
  if (dtype == 1 && wdtype == 0)
    return dispatch<__nv_bfloat16, float>(K, VS, VT, r, k, v, w, u, y, state, B, S, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the (dtype, wdtype, K, VS) case,
// in bytes (0 for a case that is not built).
extern "C" int wkv6_smem_bytes(int dtype, int wdtype, int K, int VS) {
  if (dtype == 0 && wdtype == 0) return smem_of<float, float>(K, VS);
  if (dtype == 1 && wdtype == 1) return smem_of<__nv_bfloat16, __nv_bfloat16>(K, VS);
  if (dtype == 1 && wdtype == 0) return smem_of<__nv_bfloat16, float>(K, VS);
  return 0;
}

extern "C" const char* wkv6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
