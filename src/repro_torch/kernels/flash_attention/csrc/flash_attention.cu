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
// counterpart). Output is in the input dtype. Under the causal mask or a
// window both kernels visit only kv tiles that hold a visible key;
// skipping a fully masked tile is exact (it leaves m, l and acc unchanged).
//
// Two kernels behind one launch function, one per dtype; the wrapper
// (ops.py::variant) names the one it takes:
//
// fa_mma_kernel — bf16, the tensor-core route (FlashAttention-2's design
// on mma.sync.m16n8k16, bf16 in, f32 accumulate). Each warp owns 16 query
// rows of one head. Q is staged once through shared memory and held in
// registers as A fragments (ldmatrix). K and V tiles of 64 keys arrive by
// cp.async into a double-buffered ring (tile t + 1 loads while tile t
// computes); rows are padded by 16 bytes, so ldmatrix reads them free of
// bank conflicts. S = Q·Kᵀ stays in f32 accumulator fragments; the online
// softmax works on them (row max and row sum by quad shuffles, m and l in
// registers, exp2 on pre-scaled scores). P is rounded to bf16 in registers
// and fed straight into P·V as the A operand, with V's B fragments from
// ldmatrix.trans; P never goes through shared memory. Rounding p to bf16
// before P·V is a rounding the SIMT kernel does not make (FlashAttention
// and SDPA make it too): l sums the unrounded p, and the result stays
// within the bf16 tolerance (max abs < 2e-2 at |o| < 4).
//   Grid: (ceil(Sq / (16·tiles)), H, B) with `tiles` warps per block: a
// block takes `tiles` consecutive 16-row q tiles of one query head, and
// its warps share each K and V tile. The wrapper's plan (ops.py::plan)
// takes 64-row blocks (tiles = 4; fewer where the prompt is shorter): at
// qwen2-0.5b's prefill (B 4, S 128, H 14, Hkv 2, D 64) that is 112 blocks
// of 4 warps on 132 SMs. Timed on an NVIDIA H100 80GB HBM3 at 700 W, it
// beat 16- and 32-row blocks (448 and 224 blocks: more blocks, each
// loading its K and V again), a 128-row block, and a whole GQA group of 7
// heads per block (K and V loaded once per group) at every length from
// S 100 to 2048 (PERF.md, Findings). What bounds it at the served shape
// (H100 SXM data sheet, 700 W): 2 MB of bytes (0.6 us at 3.35 TB/s) and
// 0.12 GFLOP (0.1 us at 989 TFLOP/s); launch and the latency of the first
// loads dominate.
//
// Head dim 256 (gemma-7b's and paligemma-3b's) runs on both. In
// fa_mma_kernel a thread's O accumulator is then acc[32][4], 128 f32
// registers, beside s[8][4]; Q's A fragments would take 64 more (qf[16][4])
// and push a 128-thread block past the 255 registers a thread may hold, so
// at D 256 they are not kept resident: each k-step of Q·Kᵀ reloads its
// fragment from the Q rows, which stay in shared memory for the block's
// life (one ldmatrix.x4 per k-step and kv tile). Its shared memory at 4
// tiles is (64 + 4·64) rows x 264 x 2 B = 168,960 B, one block per SM,
// inside the 227 KB opt-in; fa_kernel's is 102,528 B.
//
// Head dim 80 (zamba2-2.7b's shared block) runs on both. In
// fa_mma_kernel a row is 10 16-byte chunks (CH 10), Q·Kᵀ takes 5 k-steps
// and P·V 10 n8 tiles (five ldmatrix.x4.trans); none of these loops needs
// a power of two. Its rows are padded to 88 elements, a 176-byte stride
// (44 words): the 8 rows of an ldmatrix phase start at banks 0, 12, 24,
// 4, 16, 28, 8, 20, so their 16-byte reads stay free of conflicts. In
// fa_kernel a lane holds columns lane, lane + 32 and lane + 64; the
// last group is half used (lanes 16 .. 31 hold no column there).
//
// Head dim 16 (the reduced ViT's) runs on both: in fa_mma_kernel Q·Kᵀ
// is one m16n8k16 k-step and P·V two n8 tiles (one ldmatrix.x4.trans),
// with 32-byte rows padded to 48 bytes, whose 8-row ldmatrix phases
// still fall on distinct banks; in fa_kernel lanes 16 .. 31 hold no
// output column.
//
// fa_kernel — SIMT f32 FMA (the first port's kernel), for f32: tensor
// cores take f32 only as TF32, which breaks the f32 tolerance of 2e-5.
// Grid
// (ceil(Sq/32), H, B); one block of 4 warps owns 32 query rows, 8 per
// warp; m, l and the output accumulator stay in registers (lane j holds
// columns j, j+32, ...). Per 32-key block: K and V tiles are staged in
// shared memory as f32 (K rows padded by one float), each lane scores one
// key, warp shuffles give the row max and sum, and p goes through a
// per-warp shared row into the P·V product.
//
// Both kernels load 16-byte units or f32 scalars from 16-byte aligned
// operands; the wrapper copies a view that starts off a 16-byte boundary.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

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

// ---------------------------------------------------------------------------
// fa_mma_kernel: bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_BK = 64;          // keys per kv tile
constexpr int MMA_MAX_TILES = 4;    // 16-row q tiles (warps) per block

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) · b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr size_t mma_smem_bytes(int tiles) {
  // Q rows of every warp, then the K and V rings; rows padded by 8 bf16
  return sizeof(__nv_bfloat16) * (size_t)(tiles * 16 + 4 * MMA_BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(MMA_MAX_TILES * 32)
fa_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              int Sq, int Sk, int H, int Hkv, float scale_log2, int causal,
              int window, int tiles) {
  using bf16 = __nv_bfloat16;
  constexpr int LD = D + 8;          // shared row stride (elements)
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int KSTEPS = D / 16;     // k-steps of Q·Kᵀ
  constexpr int NS = MMA_BK / 8;     // n-tiles of S
  constexpr int NO = D / 8;          // n-tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // tiles*16 x LD
  bf16* ks = qs + tiles * 16 * LD;                // 2 x BK x LD
  bf16* vs = ks + 2 * MMA_BK * LD;                // 2 x BK x LD

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;   // mma fragment row / column pair
  const int nthr = blockDim.x;
  const int rows = tiles * 16;
  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int bi = blockIdx.z;
  const int qw0 = q0 + warp * 16;               // this warp's first q row

  // Q rows of every warp (zero past Sq)
  for (int c = threadIdx.x; c < rows * CH; c += nthr) {
    const int wr = c / CH, ch = c % CH;
    const int qi = q0 + wr;
    const bool in = qi < Sq;
    const bf16* src = q + ((size_t)(bi * Sq + (in ? qi : 0)) * H + h) * D + ch * 8;
    cp_async16(qs + wr * LD + ch * 8, src, in);
  }

  // the kv tiles holding a key visible to some row of the block
  const int off = Sk - Sq;
  const int q_first = q0 + off;
  const int q_last = min(q0 + rows, Sq) - 1 + off;
  const int kv_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_lo = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_lo = kv_lo / MMA_BK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + MMA_BK - 1) / MMA_BK : t_lo;

  auto load_kv = [&](int t, int buf) {
    const int k0 = t * MMA_BK;
    for (int c = threadIdx.x; c < MMA_BK * CH; c += nthr) {
      const int kr = c / CH, ch = c % CH;
      const int kj = k0 + kr;
      const bool in = kj < Sk;
      const size_t src = ((size_t)(bi * Sk + (in ? kj : 0)) * Hkv + hk) * D + ch * 8;
      cp_async16(ks + (buf * MMA_BK + kr) * LD + ch * 8, k + src, in);
      cp_async16(vs + (buf * MMA_BK + kr) * LD + ch * 8, v + src, in);
    }
  };
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // this warp's rows: fragment rows g and g + 8 sit at q positions qa, qa + 8
  const int qa = qw0 + g + off;
  const int w_last = min(qw0 + 16, Sq) - 1 + off;   // < qw0 + off: no rows
  const bool w_rows = qw0 < Sq;

  // Q's A fragments: resident in registers up to D 128, re-read from
  // shared memory at each k-step at D 256 (see the header)
  constexpr bool Q_RESIDENT = D <= 128;
  const bf16* qbase = qs + (warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD + 8 * (lane / 16);
  uint32_t qf[Q_RESIDENT ? KSTEPS : 1][4];
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t + 1 < t_hi) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // Q and tile t have landed
    __syncthreads();
    if constexpr (Q_RESIDENT) {
      if (t == t_lo) {
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) ldmatrix_x4(qf[kk], qbase + kk * 16);
      }
    }
    const int k0 = t * MMA_BK;
    const bool skip = !w_rows || (causal && k0 > w_last) ||
                      (window > 0 && k0 + MMA_BK - 1 <= qw0 + off - window);
    if (!skip) {
      const bf16* kt = ks + buf * MMA_BK * LD;
      const bf16* vt = vs + buf * MMA_BK * LD;
      // S = Q·Kᵀ: per pair of n-tiles, one ldmatrix.x4 gives both B fragments
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      auto qk_step = [&](const uint32_t(&qa)[4], int kk) {
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t b[4];
          ldmatrix_x4(b, kt + (n * 8 + (lane % 8) + 8 * (lane / 16)) * LD + kk * 16 +
                             8 * ((lane / 8) % 2));
          mma_bf16(s[n], qa, b[0], b[1]);
          mma_bf16(s[n + 1], qa, b[2], b[3]);
        }
      };
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        if constexpr (Q_RESIDENT) {
          qk_step(qf[kk], kk);
        } else {
          uint32_t qr[4];
          ldmatrix_x4(qr, qbase + kk * 16);
          qk_step(qr, kk);
        }
      }
      // scale into log2 units; mask only tiles that straddle an edge
      const bool full = k0 + MMA_BK <= Sk && (!causal || k0 + MMA_BK - 1 <= qw0 + off) &&
                        (window <= 0 || k0 > w_last - window);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (!full) {
            const int kpos = k0 + n * 8 + 2 * tq + (e & 1);
            const int qpos = qa + 8 * (e >> 1);
            const bool keep = kpos < Sk && (!causal || kpos <= qpos) &&
                              (window <= 0 || kpos > qpos - window);
            x = keep ? x : -INFINITY;
          }
          s[n][e] = x;
        }
      }
      // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (e = 2, 3)
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < NS; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * rh], s[n][2 * rh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rh], mx);
        // a row with no visible key yet keeps m = -inf: subtract 0 there,
        // so its p = exp2(-inf) = 0 exactly
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[rh] - m_use);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float p0 = exp2f(s[n][2 * rh] - m_use);
          const float p1 = exp2f(s[n][2 * rh + 1] - m_use);
          s[n][2 * rh] = p0;
          s[n][2 * rh + 1] = p1;
          sum += p0 + p1;
        }
        l[rh] = l[rh] * corr + sum;   // this thread's columns; quad-summed at the end
        m[rh] = m_new;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * rh] *= corr;
          acc[n][2 * rh + 1] *= corr;
        }
      }
      // O += P·V: P's accumulator fragments are the A fragments of P·V
#pragma unroll
      for (int kk = 0; kk < MMA_BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vt + (kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD +
                                   n * 8 + 8 * (lane / 16));
          mma_bf16(acc[n], a, b[0], b[1]);
          mma_bf16(acc[n + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }
  cp_async_wait<0>();   // no copy outlives the block (none is pending
                        // unless the block had no tile to visit)

  if (!w_rows) return;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float den = l[rh];
    den += __shfl_xor_sync(0xffffffffu, den, 1);
    den += __shfl_xor_sync(0xffffffffu, den, 2);
    const float inv = 1.f / fmaxf(den, 1e-30f);
    const int qi = qw0 + g + 8 * rh;
    if (qi >= Sq) continue;
    bf16* dst = o + ((size_t)(bi * Sq + qi) * H + h) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(acc[n][2 * rh] * inv, acc[n][2 * rh + 1] * inv);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Sk, int H, int Hkv, float sm_scale, int causal,
               int window, int tiles, cudaStream_t stream) {
  if (tiles < 1 || tiles > MMA_MAX_TILES) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mma_smem_bytes<D>(tiles);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows = tiles * 16;
  dim3 grid((Sq + rows - 1) / rows, H, B);
  fa_mma_kernel<D><<<grid, tiles * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk,
      H, Hkv, sm_scale * 1.4426950408889634f, causal, window, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fa_kernel: SIMT f32 FMA
// ---------------------------------------------------------------------------

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per kv step (one per lane)
constexpr int NWARPS = 4;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
          int Hkv, float sm_scale, int causal, int window) {
  // output columns per lane: lane j holds columns j, j + 32, ...; at
  // D 16 one column, on lanes 0 .. 15 only (the rest skip P·V and store)
  constexpr int NJ = (D + 31) / 32;
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
  const float* qp = q + (size_t)bi * Sq * q_stride + (size_t)h * D;
  const float* kp = k + (size_t)bi * Sk * kv_stride + (size_t)hk * D;
  const float* vp = v + (size_t)bi * Sk * kv_stride + (size_t)hk * D;
  float* op = o + (size_t)bi * Sq * q_stride + (size_t)h * D;

  for (int i = threadIdx.x; i < BQ * D; i += NWARPS * 32) {
    const int rr = i / D, d = i % D;
    const int qi = q0 + rr;
    qs[i] = qi < Sq ? qp[(size_t)qi * q_stride + d] : 0.f;
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
      ks[kk * (D + 1) + d] = in ? kp[(size_t)kj * kv_stride + d] : 0.f;
      vs[kk * D + d] = in ? vp[(size_t)kj * kv_stride + d] : 0.f;
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
        const int col = lane + 32 * j;
        if (D % 32 != 0 && col >= D) continue;
        float a = acc[rr][j] * corr;
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(ps[row * BK + kk], vs[kk * D + col], a);
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
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (D % 32 == 0 || col < D) op[(size_t)qi * q_stride + col] = acc[rr][j] / den;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int Hkv, float sm_scale, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, Hkv, sm_scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Sk, int H, int Hkv, float sm_scale,
             int causal, int window, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    case 256: return launch<256>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch_mma(int D, const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Sk, int H, int Hkv, float sm_scale,
                 int causal, int window, int tiles, cudaStream_t s) {
  switch (D) {
    case 16: return launch_mma<16>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    case 32: return launch_mma<32>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    case 64: return launch_mma<64>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    case 80: return launch_mma<80>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    case 128: return launch_mma<128>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    case 256: return launch_mma<256>(q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// variant: 0 = SIMT (fa_kernel, float32), 1 = tensor cores (fa_mma_kernel,
// bfloat16). q/o are (B, Sq, H, D) and k/v are (B, Sk, Hkv, D), contiguous
// on the device, every pointer 16-byte aligned. window <= 0 means none.
// tiles: 16-row q tiles per mma block, 1 .. 4 (ignored by the SIMT kernel).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int flash_attention_launch(int variant, const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      float sm_scale, int causal, int window,
                                      int tiles, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dispatch_mma(D, q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, tiles, s);
  if (variant == 0)
    return dispatch(D, q, k, v, o, B, Sq, Sk, H, Hkv, sm_scale, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block, in bytes: variant 1 with `tiles`
// warps, or variant 0 (tiles ignored); 0 for a head dim the kernels do
// not take.
extern "C" int flash_attention_smem_bytes(int variant, int D, int tiles) {
  switch (D) {
    case 16: return (int)(variant ? mma_smem_bytes<16>(tiles) : smem_bytes<16>());
    case 32: return (int)(variant ? mma_smem_bytes<32>(tiles) : smem_bytes<32>());
    case 64: return (int)(variant ? mma_smem_bytes<64>(tiles) : smem_bytes<64>());
    case 80: return (int)(variant ? mma_smem_bytes<80>(tiles) : smem_bytes<80>());
    case 128: return (int)(variant ? mma_smem_bytes<128>(tiles) : smem_bytes<128>());
    case 256: return (int)(variant ? mma_smem_bytes<256>(tiles) : smem_bytes<256>());
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
