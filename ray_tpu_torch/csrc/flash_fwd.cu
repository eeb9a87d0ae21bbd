// Flash-attention forward: blocked online-softmax attention, causal or not.
//
// Replaces the Pallas kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_fwd there).  Same function: out = softmax(q k^T *
// D^-1/2, masked) v in the input dtype, plus the per-row f32
// lse = m + log(l) that a backward pass needs; f32 scores and accumulators,
// l clamped at 1e-30, masked scores at -1e30 as in the JAX package.
//
// What bounds it on an H100: operations.  Causal attention does
// ~2*B*H*S^2*D FLOPs (QK^T and PV over the lower triangle) against
// 4*B*S*H*D input/output elements, far above the ~295 FLOP/byte ridge.
// What the design does about it, and what it does not do yet:
//   - the TPU kernel keeps a whole K/V row in VMEM; at S=2048, D=64, bf16
//     that is 256 KB each for K and V, more than a block's 227 KB of shared
//     memory.  So grid (B*H, ceil(Sq/64)), and each block loops over 64-row
//     K/V tiles through shared memory, stopping at the diagonal when causal;
//   - q/k/v are read in their [B, S, H, D] layout through strides, so the
//     [B*H, S, D] fold of the JAX wrapper costs no copy (a GPT-2 q/k/v that
//     is a slice of the fused qkv projection is read in place);
//   - the ragged edge (S not a multiple of 64) is masked in the kernel;
//   - each thread computes a 4x8 tile of scores and a 4x(D/8) tile of the
//     output with f32 FMAs from shared memory (padded rows keep the column
//     reads free of bank conflicts).  It does not use the tensor cores:
//     wgmma with TMA-fed tiles is the follow-up that moves it toward the
//     bound.
// D is a template parameter: 64 and 128 are built.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int RPT = BQ / 16; // query rows per thread (rows r + 16*i)
constexpr int KPT = BK / 8;  // key columns per thread (cols c + 8*j)

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1)) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out,    // [B, Sq, H, D] contiguous
    float* __restrict__ lse,  // [B*H, Sq]
    int H, int Sq, int Sk,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale) {
  constexpr int DP = D + 1;   // padded row stride of the q and k tiles
  constexpr int PP = BK + 1;  // padded row stride of the probability tile
  constexpr int CPT = D / 8;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;           // [BQ][DP], pre-scaled
  float* k_s = q_s + BQ * DP;  // [BK][DP]
  float* v_s = k_s + BK * DP;  // [BK][D]
  float* p_s = v_s + BK * D;   // [BQ][PP]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D;
    const int d = i - row * D;
    const int qi = q0 + row;
    q_s[row * DP + d] = qi < Sq ? rtt::to_f32(qb[qi * q_ss + d]) * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = rtt::NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);  // up to the diagonal

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int row = i / D;
      const int d = i - row * D;
      const int kj = k0 + row;
      const bool ok = kj < Sk;
      k_s[row * DP + d] = ok ? rtt::to_f32(kb[kj * k_ss + d]) : 0.f;
      v_s[row * D + d] = ok ? rtt::to_f32(vb[kj * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = q_s[(r + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = k_s[(c + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + r + 16 * i;
      float mx = rtt::NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = k0 + c + 8 * j;
        const bool ok = kj < Sk && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] : rtt::NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 8 threads of a row group are lanes differing in bits 0..2.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      // Tile 0 always holds key 0, which no row masks, so m is finite from
      // then on and masked scores give exp(-1e30 - m) = 0.
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float pr = expf(s[i][j] - m_new);
        p_s[(r + 16 * i) * PP + c + 8 * j] = pr;
        rs += pr;
      }
      l[i] = l[i] * alpha + rs;  // this thread's columns; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = p_s[(r + 16 * i) * PP + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = v_s[j * D + c + 8 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][cc] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li += __shfl_xor_sync(0xffffffffu, li, 4);
    li = fmaxf(li, 1e-30f);
    const int qi = q0 + r + 16 * i;
    if (qi < Sq) {
      T* ob = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) ob[c + 8 * cc] = rtt::from_f32<T>(acc[i][cc] / li);
      if (c == 0) lse[(size_t)bh * Sq + qi] = m[i] + logf(li);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
           int Sq, int Sk, const long long* qs, const long long* ks, const long long* vs,
           int causal, float scale, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), H, Sq, Sk, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out, void* lse, int B,
             int H, int Sq, int Sk, const long long* qs, const long long* ks,
             const long long* vs, int causal, float scale, void* stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, Sq, Sk, qs, ks, vs, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, Sq, Sk, qs, ks, vs, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, H, D], each with its last dim contiguous and
// the element strides of its B, S and H dims in *_strides[3].  Writes out
// [B, Sq, H, D] (contiguous) and lse [B*H, Sq] f32.  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int Sq, int Sk,
                         const long long* q_strides, const long long* k_strides,
                         const long long* v_strides, int causal, float scale, void* stream) {
  switch (dtype) {
    case rtt::kF32:
      return launch_d<float>(D, q, k, v, out, lse, B, H, Sq, Sk, q_strides, k_strides,
                             v_strides, causal, scale, stream);
    case rtt::kBF16:
      return launch_d<__nv_bfloat16>(D, q, k, v, out, lse, B, H, Sq, Sk, q_strides, k_strides,
                                     v_strides, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
