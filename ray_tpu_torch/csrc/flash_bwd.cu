// Flash-attention backward: the dQ kernel and the dK/dV kernel.
//
// Replace the Pallas kernels ray_tpu/ops/attention.py:_flash_dq_kernel and
// _flash_dkv_kernel (launched by _flash_bwd there).  Same recipe, which
// needs no atomics and is deterministic: both kernels recompute the
// probabilities P = exp(S * D^-1/2, masked, - lse) from the forward's saved
// per-row f32 lse, with delta = rowsum(dO * O) computed outside (by the
// wrapper, as the JAX package computes it outside Pallas), and
//   dS = P * (dO V^T - delta)
//   dQ = D^-1/2 * dS K                (flash_dq)
//   dV = P^T dO,  dK = D^-1/2 * dS^T Q  (flash_dkv)
// with the scale applied once, at the end, as the JAX kernels apply it.
// Scores, P, dS and the accumulators stay in f32 (the JAX kernels round P
// and dS to bf16 before their matmuls; the plain versions beside these
// kernels do so too, so bf16 is compared at a relative tolerance).
//
// What bounds them on an H100: operations.  Over the live (query, key)
// pairs dQ does three matmuls (QK^T, dO V^T, dS K: 6*D FLOPs a pair) and
// dK/dV four (8*D), against ~7 B*S*H*D elements read and written, far
// above the ~295 FLOP/byte ridge.  What the design does about it, and what
// it does not do yet:
//   - the TPU kernels hold whole K/V (dQ) or Q/dO (dK/dV) rows in VMEM; a
//     block's 227 KB of shared memory does not hold them at S=2048.  So dQ
//     runs on grid (B*H, ceil(Sq/64)), each block holding its Q, dO, lse
//     and delta rows and walking 64-row K/V tiles up to the diagonal; dK/dV
//     runs on grid (B*H, ceil(Sk/64)), each block holding its K and V rows
//     and walking 64-row Q/dO tiles from the diagonal tile to the end;
//   - tiles are f32 in shared memory (rows padded to D+1 so column reads
//     are free of bank conflicts): at D=128, dK/dV holds K, V, Q and dO
//     (132 KB) plus the P and dS tiles (33 KB);
//   - q/k/v/dO are read in their [B, S, H, D] layout through strides, so
//     GPT-2's slices of the fused qkv are read in place; dq/dk/dv are
//     written contiguous [B, S, H, D];
//   - the ragged edge (S not a multiple of 64) is masked: keys past Sk and
//     queries past Sq get P = 0 (a query row past Sq has no lse, and an
//     exp(s - garbage) there would put inf * 0 = NaN into dK/dV);
//   - each thread computes a 4x8 tile of scores and a 4x(D/8) tile of its
//     output with f32 FMAs from shared memory.  It does not use the tensor
//     cores: wgmma on TMA-fed bf16 tiles is the follow-up.
// D is a template parameter: 64 and 128 are built.

#include "common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per tile
constexpr int BK = 64;       // key rows per tile
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int RPT = 4;       // tile rows per thread (rows r + 16*i)
constexpr int CPT_S = 8;     // score columns per thread (cols c + 8*j)

// Element strides of the B, S and H dims of a [B, S, H, D] tensor whose
// last dim is contiguous.
struct BSH {
  long long b, s, h;
};

// rows [row0, row0 + 64) of one (b, h) slice into a [64][D+1] f32 tile;
// rows at or past n are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int row = i / D;
    const int d = i - row * D;
    const int gi = row0 + row;
    dst[row * (D + 1) + d] = gi < n ? rtt::to_f32(src[gi * row_stride + d]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(4 * 64 * (D + 1) + 2 * BK * (BQ + 1) + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,  // [B*H, Sq]
    T* __restrict__ dq,               // [B, Sq, H, D] contiguous
    int H, int Sq, int Sk, BSH qs, BSH ks, BSH vs, BSH dos, int causal, float scale) {
  constexpr int DP = D + 1;   // padded row stride of the q/do/k/v tiles
  constexpr int PP = BK + 1;  // padded row stride of the dS tile
  constexpr int CPT = D / 8;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [BQ][DP]
  float* do_s = q_s + BQ * DP;   // [BQ][DP]
  float* k_s = do_s + BQ * DP;   // [BK][DP]
  float* v_s = k_s + BK * DP;    // [BK][DP]
  float* ds_s = v_s + BK * DP;   // [BQ][PP]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int r = tid / 8;
  const int c = tid % 8;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  load_tile<T, D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<T, D>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);

  float lse_r[RPT], delta_r[RPT], acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + r + 16 * i;
    lse_r[i] = qi < Sq ? lse[(size_t)bh * Sq + qi] : 0.f;
    delta_r[i] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);  // up to the diagonal

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's readers of k_s/v_s/ds_s are done
    load_tile<T, D>(k_s, kb, ks.s, k0, Sk);
    load_tile<T, D>(v_s, vb, vs.s, k0, Sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's 4x8 pairs.
    float s[RPT][CPT_S], dp[RPT][CPT_S];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT_S; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], dov[RPT], kv[CPT_S], vv[CPT_S];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        qv[i] = q_s[(r + 16 * i) * DP + d];
        dov[i] = do_s[(r + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < CPT_S; ++j) {
        kv[j] = k_s[(c + 8 * j) * DP + d];
        vv[j] = v_s[(c + 8 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += dov[i] * vv[j];
        }
    }

    // dS = P * (dP - delta), P = 0 where masked or past either edge.
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qi = q0 + r + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT_S; ++j) {
        const int kj = k0 + c + 8 * j;
        const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        ds_s[(r + 16 * i) * PP + c + 8 * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

    // dQ += dS K.
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) dsv[i] = ds_s[(r + 16 * i) * PP + j];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kk = k_s[j * DP + c + 8 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][cc] += dsv[i] * kk;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qi = q0 + r + 16 * i;
    if (qi < Sq) {
      T* out = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) out[c + 8 * cc] = rtt::from_f32<T>(acc[i][cc] * scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,  // [B*H, Sq]
    T* __restrict__ dk, T* __restrict__ dv,  // [B, Sk, H, D] contiguous
    int H, int Sq, int Sk, BSH qs, BSH ks, BSH vs, BSH dos, int causal, float scale) {
  constexpr int DP = D + 1;   // padded row stride of the k/v/q/do tiles
  constexpr int PP = BQ + 1;  // padded row stride of the P^T and dS^T tiles
  constexpr int CPT = D / 8;  // output columns per thread

  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;              // [BK][DP]
  float* v_s = k_s + BK * DP;     // [BK][DP]
  float* q_s = v_s + BK * DP;     // [BQ][DP]
  float* do_s = q_s + BQ * DP;    // [BQ][DP]
  float* p_s = do_s + BQ * DP;    // [BK][PP], P^T
  float* ds_s = p_s + BK * PP;    // [BK][PP], dS^T
  float* lse_s = ds_s + BK * PP;  // [BQ]
  float* delta_s = lse_s + BQ;    // [BQ]

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int r = tid / 8;  // this thread's keys: k0 + r + 16*i
  const int c = tid % 8;  // its queries in a tile: q0 + c + 8*j

  const T* qb = q + b * qs.b + h * qs.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  load_tile<T, D>(k_s, k + b * ks.b + h * ks.h, ks.s, k0, Sk);
  load_tile<T, D>(v_s, v + b * vs.b + h * vs.h, vs.s, k0, Sk);

  float dk_acc[RPT][CPT], dv_acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) dk_acc[i][cc] = dv_acc[i][cc] = 0.f;

  // Causal: query tiles before the one holding query k0 see none of these
  // keys, so the loop starts at the diagonal.
  const int n_tiles = (Sq + BQ - 1) / BQ;
  for (int tile = causal ? k0 / BQ : 0; tile < n_tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(q_s, qb, qs.s, q0, Sq);
    load_tile<T, D>(do_s, dob, dos.s, q0, Sq);
    if (tid < BQ) {
      const int qi = q0 + tid;
      lse_s[tid] = qi < Sq ? lse[(size_t)bh * Sq + qi] : 0.f;
      delta_s[tid] = qi < Sq ? delta[(size_t)bh * Sq + qi] : 0.f;
    }
    __syncthreads();

    // P^T = exp(K Q^T * scale - lse), 0 where masked or past either edge.
    {
      float st[RPT][CPT_S];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) st[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[RPT], qv[CPT_S];
#pragma unroll
        for (int i = 0; i < RPT; ++i) kv[i] = k_s[(r + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) qv[j] = q_s[(c + 8 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT_S; ++j) st[i][j] += kv[i] * qv[j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int kj = k0 + r + 16 * i;
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) {
          const int qi = q0 + c + 8 * j;
          const bool ok = qi < Sq && kj < Sk && (!causal || kj <= qi);
          p_s[(r + 16 * i) * PP + c + 8 * j] =
              ok ? expf(st[i][j] * scale - lse_s[c + 8 * j]) : 0.f;
        }
      }
    }

    // dS^T = P^T * (V dO^T - delta); each thread reads back only the P^T
    // entries it wrote itself.
    {
      float dpt[RPT][CPT_S];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) dpt[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float vv[RPT], dov[CPT_S];
#pragma unroll
        for (int i = 0; i < RPT; ++i) vv[i] = v_s[(r + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) dov[j] = do_s[(c + 8 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT_S; ++j) dpt[i][j] += vv[i] * dov[j];
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT_S; ++j) {
          const int idx = (r + 16 * i) * PP + c + 8 * j;
          ds_s[idx] = p_s[idx] * (dpt[i][j] - delta_s[c + 8 * j]);
        }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's queries.
#pragma unroll 4
    for (int j = 0; j < BQ; ++j) {
      float pv[RPT], dsv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        pv[i] = p_s[(r + 16 * i) * PP + j];
        dsv[i] = ds_s[(r + 16 * i) * PP + j];
      }
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float dd = do_s[j * DP + c + 8 * cc];
        const float qq = q_s[j * DP + c + 8 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          dv_acc[i][cc] += pv[i] * dd;
          dk_acc[i][cc] += dsv[i] * qq;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int kj = k0 + r + 16 * i;
    if (kj < Sk) {
      const size_t row = (((size_t)b * Sk + kj) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        dk[row + c + 8 * cc] = rtt::from_f32<T>(dk_acc[i][cc] * scale);
        dv[row + c + 8 * cc] = rtt::from_f32<T>(dv_acc[i][cc]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int B, H, Sq, Sk;
  BSH qs, ks, vs, dos;
  int causal;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(dq), a.H, a.Sq, a.Sk, a.qs, a.ks,
      a.vs, a.dos, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(dk), static_cast<T*>(dv), a.H, a.Sq,
      a.Sk, a.qs, a.ks, a.vs, a.dos, a.causal, a.scale);
  return (int)cudaGetLastError();
}

enum Which { kDQ, kDKV };

template <typename T, int D>
int launch(Which which, const Args& a, void* out0, void* out1) {
  return which == kDQ ? launch_dq<T, D>(a, out0) : launch_dkv<T, D>(a, out0, out1);
}

// Dispatch on dtype and D.
int dispatch(Which which, int dtype, int D, const Args& a, void* out0, void* out1) {
  if (dtype == rtt::kF32) {
    if (D == 64) return launch<float, 64>(which, a, out0, out1);
    if (D == 128) return launch<float, 128>(which, a, out0, out1);
  } else if (dtype == rtt::kBF16) {
    if (D == 64) return launch<__nv_bfloat16, 64>(which, a, out0, out1);
    if (D == 128) return launch<__nv_bfloat16, 128>(which, a, out0, out1);
  }
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, int B, int H, int Sq, int Sk, const long long* q_strides,
               const long long* k_strides, const long long* v_strides,
               const long long* do_strides, int causal, float scale, void* stream) {
  auto bsh = [](const long long* s) { return BSH{s[0], s[1], s[2]}; };
  return Args{q, k, v, dout, lse, delta, B, H, Sq, Sk, bsh(q_strides), bsh(k_strides),
              bsh(v_strides), bsh(do_strides), causal, scale,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

// q/do [B, Sq, H, D], k/v [B, Sk, H, D], each with its last dim contiguous
// and the element strides of its B, S and H dims in *_strides[3]; lse and
// delta [B*H, Sq] f32.  Writes dq [B, Sq, H, D] (contiguous).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_dq(int dtype, int D, const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta, void* dq, int B,
                        int H, int Sq, int Sk, const long long* q_strides,
                        const long long* k_strides, const long long* v_strides,
                        const long long* do_strides, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, q_strides, k_strides,
                           v_strides, do_strides, causal, scale, stream);
  return dispatch(kDQ, dtype, D, a, dq, nullptr);
}

// Same inputs; writes dk and dv [B, Sk, H, D] (contiguous).
extern "C" int flash_dkv(int dtype, int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, const long long* q_strides,
                         const long long* k_strides, const long long* v_strides,
                         const long long* do_strides, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, q_strides, k_strides,
                           v_strides, do_strides, causal, scale, stream);
  return dispatch(kDKV, dtype, D, a, dk, dv);
}
