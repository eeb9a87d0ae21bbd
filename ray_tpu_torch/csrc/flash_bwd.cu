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
// Scores and accumulators are f32.  In bf16 both kernels round P and dS to
// bf16 before their products, where the JAX kernels round them; they still
// sum in another order, so bf16 is compared at a relative tolerance.
//
// What bounds them on an H100: operations.  Over the live (query, key)
// pairs dQ does three matmuls (QK^T, dO V^T, dS K: 6*D FLOPs a pair) and
// dK/dV four (8*D: 103.2 GFLOP at B=32, H=12, S=1024, D=64, causal),
// against ~7 B*S*H*D elements read and written, far above the ~295
// FLOP/byte ridge.  Common to both:
//   - the TPU kernels hold whole K/V (dQ) or Q/dO (dK/dV) rows in VMEM; a
//     block's 227 KB of shared memory does not hold them at S=2048, so
//     each block holds one side's rows and walks tiles of the other: dQ
//     over K/V tiles up to the diagonal, dK/dV over Q/dO tiles from the
//     diagonal tile to the end (its blockIdx.y order is heaviest first);
//   - q/k/v/dO are read in their [B, S, H, D] layout through strides, so
//     GPT-2's slices of the fused qkv are read in place; dq/dk/dv are
//     written contiguous [B, S, H, D];
//   - the ragged edge (S not a multiple of 64) is masked: keys past Sk and
//     queries past Sq get P = 0 (a query row past Sq has no lse, and an
//     exp(s - garbage) there would put inf * 0 = NaN into dK/dV).
// dK/dV in bf16 (flash_dkv_wgmma_kernel) runs the four products on the
// tensor cores:
//   - grid (B*H, ceil(Sk/128)), K-stationary: two consumer warpgroups own
//     64 keys each, whose K and V tiles one TMA load brings once; a ninth
//     warp is the producer and streams 64-row Q/dO tiles with their lse and
//     delta slices through a ring of two stages guarded by mbarriers, so
//     one tile's load overlaps the previous tile's products;
//   - per tile: S^T = K.Q^T and dP^T = V.dO^T by wgmma from shared memory
//     (K-major, 128-byte swizzle); P^T = exp(S^T*scale - lse), masked, and
//     dS^T = P^T*(dP^T - delta) on the f32 accumulators; both go to bf16 in
//     registers as the A operands of dV += P^T.dO and dK += dS^T.Q, with dO
//     and Q the MN-major B operands; dK and dV stay in f32 registers, and
//     dK takes the scale once at the end;
//   - at D=128 a consumer thread holds 128 f32 of dK and dV besides 64 of
//     S^T and dP^T, more than the 168 registers ptxas gives a thread of
//     this block: it spills ~900 bytes and serializes the wgmmas there
//     (right, but slower; no model of the repo runs D=128 yet);
//   - sm90.cuh holds the PTX (mbarrier, TMA, descriptors, wgmma).
// dQ in bf16 (flash_dq_wgmma_kernel) is the same machine turned around,
// Q-stationary like the forward:
//   - grid (B*H, ceil(Sq/128)), query tiles heaviest first; two consumer
//     warpgroups own 64 query rows each, whose Q and dO boxes one TMA load
//     brings once, with the block's lse and delta rows written beside them
//     by the producer warp's lanes on the same mbarrier (0 past Sq, where P
//     is masked to 0); 64-row K/V tiles stream through the two-stage ring
//     up to the diagonal of the block's last row;
//   - per tile: S = Q.K^T and dP = dO.V^T by wgmma from shared memory (all
//     four operands K-major); P = exp(S*scale - lse), masked, and
//     dS = P*(dP - delta) on the f32 accumulators; dS goes to bf16 in
//     registers as the A operand of dQ += dS.K, with the same K box the
//     MN-major B operand (as the forward reads V); dQ takes the scale once
//     at the end;
//   - at D=64 a consumer thread holds 32 f32 each of S, dP and dQ.
// dQ and dK/dV in f32 run f32 FMAs from padded shared-memory tiles (4x8
// scores and 4x(D/8) outputs a thread), so f32 keeps full f32 products
// (wgmma on f32 operands would run in TF32).
// D is a template parameter: 64 and 128 are built.

#include <array>

#include "common.cuh"
#include "sm90.cuh"

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
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long row_stride, int row0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int row = i / D;
    const int d = i - row * D;
    const int gi = row0 + row;
    dst[row * (D + 1) + d] = gi < n ? src[gi * row_stride + d] : 0.f;
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

template <int D>
__global__ void __launch_bounds__(THREADS) flash_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,  // [B*H, Sq]
    float* __restrict__ dq,           // [B, Sq, H, D] contiguous
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

  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  load_tile<D>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq);
  load_tile<D>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, Sq);

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
    load_tile<D>(k_s, kb, ks.s, k0, Sk);
    load_tile<D>(v_s, vb, vs.s, k0, Sk);
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
      float* out = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) out[c + 8 * cc] = acc[i][cc] * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta,  // [B*H, Sq]
    float* __restrict__ dk, float* __restrict__ dv,  // [B, Sk, H, D] contiguous
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

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  load_tile<D>(k_s, k + b * ks.b + h * ks.h, ks.s, k0, Sk);
  load_tile<D>(v_s, v + b * vs.b + h * vs.h, vs.s, k0, Sk);

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
    load_tile<D>(q_s, qb, qs.s, q0, Sq);
    load_tile<D>(do_s, dob, dos.s, q0, Sq);
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
        dk[row + c + 8 * cc] = dk_acc[i][cc] * scale;
        dv[row + c + 8 * cc] = dv_acc[i][cc];
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

template <int D>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kern = flash_dq_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dq), a.H, a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos, a.causal, a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  auto kern = flash_dkv_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sk + BK - 1) / BK);
  kern<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Sq, a.Sk, a.qs, a.ks, a.vs, a.dos,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- dK/dV, bf16, wgmma + TMA
constexpr int WG_BK = 128;          // keys per block: two warpgroups of 64
constexpr int WG_BQ = 64;           // query rows per ring stage
constexpr int WG_STAGES = 2;
constexpr int WG_THREADS = 288;     // two consumer warpgroups + one producer warp
constexpr int WG_CONSUMER_WARPS = 8;

template <int D>
constexpr size_t dkv_wg_smem_bytes() {
  // K and V (two row boxes per 64 columns), Q and dO per stage, lse and
  // delta per stage, five mbarriers, and slack to align the base.
  return (size_t)(D / 64) * sm90::BOX_BYTES * (4 + 2 * WG_STAGES) +
         2 * WG_STAGES * WG_BQ * sizeof(float) + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,  // [B*H, Sq]
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,  // [B, Sk, H, D] contiguous
    int H, int Sq, int Sk, int causal, float scale) {
  constexpr int DB = D / 64;  // 64-column boxes per row
  constexpr int BOX = sm90::BOX_BYTES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* k_s = smem;                            // box (c, wg): [64 keys][64]
  uint8_t* v_s = k_s + 2 * DB * BOX;              // box (c, wg)
  uint8_t* q_s = v_s + 2 * DB * BOX;              // box (stage, c): [64 queries][64]
  uint8_t* do_s = q_s + WG_STAGES * DB * BOX;     // box (stage, c)
  float* lse_s = reinterpret_cast<float*>(do_s + WG_STAGES * DB * BOX);  // [stage][64]
  float* dl_s = lse_s + WG_STAGES * WG_BQ;                               // [stage][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + WG_STAGES * WG_BQ);
  uint64_t* kv_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + WG_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.y * WG_BK;
  const int n_q = (Sq + WG_BQ - 1) / WG_BQ;
  // Causal: query tiles before the one holding key k0 see none of these keys.
  const int first = causal ? k0 / WG_BQ : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_bar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer warp's lanes
      sm90::mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tdo);
      sm90::mbar_arrive_expect_tx(kv_bar, 4 * DB * BOX);
      for (int c = 0; c < DB; ++c)
        for (int r = 0; r < 2; ++r) {
          sm90::tma_load_4d(k_s + (c * 2 + r) * BOX, &tk, kv_bar, c * 64, h, k0 + r * 64, b);
          sm90::tma_load_4d(v_s + (c * 2 + r) * BOX, &tv, kv_bar, c * 64, h, k0 + r * 64, b);
        }
    }
    const float* lse_bh = lse + (size_t)bh * Sq;
    const float* dl_bh = delta + (size_t)bh * Sq;
    for (int tile = first; tile < n_q; ++tile) {
      const int j = tile - first;
      const int st = j % WG_STAGES;
      const int q0 = tile * WG_BQ;
      if (j >= WG_STAGES) sm90::mbar_wait(&empty[st], ((j / WG_STAGES) - 1) & 1);
      // Rows past Sq have no lse: zeros, and P is masked to 0 there.
      for (int i = lane; i < WG_BQ; i += 32) {
        const int qi = q0 + i;
        lse_s[st * WG_BQ + i] = qi < Sq ? lse_bh[qi] : 0.f;
        dl_s[st * WG_BQ + i] = qi < Sq ? dl_bh[qi] : 0.f;
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&full[st], 2 * DB * BOX);
        for (int c = 0; c < DB; ++c) {
          sm90::tma_load_4d(q_s + (st * DB + c) * BOX, &tq, &full[st], c * 64, h, q0, b);
          sm90::tma_load_4d(do_s + (st * DB + c) * BOX, &tdo, &full[st], c * 64, h, q0, b);
        }
      } else {
        sm90::mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns keys k0 + wg*64 .. +63; this thread holds
  // keys krow and krow + 8 of the accumulators (rows: keys, columns:
  // queries for S^T and dP^T, head dims for dK and dV).
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_k0 = k0 + wg * 64;
  const int krow = wg_k0 + (warp % 4) * 16 + lane / 4;

  float dk_acc[DB][32], dv_acc[DB][32];
#pragma unroll
  for (int c = 0; c < DB; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk_acc[c][r] = dv_acc[c][r] = 0.f;

  sm90::mbar_wait(kv_bar, 0);
  for (int tile = first; tile < n_q; ++tile) {
    const int j = tile - first;
    const int st = j % WG_STAGES;
    const int q0 = tile * WG_BQ;
    sm90::mbar_wait(&full[st], (j / WG_STAGES) & 1);
    // Causal: a tile whose last query precedes the warpgroup's first key
    // has P = 0 throughout.
    if (!causal || q0 + WG_BQ - 1 >= wg_k0) {
      float s[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
      sm90::wgmma_fence();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      // S^T = K.Q^T and dP^T = V.dO^T, all four operands K-major.
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          sm90::wgmma_ss<0>(s, sm90::desc_kmajor(k_s + (c * 2 + wg) * BOX, ks),
                            sm90::desc_kmajor(q_s + (st * DB + c) * BOX, ks), 1);
          sm90::wgmma_ss<0>(dp, sm90::desc_kmajor(v_s + (c * 2 + wg) * BOX, ks),
                            sm90::desc_kmajor(do_s + (st * DB + c) * BOX, ks), 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);

      // P^T = exp(S^T * scale - lse), 0 where masked or past either edge;
      // dS^T = P^T * (dP^T - delta).
      const float* lse_t = lse_s + st * WG_BQ;
      const float* dl_t = dl_s + st * WG_BQ;
      const bool need_mask =
          q0 + WG_BQ > Sq || wg_k0 + 64 > Sk || (causal && q0 < wg_k0 + 63);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int qc = sm90::acc_col(r) + 2 * t;
        float p = exp2f((s[r] * scale - lse_t[qc]) * rtt::LOG2E);
        if (need_mask) {
          const int qi = q0 + qc;
          const int kj = krow + sm90::acc_row(r);
          if (qi >= Sq || kj >= Sk || (causal && kj > qi)) p = 0.f;
        }
        s[r] = p;
        dp[r] = p * (dp[r] - dl_t[qc]);
      }
      // Both rounded to bf16 before their products, as the JAX kernel
      // rounds them.
      uint32_t pa[16], da[16];
      sm90::acc_to_frag(s, pa);
      sm90::acc_to_frag(dp, da);

      // dV += P^T.dO and dK += dS^T.Q, with dO and Q the MN-major B operands.
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        sm90::fence_acc(dv_acc[c]);
        sm90::fence_acc(dk_acc[c]);
      }
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          sm90::wgmma_rs<1>(dv_acc[c], pa + 4 * ks,
                            sm90::desc_mnmajor(do_s + (st * DB + c) * BOX, ks), 1);
          sm90::wgmma_rs<1>(dk_acc[c], da + 4 * ks,
                            sm90::desc_mnmajor(q_s + (st * DB + c) * BOX, ks), 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DB; ++c) {
        sm90::fence_acc(dv_acc[c]);
        sm90::fence_acc(dk_acc[c]);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = krow + 8 * i;
    if (kj < Sk) {
      const size_t row = (((size_t)b * Sk + kj) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int r = 4 * jj + 2 * i;
          const int col = c * 64 + 8 * jj + 2 * t;
          *reinterpret_cast<uint32_t*>(dk + row + col) =
              sm90::pack_bf16(dk_acc[c][r] * scale, dk_acc[c][r + 1] * scale);
          *reinterpret_cast<uint32_t*>(dv + row + col) =
              sm90::pack_bf16(dv_acc[c][r], dv_acc[c][r + 1]);
        }
    }
  }
}

// The four tensor maps of the bf16 backward kernels.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
bool encode_maps(const Args& a, Maps* m) {
  auto arr = [](const BSH& s) { return std::array<long long, 3>{s.b, s.s, s.h}; };
  const auto qs = arr(a.qs), ks = arr(a.ks), vs = arr(a.vs), dos = arr(a.dos);
  return sm90::encode_bshd(&m->q, a.q, a.B, a.Sq, a.H, D, qs.data()) &&
         sm90::encode_bshd(&m->k, a.k, a.B, a.Sk, a.H, D, ks.data()) &&
         sm90::encode_bshd(&m->v, a.v, a.B, a.Sk, a.H, D, vs.data()) &&
         sm90::encode_bshd(&m->dout, a.dout, a.B, a.Sq, a.H, D, dos.data());
}

template <int D>
int launch_dkv_wgmma(const Args& a, void* dk, void* dv) {
  Maps m;
  if (!encode_maps<D>(a, &m)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dkv_wg_smem_bytes<D>();
  auto kern = flash_dkv_wgmma_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sk + WG_BK - 1) / WG_BK);
  kern<<<grid, WG_THREADS, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H, a.Sq, a.Sk,
      a.causal, a.scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------- dQ, bf16, wgmma + TMA
constexpr int DQ_BQ = 128;  // query rows per block: two warpgroups of 64
constexpr int DQ_BK = 64;   // key rows per ring stage

template <int D>
constexpr size_t dq_wg_smem_bytes() {
  // Q and dO (two row boxes per 64 columns), K and V per stage, lse and
  // delta of the block's rows, five mbarriers, and slack to align the base.
  return (size_t)(D / 64) * sm90::BOX_BYTES * (4 + 2 * WG_STAGES) +
         2 * DQ_BQ * sizeof(float) + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,  // [B*H, Sq]
    __nv_bfloat16* __restrict__ dq,                                  // [B, Sq, H, D] contiguous
    int H, int Sq, int Sk, int causal, float scale) {
  constexpr int DB = D / 64;  // 64-column boxes per row
  constexpr int BOX = sm90::BOX_BYTES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* q_s = smem;                            // box (c, wg): [64 queries][64]
  uint8_t* do_s = q_s + 2 * DB * BOX;             // box (c, wg)
  uint8_t* k_s = do_s + 2 * DB * BOX;             // box (stage, c): [64 keys][64]
  uint8_t* v_s = k_s + WG_STAGES * DB * BOX;      // box (stage, c)
  float* lse_s = reinterpret_cast<float*>(v_s + WG_STAGES * DB * BOX);  // [128]
  float* dl_s = lse_s + DQ_BQ;                                          // [128]
  uint64_t* bars = reinterpret_cast<uint64_t*>(dl_s + DQ_BQ);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + WG_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BQ;  // heaviest tile first
  int n_tiles = (Sk + DQ_BK - 1) / DQ_BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + DQ_BQ, Sq) - 1) / DQ_BK + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 32);  // the producer warp's lanes
    for (int s = 0; s < WG_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONSUMER_WARPS) {  // producer
    // Rows past Sq have no lse: zeros, and P is masked to 0 there.
    const float* lse_bh = lse + (size_t)bh * Sq;
    const float* dl_bh = delta + (size_t)bh * Sq;
    for (int i = lane; i < DQ_BQ; i += 32) {
      const int qi = q0 + i;
      lse_s[i] = qi < Sq ? lse_bh[qi] : 0.f;
      dl_s[i] = qi < Sq ? dl_bh[qi] : 0.f;
    }
    if (lane != 0) {
      sm90::mbar_arrive(q_bar);
      return;
    }
    sm90::tma_prefetch_map(&tk);
    sm90::tma_prefetch_map(&tv);
    sm90::mbar_arrive_expect_tx(q_bar, 4 * DB * BOX);
    for (int c = 0; c < DB; ++c)
      for (int r = 0; r < 2; ++r) {
        sm90::tma_load_4d(q_s + (c * 2 + r) * BOX, &tq, q_bar, c * 64, h, q0 + r * 64, b);
        sm90::tma_load_4d(do_s + (c * 2 + r) * BOX, &tdo, q_bar, c * 64, h, q0 + r * 64, b);
      }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % WG_STAGES;
      if (j >= WG_STAGES) sm90::mbar_wait(&empty[st], ((j / WG_STAGES) - 1) & 1);
      sm90::mbar_arrive_expect_tx(&full[st], 2 * DB * BOX);
      for (int c = 0; c < DB; ++c) {
        sm90::tma_load_4d(k_s + (st * DB + c) * BOX, &tk, &full[st], c * 64, h, j * DQ_BK, b);
        sm90::tma_load_4d(v_s + (st * DB + c) * BOX, &tv, &full[st], c * 64, h, j * DQ_BK, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + wg*64 .. +63; this thread
  // holds rows row0 and row0 + 8 of the accumulators (columns: keys for S
  // and dP, head dims for dQ).
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_q0 = q0 + wg * 64;
  const int local = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int row0 = q0 + local;

  float dq_acc[DB][32];
#pragma unroll
  for (int c = 0; c < DB; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) dq_acc[c][r] = 0.f;

  sm90::mbar_wait(q_bar, 0);
  const float lse_r[2] = {lse_s[local], lse_s[local + 8]};
  const float dl_r[2] = {dl_s[local], dl_s[local + 8]};
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % WG_STAGES;
    const int k0 = j * DQ_BK;
    sm90::mbar_wait(&full[st], (j / WG_STAGES) & 1);
    // Causal: a tile whose first key follows the warpgroup's last row has
    // P = 0 throughout.
    if (!causal || k0 <= wg_q0 + 63) {
      float s[32], dp[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = dp[r] = 0.f;
      sm90::wgmma_fence();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);
      // S = Q.K^T and dP = dO.V^T, all four operands K-major.
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          sm90::wgmma_ss<0>(s, sm90::desc_kmajor(q_s + (c * 2 + wg) * BOX, ks),
                            sm90::desc_kmajor(k_s + (st * DB + c) * BOX, ks), 1);
          sm90::wgmma_ss<0>(dp, sm90::desc_kmajor(do_s + (c * 2 + wg) * BOX, ks),
                            sm90::desc_kmajor(v_s + (st * DB + c) * BOX, ks), 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_acc(s);
      sm90::fence_acc(dp);

      // P = exp(S * scale - lse), 0 where masked or past either edge;
      // dS = P * (dP - delta), kept in dp.
      const bool need_mask =
          k0 + DQ_BK > Sk || wg_q0 + 64 > Sq || (causal && k0 + DQ_BK - 1 > wg_q0);
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = (r >> 1) & 1;
        float p = exp2f((s[r] * scale - lse_r[i]) * rtt::LOG2E);
        if (need_mask) {
          const int qi = row0 + sm90::acc_row(r);
          const int kj = k0 + sm90::acc_col(r) + 2 * t;
          if (qi >= Sq || kj >= Sk || (causal && kj > qi)) p = 0.f;
        }
        dp[r] = p * (dp[r] - dl_r[i]);
      }
      // dS rounded to bf16 before dS.K, as the JAX kernel rounds it.
      uint32_t da[16];
      sm90::acc_to_frag(dp, da);

      // dQ += dS.K, with the same K box the MN-major B operand.
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < DB; ++c) sm90::fence_acc(dq_acc[c]);
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_rs<1>(dq_acc[c], da + 4 * ks,
                            sm90::desc_mnmajor(k_s + (st * DB + c) * BOX, ks), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DB; ++c) sm90::fence_acc(dq_acc[c]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi < Sq) {
      __nv_bfloat16* out = dq + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int r = 4 * jj + 2 * i;
          *reinterpret_cast<uint32_t*>(out + c * 64 + 8 * jj + 2 * t) =
              sm90::pack_bf16(dq_acc[c][r] * scale, dq_acc[c][r + 1] * scale);
        }
    }
  }
}

template <int D>
int launch_dq_wgmma(const Args& a, void* dq) {
  Maps m;
  if (!encode_maps<D>(a, &m)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = dq_wg_smem_bytes<D>();
  auto kern = flash_dq_wgmma_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sq + DQ_BQ - 1) / DQ_BQ);
  kern<<<grid, WG_THREADS, smem, a.stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(dq), a.H, a.Sq, a.Sk,
      a.causal, a.scale);
  return (int)cudaGetLastError();
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

// Dispatch on dtype and D: each kernel runs its wgmma design in bf16 and
// its FMA design in f32.
int dispatch_dq(int dtype, int D, const Args& a, void* dq) {
  if (dtype == rtt::kF32 && D == 64) return launch_dq<64>(a, dq);
  if (dtype == rtt::kF32 && D == 128) return launch_dq<128>(a, dq);
  if (dtype == rtt::kBF16 && D == 64) return launch_dq_wgmma<64>(a, dq);
  if (dtype == rtt::kBF16 && D == 128) return launch_dq_wgmma<128>(a, dq);
  return (int)cudaErrorInvalidValue;
}

int dispatch_dkv(int dtype, int D, const Args& a, void* dk, void* dv) {
  if (dtype == rtt::kF32 && D == 64) return launch_dkv<64>(a, dk, dv);
  if (dtype == rtt::kF32 && D == 128) return launch_dkv<128>(a, dk, dv);
  if (dtype == rtt::kBF16 && D == 64) return launch_dkv_wgmma<64>(a, dk, dv);
  if (dtype == rtt::kBF16 && D == 128) return launch_dkv_wgmma<128>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
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
  return dispatch_dq(dtype, D, a, dq);
}

// Same inputs; writes dk and dv [B, Sk, H, D] (contiguous).
extern "C" int flash_dkv(int dtype, int D, const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta, void* dk,
                         void* dv, int B, int H, int Sq, int Sk, const long long* q_strides,
                         const long long* k_strides, const long long* v_strides,
                         const long long* do_strides, int causal, float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, H, Sq, Sk, q_strides, k_strides,
                           v_strides, do_strides, causal, scale, stream);
  return dispatch_dkv(dtype, D, a, dk, dv);
}
