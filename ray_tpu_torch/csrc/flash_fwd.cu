// Flash-attention forward: blocked online-softmax attention, causal or not.
//
// Replaces the Pallas kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_fwd there).  Same function: out = softmax(q k^T *
// D^-1/2, masked) v in the input dtype, plus the per-row f32
// lse = m + log(l) that a backward pass needs; f32 scores and accumulators,
// l clamped at 1e-30, masked scores at -1e30 as in the JAX package.  In
// bf16, P is rounded to bf16 before P.V, where the JAX kernel rounds it.
//
// What bounds it on an H100: operations.  Causal attention does
// 4*D FLOPs for each live (query, key) pair (Q.K^T and P.V over the lower
// triangle: 51.6 GFLOP at B=32, H=12, S=1024, D=64) against 4*B*S*H*D
// input/output elements, far above the ~295 FLOP/byte ridge.
//
// bf16 (flash_fwd_wgmma_kernel): the products run on the tensor cores.
//   - grid (B*H, ceil(Sq/128)); blockIdx.y walks the query tiles heaviest
//     first (the last causal tile, which walks every key tile, starts
//     first), so the longest blocks do not trail the launch;
//   - two consumer warpgroups own 64 query rows each; a ninth warp is the
//     producer: one TMA load brings the Q tile, and K/V tiles of 64 rows
//     stream through a ring of two stages guarded by mbarriers (full: the
//     bytes landed; empty: all eight consumer warps are done), so one
//     tile's load overlaps the previous tile's products;
//   - the tensor maps are 4-D over [B, S, H, D] with the tensor's own
//     strides (GPT-2's slices of the fused qkv are read in place), boxes of
//     64 rows x 64 columns with the 128-byte swizzle that the wgmma
//     descriptors read; TMA zero-fills rows past S;
//   - S = Q.K^T by wgmma m64n64k16 from shared memory (both K-major), the
//     f32 accumulator scaled as the JAX kernel scales it, masked (keys past
//     Sk; key > query when causal) and run through the online softmax with
//     quad shuffles for the row max and sum; P goes to bf16 in registers
//     and is the register A operand of O += P.V, with V the MN-major B
//     operand from shared memory;
//   - sm90.cuh holds the PTX (mbarrier, TMA, descriptors, wgmma).
// f32 (flash_fwd_kernel): f32 FMAs from padded shared-memory tiles, so f32
// keeps full f32 products (wgmma on f32 operands would run in TF32).
// D is a template parameter: 64 and 128 are built.

#include "common.cuh"
#include "sm90.cuh"

namespace {

// ------------------------------------------------------------ f32, FMA
constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per tile
constexpr int THREADS = 128; // 16 row groups x 8 column groups
constexpr int RPT = BQ / 16; // query rows per thread (rows r + 16*i)
constexpr int KPT = BK / 8;  // key columns per thread (cols c + 8*j)

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(2 * BQ * (D + 1) + BK * D + BQ * (BK + 1)) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out,  // [B, Sq, H, D] contiguous
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

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int row = i / D;
    const int d = i - row * D;
    const int qi = q0 + row;
    q_s[row * DP + d] = qi < Sq ? qb[qi * q_ss + d] * scale : 0.f;
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
      k_s[row * DP + d] = ok ? kb[kj * k_ss + d] : 0.f;
      v_s[row * D + d] = ok ? vb[kj * v_ss + d] : 0.f;
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
      float* ob = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) ob[c + 8 * cc] = acc[i][cc] / li;
      if (c == 0) lse[(size_t)bh * Sq + qi] = m[i] + logf(li);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
               int Sq, int Sk, const long long* qs, const long long* ks, const long long* vs,
               int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kern = flash_fwd_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), H, Sq, Sk, qs[0], qs[1], qs[2], ks[0],
      ks[1], ks[2], vs[0], vs[1], vs[2], causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- bf16, wgmma + TMA
constexpr int WG_BQ = 128;          // query rows per block: two warpgroups
constexpr int WG_BK = 64;           // key rows per ring stage
constexpr int WG_STAGES = 2;
constexpr int WG_THREADS = 288;     // two consumer warpgroups + one producer warp
constexpr int WG_CONSUMER_WARPS = 8;

template <int D>
constexpr size_t wg_smem_bytes() {
  // Q (two row boxes per 64 columns), K and V per stage, five mbarriers,
  // and slack to align the base to 1024 bytes.
  return (size_t)(D / 64) * sm90::BOX_BYTES * (2 + 2 * WG_STAGES) + 64 + 1024;
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    __nv_bfloat16* __restrict__ out,  // [B, Sq, H, D] contiguous
    float* __restrict__ lse,          // [B*H, Sq]
    int H, int Sq, int Sk, int causal, float scale) {
  constexpr int DB = D / 64;  // 64-column boxes per row
  constexpr int BOX = sm90::BOX_BYTES;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = sm90::align_1024(smem_raw);
  uint8_t* q_s = smem;                           // box (c, wg): [64 rows][64]
  uint8_t* k_s = q_s + 2 * DB * BOX;             // box (stage, c)
  uint8_t* v_s = k_s + WG_STAGES * DB * BOX;     // box (stage, c)
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_s + WG_STAGES * DB * BOX);
  uint64_t* q_bar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + WG_STAGES;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;  // heaviest tile first
  int n_tiles = (Sk + WG_BK - 1) / WG_BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + WG_BQ, Sq) - 1) / WG_BK + 1);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], WG_CONSUMER_WARPS);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG_CONSUMER_WARPS) {  // producer
    if (lane == 0) {
      sm90::tma_prefetch_map(&tq);
      sm90::tma_prefetch_map(&tk);
      sm90::tma_prefetch_map(&tv);
      sm90::mbar_arrive_expect_tx(q_bar, 2 * DB * BOX);
      for (int c = 0; c < DB; ++c)
        for (int r = 0; r < 2; ++r)
          sm90::tma_load_4d(q_s + (c * 2 + r) * BOX, &tq, q_bar, c * 64, h, q0 + r * 64, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % WG_STAGES;
        if (j >= WG_STAGES) sm90::mbar_wait(&empty[st], ((j / WG_STAGES) - 1) & 1);
        sm90::mbar_arrive_expect_tx(&full[st], 2 * DB * BOX);
        for (int c = 0; c < DB; ++c) {
          sm90::tma_load_4d(k_s + (st * DB + c) * BOX, &tk, &full[st], c * 64, h, j * WG_BK, b);
          sm90::tma_load_4d(v_s + (st * DB + c) * BOX, &tv, &full[st], c * 64, h, j * WG_BK, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows q0 + wg*64 .. +63; this thread
  // holds rows row0 and row0 + 8 of the accumulators.
  const int wg = warp / 4;
  const int t = lane % 4;
  const int wg_q0 = q0 + wg * 64;
  const int row0 = wg_q0 + (warp % 4) * 16 + lane / 4;

  float o[DB][32];
#pragma unroll
  for (int c = 0; c < DB; ++c)
#pragma unroll
    for (int r = 0; r < 32; ++r) o[c][r] = 0.f;
  float m[2] = {rtt::NEG_INF, rtt::NEG_INF};
  float l[2] = {0.f, 0.f};

  sm90::mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % WG_STAGES;
    const int k0 = j * WG_BK;
    sm90::mbar_wait(&full[st], (j / WG_STAGES) & 1);
    // Causal: the warpgroup's last row sees no key of a tile past it.
    if (!causal || k0 <= wg_q0 + 63) {
      float s[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) s[r] = 0.f;
      sm90::wgmma_fence();
      sm90::fence_acc(s);
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_ss<0>(s, sm90::desc_kmajor(q_s + (c * 2 + wg) * BOX, ks),
                            sm90::desc_kmajor(k_s + (st * DB + c) * BOX, ks), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_acc(s);

      // Scale as the JAX kernel does (dot(q, k^T) * scale), then mask.
      const bool need_mask = k0 + WG_BK > Sk || (causal && k0 + WG_BK - 1 > wg_q0);
      float mx[2] = {rtt::NEG_INF, rtt::NEG_INF};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        float x = s[r] * scale;
        if (need_mask) {
          const int kj = k0 + sm90::acc_col(r) + 2 * t;
          const int qi = row0 + sm90::acc_row(r);
          if (kj >= Sk || (causal && kj > qi)) x = rtt::NEG_INF;
        }
        s[r] = x;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], x);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // A row's 64 columns live in the 4 lanes of a quad.
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = exp2f((m[i] - m_new) * rtt::LOG2E);
        m[i] = m_new;
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int i = (r >> 1) & 1;
        s[r] = exp2f((s[r] - m[i]) * rtt::LOG2E);
        rs[i] += s[r];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];  // summed over the quad at the end
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int r = 0; r < 32; ++r) o[c][r] *= alpha[(r >> 1) & 1];

      uint32_t p[16];
      sm90::acc_to_frag(s, p);  // P rounded to bf16, as the JAX kernel rounds it
      sm90::wgmma_fence();
#pragma unroll
      for (int c = 0; c < DB; ++c) sm90::fence_acc(o[c]);
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          sm90::wgmma_rs<1>(o[c], p + 4 * ks, sm90::desc_mnmajor(v_s + (st * DB + c) * BOX, ks),
                            1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < DB; ++c) sm90::fence_acc(o[c]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    li = fmaxf(li, 1e-30f);
    const float inv = 1.f / li;
    const int qi = row0 + 8 * i;
    if (qi < Sq) {
      __nv_bfloat16* orow = out + (((size_t)b * Sq + qi) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DB; ++c)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int r = 4 * jj + 2 * i;
          *reinterpret_cast<uint32_t*>(orow + c * 64 + 8 * jj + 2 * t) =
              sm90::pack_bf16(o[c][r] * inv, o[c][r + 1] * inv);
        }
      if (t == 0) lse[(size_t)bh * Sq + qi] = m[i] + logf(li);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int B, int H,
                int Sq, int Sk, const long long* qs, const long long* ks, const long long* vs,
                int causal, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!sm90::encode_bshd(&tq, q, B, Sq, H, D, qs) || !sm90::encode_bshd(&tk, k, B, Sk, H, D, ks) ||
      !sm90::encode_bshd(&tv, v, B, Sk, H, D, vs))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = wg_smem_bytes<D>();
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + WG_BQ - 1) / WG_BQ);
  kern<<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                                            static_cast<float*>(lse), H, Sq, Sk, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, D], k/v [B, Sk, H, D], each with its last dim contiguous and
// the element strides of its B, S and H dims in *_strides[3] (in bf16, a
// 16-byte-aligned base and strides that are multiples of 8 elements, as
// TMA reads them).  Writes out [B, Sq, H, D] (contiguous) and lse
// [B*H, Sq] f32.  Dispatches on dtype: bf16 to the wgmma kernel, f32 to
// the FMA kernel.  Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(int dtype, int D, const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int H, int Sq, int Sk,
                         const long long* q_strides, const long long* k_strides,
                         const long long* v_strides, int causal, float scale, void* stream) {
  if (B * H == 0 || Sq == 0) return 0;
  using Launch = int (*)(const void*, const void*, const void*, void*, void*, int, int, int, int,
                         const long long*, const long long*, const long long*, int, float,
                         cudaStream_t);
  Launch launch = nullptr;
  if (dtype == rtt::kF32 && D == 64) launch = launch_f32<64>;
  if (dtype == rtt::kF32 && D == 128) launch = launch_f32<128>;
  if (dtype == rtt::kBF16 && D == 64) launch = launch_bf16<64>;
  if (dtype == rtt::kBF16 && D == 128) launch = launch_bf16<128>;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, out, lse, B, H, Sq, Sk, q_strides, k_strides, v_strides, causal, scale,
                static_cast<cudaStream_t>(stream));
}
