// Single-token decode attention over the layer-stacked KV cache.
//
// Replaces the Pallas kernel ray_tpu/ops/decode_attention.py:_decode_kernel
// (launched by decode_attention there).  Same function: each batch row's
// query heads attend to the live prefix of that row's cache in layer `layer`
// — [0, pos) when the current token's k/v come in as k_self/v_self (merged
// last, the deferred-scatter protocol), [0, pos] when they do not — with an
// f32 online softmax.  GQA is native: a block serves the G = H / Hkv query
// rows that share one kv head.
//
// What bounds it on an H100: bytes.  Each step reads the live prefix's K and
// V once (plus q, k/v self and out, which are tiny); at B=8, Hkv=8, D=64 and
// a mean position of 1024 that is ~8.4 MB a layer, ~2.5 us at 3.35 TB/s.
// What the design does about it:
//   - grid (B, Hkv) instead of the TPU's (B,): the TPU grid would fill 8 of
//     132 SMs; here every kv head of every row streams in its own block;
//   - only the live prefix is read: the tile loop stops at the row's own
//     length, and tiles are cut from cache[layer] by pointer offset (the
//     stacked cache is never sliced or copied);
//   - tiles of 64 rows stream into shared memory with 16-byte cp.async
//     copies, double-buffered, so the next tile is in flight while this
//     one is computed;
//   - each thread computes whole dot products from 16-byte reads of K rows
//     padded by 16 bytes (conflict-free), so no warp reduction sits on the
//     score path;
//   - the strictly-before mask is the loop bound itself.
// Not yet done (later work): split-T across blocks (flash-decoding).  Each
// block walks its whole prefix alone, so the longest row of the batch sets
// the kernel's time and at B*Hkv = 64 blocks half the SMs idle.
//
// Requires D * sizeof(T) to be a multiple of 16 and 16-byte aligned caches
// (the wrapper checks both).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int TILE_T = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_PHASES = THREADS / TILE_T;  // query rows scored at once per cache row

__host__ __device__ inline size_t float_slots(int G, int D) {
  // q [G][D], acc [G][D], scores [G][TILE_T], m/l/alpha [G]; rounded up so
  // the tiles that follow start 16-byte aligned.
  size_t n = 2 * (size_t)G * D + (size_t)G * TILE_T + 3 * (size_t)G;
  return (n + 3) & ~(size_t)3;
}

template <typename T>
__host__ __device__ inline size_t tile_elems(int D) {
  // One K tile (rows padded by 16 bytes) plus one V tile.
  return (size_t)TILE_T * (D + 16 / sizeof(T)) + (size_t)TILE_T * D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const T* __restrict__ k_cache,    // [L, B, Hkv, T, D]
    const T* __restrict__ v_cache,    // [L, B, Hkv, T, D]
    const int32_t* __restrict__ pos,  // [B]
    const T* __restrict__ k_self,     // [B, Hkv, D] or null
    const T* __restrict__ v_self,     // [B, Hkv, D] or null
    T* __restrict__ out,              // [B, H, D]
    int B, int H, int Hkv, int T_max, int D, int layer, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int kstride = D + VEC;  // padded K row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);  // [G][D], pre-scaled
  float* acc_s = q_s + G * D;                        // [G][D]
  float* s_s = acc_s + G * D;                        // [G][TILE_T]
  float* m_s = s_s + G * TILE_T;                     // [G]
  float* l_s = m_s + G;                              // [G]
  float* alpha_s = l_s + G;                          // [G]
  T* tiles = reinterpret_cast<T*>(q_s + float_slots(G, D));
  // Buffer i: K tile [TILE_T][kstride] then V tile [TILE_T][D].
  T* k_buf[2] = {tiles, tiles + tile_elems<T>(D)};
  T* v_buf[2] = {k_buf[0] + TILE_T * kstride, k_buf[1] + TILE_T * kstride};

  const bool has_self = k_self != nullptr;
  const int p = pos[b];
  // Rows of the cache this query attends: [0, pos) with self, [0, pos] without.
  int live = has_self ? p : p + 1;
  live = max(0, min(live, T_max));

  const size_t row = (((size_t)layer * B + b) * Hkv + kh) * (size_t)T_max * D;
  const T* kp = k_cache + row;
  const T* vp = v_cache + row;
  const int chunks_per_row = D / VEC;

  auto load_tile = [&](int buf, int t0) {
    const int nt = min(TILE_T, live - t0);
    const T* ksrc = kp + (size_t)t0 * D;
    const T* vsrc = vp + (size_t)t0 * D;
    for (int i = tid; i < nt * chunks_per_row; i += THREADS) {
      const int r = i / chunks_per_row;
      const int c = (i - r * chunks_per_row) * VEC;
      __pipeline_memcpy_async(k_buf[buf] + r * kstride + c, ksrc + (size_t)r * D + c, 16);
      __pipeline_memcpy_async(v_buf[buf] + r * D + c, vsrc + (size_t)r * D + c, 16);
    }
    __pipeline_commit();
  };

  const int n_tiles = (live + TILE_T - 1) / TILE_T;
  if (n_tiles > 0) load_tile(0, 0);

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = rtt::to_f32(qb[i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = rtt::NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const int nt = min(TILE_T, live - it * TILE_T);
    if (it + 1 < n_tiles) {
      load_tile(buf ^ 1, (it + 1) * TILE_T);  // that buffer's readers finished last iteration
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();

    // Scores: thread (t, phase) scores cache row t for query rows phase,
    // phase + G_PHASES, ...; whole dot products from 16-byte reads.
    {
      const int t = tid % TILE_T;
      if (t < nt) {
        const T* krow = k_buf[buf] + t * kstride;
        for (int g = tid / TILE_T; g < G; g += G_PHASES) {
          const float* qg = q_s + g * D;
          float acc = 0.f;
          for (int c = 0; c < D; c += VEC) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
            const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc += qg[c + e] * rtt::to_f32(kv[e]);
          }
          s_s[g * TILE_T + t] = acc;
        }
      }
    }
    __syncthreads();

    // Online-softmax statistics: one warp per query row of the group.
    for (int g = warp; g < G; g += WARPS) {
      float* sg = s_s + g * TILE_T;
      float mx = rtt::NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sg[t]);
      mx = rtt::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float pr = expf(sg[t] - m_new);
        sg[t] = pr;
        sum += pr;
      }
      sum = rtt::warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m_prev - m_new);
        alpha_s[g] = a;
        l_s[g] = l_s[g] * a + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V: each thread owns fixed (g, d) entries.
    const T* vt = v_buf[buf];
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = s_s + g * TILE_T;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < nt; ++t) a += pg[t] * rtt::to_f32(vt[t * D + d]);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  if (has_self) {
    // Merge the current token as a final length-1 block.
    const T* ks = k_self + ((size_t)b * Hkv + kh) * D;
    for (int g = warp; g < G; g += WARPS) {
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part += q_s[g * D + d] * rtt::to_f32(ks[d]);
      part = rtt::warp_sum(part);
      if (lane == 0) {
        const float m_new = fmaxf(m_s[g], part);
        const float a = expf(m_s[g] - m_new);
        const float ps = expf(part - m_new);
        alpha_s[g] = a;
        s_s[g * TILE_T] = ps;
        l_s[g] = l_s[g] * a + ps;
      }
    }
    __syncthreads();
    const T* vs = v_self + ((size_t)b * Hkv + kh) * D;
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      const int d = i - g * D;
      acc_s[i] = acc_s[i] * alpha_s[g] + s_s[g * TILE_T] * rtt::to_f32(vs[d]);
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS)
    ob[i] = rtt::from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* pos,
           const void* k_self, const void* v_self, void* out, int B, int H, int Hkv,
           int T_max, int D, int layer, float scale, void* stream) {
  const int G = H / Hkv;
  const size_t smem = float_slots(G, D) * sizeof(float) + 2 * tile_elems<T>(D) * sizeof(T);
  auto kern = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, Hkv);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), static_cast<const int32_t*>(pos),
      static_cast<const T*>(k_self), static_cast<const T*>(v_self), static_cast<T*>(out),
      B, H, Hkv, T_max, D, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// k_self/v_self may both be null (attend [0, pos] of the cache).  Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* pos, const void* k_self,
                                const void* v_self, void* out, int B, int H, int Hkv,
                                int T_max, int D, int layer, float scale, void* stream) {
  switch (dtype) {
    case rtt::kF32:
      return launch<float>(q, k_cache, v_cache, pos, k_self, v_self, out, B, H, Hkv, T_max,
                           D, layer, scale, stream);
    case rtt::kBF16:
      return launch<__nv_bfloat16>(q, k_cache, v_cache, pos, k_self, v_self, out, B, H, Hkv,
                                   T_max, D, layer, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
