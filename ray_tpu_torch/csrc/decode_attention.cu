// Single-token decode attention over the layer-stacked KV cache, split
// across blocks along the cache (flash-decoding).
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
// The work stays on f32 FMAs: at G <= 8 query rows a kv head there is too
// little to multiply for the tensor cores to matter.  What the design does
// about the bytes:
//   - grid (B*Hkv, n_split): each block reads `split_t` rows of one (b, kv
//     head) (the wrapper's SPLIT_T, 256), so a row of 2048 cached tokens
//     streams through 8 blocks at once instead of one, and the longest row
//     of the batch no longer sets the time alone; a block whose split starts
//     at or past its row's live length exits at once;
//   - no barrier inside the split: each lane owns a 16-byte chunk of a cache
//     row (D*itemsize/16 lanes a row, 32/that rows a warp step) and streams
//     its own chunks of K and V through a ring of NBUF cp.async slots in
//     shared memory, so NBUF-1 steps are in flight without holding
//     registers and a lane only ever reads what it copied itself; the score
//     is reduced over the lanes of a row by shuffles, and each lane keeps
//     its own online-softmax state (m, l, acc) for its rows and head dims;
//   - the eight warps' states merge through shared memory once per split, in
//     warp order, into the split's partial (m, l, acc[G][D], f32);
//   - a row with one live split writes its output from that partial; with
//     more, each split writes its partial to scratch, and the last block of
//     the (b, kv head) to finish (a __threadfence and an atomicAdd on a
//     per-(b, kv head) counter, which it resets to 0) merges the live
//     partials in split order (their max first, then the sums rescaled to
//     it) — so the result does not depend on which block finished last —
//     then the current token as a final length-1 block, and writes out.
//     A split with no live row is never merged.
//     One launch per layer, as before: no second combine kernel;
//   - only the live prefix is read, cut from cache[layer] by pointer offset
//     (the stacked cache is never sliced or copied).
//
// Requires D * sizeof(T) to be 16 bytes times a power of two up to 512,
// G <= 8 and 16-byte aligned caches (the wrapper checks all three).

#include <cuda_pipeline.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NBUF = 8;  // cp.async steps in flight per lane (ring slots)

// Floats of one split's partial: m[G], l[G], acc[G][D].
__host__ __device__ inline int partial_floats(int G, int D) { return G * (D + 2); }

__host__ inline size_t smem_bytes(int G, int D) {
  const size_t ring = 2 * (size_t)WARPS * NBUF * 32 * 16;  // K and V slots
  // Per-warp states, the split's partial, the self scores and value row,
  // the last flag.
  return ring + ((size_t)(WARPS + 1) * partial_floats(G, D) + G + D + 1) * sizeof(float);
}

// Merge the state (mo, lo, ao) into (m, l, a), both online-softmax states
// over disjoint rows.
__device__ __forceinline__ void merge(float& m, float& l, float& a, float mo, float lo,
                                      float ao) {
  const float mn = fmaxf(m, mo);
  const float x = exp2f((m - mn) * rtt::LOG2E);
  const float y = exp2f((mo - mn) * rtt::LOG2E);
  l = l * x + lo * y;
  a = a * x + ao * y;
  m = mn;
}

template <typename T, int GM>  // GM: G rounded up to a power of two
__global__ void __launch_bounds__(THREADS) decode_attention_kernel(
    const T* __restrict__ q,          // [B, H, D]
    const T* __restrict__ k_cache,    // [L, B, Hkv, T, D]
    const T* __restrict__ v_cache,    // [L, B, Hkv, T, D]
    const int32_t* __restrict__ pos,  // [B]
    const T* __restrict__ k_self,     // [B, Hkv, D] or null
    const T* __restrict__ v_self,     // [B, Hkv, D] or null
    T* __restrict__ out,              // [B, H, D]
    float* __restrict__ part,         // [B*Hkv, n_split, G*(D+2)] scratch
    int* __restrict__ counter,        // [B*Hkv], 0 between launches
    int B, int H, int Hkv, int T_max, int D, int layer, int split_t, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int bkh = blockIdx.x;
  const int b = bkh / Hkv;
  const int kh = bkh - b * Hkv;
  const int split = blockIdx.y;
  const int G = H / Hkv;
  const int PF = partial_floats(G, D);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const bool has_self = k_self != nullptr;
  const int p = pos[b];
  // Rows of the cache this query attends: [0, pos) with self, [0, pos] without.
  int live = has_self ? p : p + 1;
  live = max(0, min(live, T_max));
  const int n_live = (live + split_t - 1) / split_t;  // splits holding a live row
  const int t0 = split * split_t;
  // Split 0 also serves a row with no live cache row (pos 0 with self).
  if (t0 >= live && !(split == 0 && n_live == 0)) return;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* k_ring = reinterpret_cast<uint4*>(smem_raw);  // [WARPS][NBUF][32 lanes]
  uint4* v_ring = k_ring + WARPS * NBUF * 32;
  float* red = reinterpret_cast<float*>(v_ring + WARPS * NBUF * 32);  // [WARPS][PF]
  float* mine = red + WARPS * PF;  // [PF] this split's partial
  float* s_self = mine + PF;       // [G] the current token's scores
  float* vs_s = s_self + G;        // [D] its value row
  int* last = reinterpret_cast<int*>(vs_s + D);

  const T* qb = q + ((size_t)b * H + (size_t)kh * G) * D;
  float* dst = part + ((size_t)bkh * gridDim.y + split) * PF;
  const int CH = D / VEC;   // lanes a cache row
  const int RPS = 32 / CH;  // rows a warp step
  const int rg = lane / CH;
  const int c = lane - rg * CH;

  // The split's K/V copies start first; every other load of the block
  // (q, the current token) overlaps them.
  const size_t base = (((size_t)layer * B + b) * Hkv + kh) * (size_t)T_max * D;
  const T* kp = k_cache + base + c * VEC;
  const T* vp = v_cache + base + c * VEC;
  const int end = min(t0 + split_t, live);
  // Warp steps interleave: step j of warp w reads rows t0 + (j*WARPS + w)*RPS
  // .. + RPS, so the block reads contiguous rows at every step.
  const int n_steps = max(0, (end - t0 + WARPS * RPS - 1) / (WARPS * RPS));
  uint4* kr = k_ring + warp * NBUF * 32 + lane;  // slot s at kr[32 * s]
  uint4* vr = v_ring + warp * NBUF * 32 + lane;
  auto row_of = [&](int j) { return t0 + (j * WARPS + warp) * RPS + rg; };
  auto issue = [&](int j) {
    const int r = row_of(j);
    if (j < n_steps && r < end) {
      __pipeline_memcpy_async(kr + 32 * (j % NBUF), kp + (size_t)r * D, 16);
      __pipeline_memcpy_async(vr + 32 * (j % NBUF), vp + (size_t)r * D, 16);
    }
    __pipeline_commit();  // empty groups keep the count in step
  };
  for (int j = 0; j < NBUF - 1; ++j) issue(j);

  float qr[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qr[g][e] = g < G ? rtt::to_f32(qb[g * D + c * VEC + e]) * scale : 0.f;
  if (has_self) {
    // The current token's scores, in the lane layout of the cache rows;
    // every block computes them, in case it is the one that merges.
    const T* ksb = k_self + ((size_t)b * Hkv + kh) * D + c * VEC;
    float ss[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      ss[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss[g] += qr[g][e] * rtt::to_f32(ksb[e]);
    }
    for (int off = 1; off < CH; off <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) ss[g] += __shfl_xor_sync(0xffffffffu, ss[g], off);
    if (tid == 0)
#pragma unroll
      for (int g = 0; g < GM; ++g)
        if (g < G) s_self[g] = ss[g];
    const T* vsb = v_self + ((size_t)b * Hkv + kh) * D;
    for (int d = tid; d < D; d += THREADS) vs_s[d] = rtt::to_f32(vsb[d]);
  }

  if (n_live > 0) {
    float acc[GM][VEC], m[GM], l[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = rtt::NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
    }
    for (int j = 0; j < n_steps; ++j) {
      issue(j + NBUF - 1);  // into the slot step j-1 read
      __pipeline_wait_prior(NBUF - 1);
      const uint4 kraw = kr[32 * (j % NBUF)];
      const uint4 vraw = vr[32 * (j % NBUF)];
      const T* kv = reinterpret_cast<const T*>(&kraw);
      const T* vv = reinterpret_cast<const T*>(&vraw);
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[g] += qr[g][e] * rtt::to_f32(kv[e]);
      }
      // A row's chunks live in CH neighbouring lanes.
      for (int off = 1; off < CH; off <<= 1)
#pragma unroll
        for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      if (row_of(j) < end) {
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const float mn = fmaxf(m[g], s[g]);
          const float a = exp2f((m[g] - mn) * rtt::LOG2E);
          const float pe = exp2f((s[g] - mn) * rtt::LOG2E);
          l[g] = l[g] * a + pe;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][e] = acc[g][e] * a + pe * rtt::to_f32(vv[e]);
          m[g] = mn;
        }
      }
    }

    // Merge the warp's row groups (lanes CH apart hold the same head dims).
    for (int off = CH; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mn = fmaxf(m[g], mo);
        const float x = exp2f((m[g] - mn) * rtt::LOG2E);
        const float y = exp2f((mo - mn) * rtt::LOG2E);
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = acc[g][e] * x + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * y;
        l[g] = l[g] * x + lo * y;
        m[g] = mn;
      }
    float* wred = red + warp * PF;
    if (rg == 0) {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < VEC; ++e) wred[2 * G + g * D + c * VEC + e] = acc[g][e];
        if (c == 0) {
          wred[g] = m[g];
          wred[G + g] = l[g];
        }
      }
    }
    __syncthreads();

    // The split's partial: the warps merged in warp order.
    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D;
      float mm = rtt::NEG_INF, ll = 0.f, aa = 0.f;
      for (int w = 0; w < WARPS; ++w)
        merge(mm, ll, aa, red[w * PF + g], red[w * PF + G + g], red[w * PF + 2 * G + i]);
      mine[2 * G + i] = aa;
      if (n_live > 1) dst[2 * G + i] = aa;
      if (i - g * D == 0) {
        mine[g] = mm;
        mine[G + g] = ll;
        if (n_live > 1) {
          dst[g] = mm;
          dst[G + g] = ll;
        }
      }
    }

    if (n_live > 1) {
      // Publish the partial; the last of the row's live splits merges.
      // One thread hands off for the block: the barrier orders the block's
      // writes before its acq_rel atomic, and the atomic orders the reads
      // of the other splits' partials after it.
      __syncthreads();
      if (tid == 0) {
        int done;
        asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                     : "=r"(done)
                     : "l"(counter + bkh)
                     : "memory");
        *last = done == n_live - 1;
        if (*last) counter[bkh] = 0;  // ready for the next launch
      }
      __syncthreads();
      if (!*last) return;
    }
  }

  // Final merge, by one block per (b, kv head).
  __syncthreads();

  const float* parts = part + (size_t)bkh * gridDim.y * PF;
  T* ob = out + ((size_t)b * H + (size_t)kh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D;
    float mm = rtt::NEG_INF, ll = 0.f, aa = 0.f;
    if (n_live == 1) {
      merge(mm, ll, aa, mine[g], mine[G + g], mine[2 * G + i]);
    } else {
      // Two passes in split order, the max first, so that no load of a
      // pass waits on the one before it.
#pragma unroll 4
      for (int s = 0; s < n_live; ++s) mm = fmaxf(mm, __ldcg(parts + (size_t)s * PF + g));
#pragma unroll 4
      for (int s = 0; s < n_live; ++s) {
        const float* src = parts + (size_t)s * PF;
        const float w = exp2f((__ldcg(src + g) - mm) * rtt::LOG2E);
        ll += __ldcg(src + G + g) * w;
        aa += __ldcg(src + 2 * G + i) * w;
      }
    }
    if (has_self) merge(mm, ll, aa, s_self[g], 1.f, vs_s[i - g * D]);
    ob[i] = rtt::from_f32<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int GM>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* pos,
           const void* k_self, const void* v_self, void* out, void* part, void* counter, int B,
           int H, int Hkv, int T_max, int D, int layer, int split_t, int n_split, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(H / Hkv, D);
  auto kern = decode_attention_kernel<T, GM>;
  // All of the SM's 228 KB as shared memory, so that as many blocks fit as
  // the registers allow.
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hkv, n_split);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache), static_cast<const T*>(v_cache),
      static_cast<const int32_t*>(pos), static_cast<const T*>(k_self),
      static_cast<const T*>(v_self), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(counter), B, H, Hkv, T_max, D, layer, split_t, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_g(int G, const void* q, const void* k_cache, const void* v_cache, const void* pos,
             const void* k_self, const void* v_self, void* out, void* part, void* counter,
             int B, int H, int Hkv, int T_max, int D, int layer, int split_t, int n_split,
             float scale, cudaStream_t stream) {
  auto fn = &launch<T, 8>;
  if (G <= 4) fn = &launch<T, 4>;
  if (G <= 2) fn = &launch<T, 2>;
  if (G <= 1) fn = &launch<T, 1>;
  return fn(q, k_cache, v_cache, pos, k_self, v_self, out, part, counter, B, H, Hkv, T_max, D,
            layer, split_t, n_split, scale, stream);
}

}  // namespace

// k_self/v_self may both be null (attend [0, pos] of the cache).  `part` is
// f32 scratch of B*Hkv*n_split*G*(D+2) floats and `counter` B*Hkv int32
// zeros, which the kernel leaves zero; both are reused by the next launch,
// so launches that share them must run in stream order.  Returns
// cudaGetLastError() after the launch.
extern "C" int decode_attention(int dtype, const void* q, const void* k_cache,
                                const void* v_cache, const void* pos, const void* k_self,
                                const void* v_self, void* out, void* part, void* counter,
                                int B, int H, int Hkv, int T_max, int D, int layer,
                                int split_t, int n_split, float scale, void* stream) {
  const int G = H / Hkv;
  const int item = dtype == rtt::kF32 ? 4 : 2;
  const int chunks = D * item / 16;
  if (G < 1 || G > 8 || chunks < 1 || chunks > 32 || (chunks & (chunks - 1)) ||
      D * item % 16 || split_t < 1 || n_split < 1)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case rtt::kF32:
      return launch_g<float>(G, q, k_cache, v_cache, pos, k_self, v_self, out, part, counter,
                             B, H, Hkv, T_max, D, layer, split_t, n_split, scale, s);
    case rtt::kBF16:
      return launch_g<__nv_bfloat16>(G, q, k_cache, v_cache, pos, k_self, v_self, out, part,
                                     counter, B, H, Hkv, T_max, D, layer, split_t, n_split,
                                     scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
