// Hopper (sm_90a) building blocks for the bf16 attention kernels, in
// inline PTX: mbarriers, TMA tile loads, wgmma shared-memory descriptors,
// the m64n64k16 bf16 wgmma in both operand forms, and the host-side
// encoding of a TMA tensor map over a [B, S, H, D] tensor.
//
// Layout contract, shared by every kernel that includes this header:
//   - a "box" is 64 rows x 64 bf16 columns (128 bytes a row), loaded by one
//     TMA copy with the 128-byte swizzle into 8 KB of shared memory that is
//     1024-byte aligned; a tile of D = 128 columns is two boxes;
//   - a K-major operand (the contraction dim contiguous: Q and K in Q.K^T)
//     steps along K by 32 bytes inside the 128-byte row;
//   - an MN-major operand (V in P.V, dO and Q in dV/dK) steps along K by
//     16 rows, 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int BOX_ROWS = 64;
constexpr int BOX_COLS = 64;
constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * 2;  // 8 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p: the 128-byte swizzle repeats
// every 8 rows of 128 bytes, and TMA and wgmma agree on it only from such a
// boundary.  Kernels ask for 1024 bytes of slack.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that
// never completes (a pipeline fault) traps after ~2^28 polls instead of
// hanging the card, so the launch fails and the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// --------------------------------------------------------------------- TMA
// One box of a 4-D tensor map at coordinates (d, h, s, b), innermost first;
// completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int d, int h, int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d), "r"(h), "r"(s), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major box: 8-row groups 1024 bytes apart; the leading offset is unused
// under the swizzle.  k-step `ks` (16 columns) starts 32 bytes further in.
__device__ __forceinline__ uint64_t desc_kmajor(const void* box, int ks) {
  return make_desc(static_cast<const char*>(box) + 32 * ks, 16, 1024);
}

// MN-major box: the contraction runs down the rows, 8-row groups 1024 bytes
// apart; k-step `ks` (16 rows) starts 2048 bytes further in.  One box holds
// all 64 columns of the n64 product, so the leading offset (the stride to a
// next 64-column block) is never taken.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* box, int ks) {
  return make_desc(static_cast<const char*>(box) + 2048 * ks, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accumulator registers across the
// asynchronous wgmma issue/wait pair.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RTT_ACC32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define RTT_ACC32_STR                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "      \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], both operands in shared memory.
// A is K-major; B is K-major (TRANS_B = 0) or MN-major (TRANS_B = 1).
// scale_d = 0 overwrites d.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_ACC32_STR
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : RTT_ACC32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// The same with A from registers: a[4] holds the warpgroup's 64 x 16 bf16
// fragment (the layout of the f32 accumulator's 16 columns, packed in pairs).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RTT_ACC32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : RTT_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

#undef RTT_ACC32
#undef RTT_ACC32_STR

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of an m64n64 product as eight A fragments (k-steps of 16
// columns) rounded to bf16: accumulator registers 8k..8k+7 hold exactly the
// rows and columns of fragment k.
__device__ __forceinline__ void acc_to_frag(const float (&d)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

// The accumulator layout: register r of thread (warp w, lane l) of the
// warpgroup holds row w*16 + l/4 + 8*((r/2)&1) and column 8*(r/4) + 2*(l%4)
// + (r&1).
__device__ __forceinline__ int acc_row(int r) { return ((r >> 1) & 1) * 8; }
__device__ __forceinline__ int acc_col(int r) { return (r >> 2) * 8 + (r & 1); }

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so nothing
// links libcuda.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     nullptr);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault);
#endif
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a bf16 [B, S, H, D] tensor with the element strides
// `bsh` of its B, S and H dims (the last dim contiguous), read in boxes of
// 64 rows of S by 64 columns of D at one (b, h), with the 128-byte swizzle.
// Rows past S read as zeros.  Returns false if the driver refuses the map
// (a base not 16-byte aligned, a stride not a multiple of 16 bytes).
static inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                               const long long* bsh) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)bsh[2] * 2, (cuuint64_t)bsh[1] * 2,
                                 (cuuint64_t)bsh[0] * 2};
  const cuuint32_t box[4] = {BOX_COLS, 1, BOX_ROWS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
