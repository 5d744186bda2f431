// Helpers shared by the flash-attention kernels: tile loads into shared
// memory and the mma.sync m16n8k16 bf16 product for flash_ring.cu, and the
// scalar ones (bf16 packing, ex2.approx, quad reductions, paired stores, the
// shared-memory opt-in) that the wgmma kernels flash_fwd.cu and flash_bwd.cu
// take too. The mma.sync kernel runs blocks of 4 warps over 64-row tiles of a
// [b, s, h, d] tensor read through its strides.
//
// Fragment layout of mma.sync.m16n8k16.row.col (g = lane / 4, t = lane % 4):
//   A 16x16 row-major: a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                      a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B 16x8 "col":      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g], so a B
//                      stored as [n][k] (k contiguous) is two 32-bit reads
//   C 16x8 f32:        c0, c1 = C[g][2t, 2t+1],  c2, c3 = C[g+8][2t, 2t+1]
// The C tiles of columns 16kk..16kk+7 and 16kk+8..16kk+15 packed to bf16 are
// the A fragment of k-slice kk, so a product's result feeds the next product
// from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                 // rows of a tile: queries or keys
constexpr int WARPS = TILE / 16;         // 16 rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                   // bf16 row padding in shared memory
constexpr float LOG2E = 1.4426950408889634f;

// element strides of the b, s and h axes of one [b, s, h, d] tensor (d is 1)
struct Axis {
  int64_t b, s, h;
};

template <int D>
struct Rows {
  static constexpr int ROW = D + PAD;      // a [64][D] tile: [row][d]
  static constexpr int T_ROW = TILE + PAD;  // its transpose: [d][row]
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// eight consecutive elements, rounded to bf16, as one 16-byte vector
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 load8(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                    pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + 64) of one (batch, head) slice into a [64][D + PAD] tile;
// rows at or past s are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const T* src,
                                          int64_t row_stride, int row0, int s) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < TILE * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const uint4 v = row0 + r < s ? load8(src + (row0 + r) * row_stride + col)
                                 : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * Rows<D>::ROW + col) = v;
  }
}

// the same rows stored transposed, as a [D][64 + PAD] tile
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(__nv_bfloat16* dst, const T* src,
                                            int64_t row_stride, int row0, int s) {
  constexpr int CHUNKS = D / 8;
  for (int c = threadIdx.x; c < TILE * CHUNKS; c += THREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    const uint4 v = row0 + r < s ? load8(src + (row0 + r) * row_stride + col)
                                 : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[(col + i) * Rows<D>::T_ROW + r] = e[i];
  }
}

// c += a . b for one m16n8k16 tile: a 16x16 row-major, b 16x8, c 16x8 f32
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A fragment of k-slice kk from a tile stored [row][k], for the warp's 16
// rows starting at row 0 of ``rows`` (already offset by g * ROW + 2t)
template <int ROW>
__device__ __forceinline__ void a_frag(uint32_t a[4], const __nv_bfloat16* rows, int kk) {
  a[0] = ld32(rows + kk * 16);
  a[1] = ld32(rows + 8 * ROW + kk * 16);
  a[2] = ld32(rows + kk * 16 + 8);
  a[3] = ld32(rows + 8 * ROW + kk * 16 + 8);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x by the special-function unit (ex2.approx, relative error about 2^-22;
// 2^-inf is 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a block needs more than 48 KB of dynamic shared memory only after it asks
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

}  // namespace
