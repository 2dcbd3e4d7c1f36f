// Inline PTX the Hopper kernels of this directory share: cp.async copies
// into shared memory (16 and 4 bytes, and into the 128-byte swizzle that wgmma
// reads), ldmatrix fragment loads, the bf16 mma.sync, the wgmma products
// (bf16, s8 and tf32) with their shared-memory descriptors and the fences
// around them, the A fragments of bf16 query rows, the TF32 split of an f32
// value, and the one-instruction exp2.

#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; bytes = 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// 4 bytes global -> shared, asynchronous (a source only 4-byte aligned);
// bytes = 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [r0, r0 + ROWS) of a matrix of 128-byte rows (64 bf16) at row_stride
// elements into a 128B-swizzled tile: 16-byte chunk c of row r lands at
// chunk c ^ (r % 8) of that row.  Rows >= T load as zeros.
template <int ROWS, int NTHREAD>
__device__ __forceinline__ void cp_async_rows_sw128(__nv_bfloat16* dst,
                                                    const __nv_bfloat16* __restrict__ src,
                                                    int r0, int T, long row_stride, int tid) {
#pragma unroll
    for (int i = tid; i < ROWS * 8; i += NTHREAD) {
        const int r = i / 8, c = i % 8;
        const bool ok = r0 + r < T;
        cp_async16(dst + r * 64 + ((c ^ (r & 7)) * 8),
                   ok ? src + (long)(r0 + r) * row_stride + c * 8 : src, ok ? 16 : 0);
    }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&p);
}

// exp2 in one SFU instruction; denormal results flush to 0, exp2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// wgmma matrix descriptor of a swizzled tile whose rows are SWIZZLE bytes
// (128: 64 bf16 or 32 f32, 64: 64 int8), at a shared address that lies a multiple of
// 8 rows from a 1024-aligned base (a k-step inside a row adds its byte
// offset): stride 8 * SWIZZLE bytes between 8-row groups, the leading offset
// unused.  Layout type 1 is the 128-byte swizzle, 2 the 64-byte one.
template <int SWIZZLE>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
    static_assert(SWIZZLE == 128 || SWIZZLE == 64, "128- or 64-byte swizzle");
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(8 * SWIZZLE >> 4) << 32) | ((uint64_t)(SWIZZLE == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
    asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins accumulator registers after wgmma_wait: their reads cannot move above
// it (where other work runs between a product's commit and its wait)
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[8][4]) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[n][i]) :: "memory");
}

// generic-proxy writes to shared memory (cp.async, st.shared) become visible
// to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D (64 x 64, f32) = A (64 x 16 bf16, registers) B (16 x 64 bf16, shared) + (accumulate ? D : 0);
// TRANS_B = 0: B's rows in shared memory are its columns (K-major), 1: its rows (MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
        :
          "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(accumulate));
}

// D (64 x 64, s32) = A (64 x 32 s8, registers) B (32 x 64 s8, shared, K-major)
// + (accumulate ? D : 0).  Integer wgmma takes both operands K-major only.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[8][4], const uint32_t (&a)[4],
                                                   uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n}\n"
        :
          "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The TF32 part of an f32 value: sign, exponent and the top 10 mantissa bits
// (the low 13 cleared by an integer AND; the card converts types at the SFU's
// rate).  x - tf32_hi(x) is exact in f32, and hi.hi + hi.lo + lo.hi is x.y
// up to lo.lo (below 2^-20 |x y|): split-precision (3xTF32) products.
__device__ __forceinline__ float tf32_hi(float x) {
    return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// D (64 x 64, f32) = A (64 x 8 tf32, registers) B (8 x 64 tf32, shared, K-major)
// + (accumulate ? D : 0).  TF32 wgmma takes both operands K-major only (no
// transpose immediates).  A fragment of warp w % 4 of the warpgroup, g =
// lane / 4, t = lane % 4: a[0] (row 16 (w % 4) + g, column t), a[1] (row + 8,
// column t), a[2] (row, column t + 4), a[3] (row + 8, column t + 4).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[8][4], const uint32_t (&a)[4],
                                                    uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        :
          "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// the A fragments of 64 bf16 query rows for wgmma k16 steps: warp w % 4 of a
// warpgroup holds rows 16 (w % 4) + g and + 8 (g = lane / 4); thread t4 =
// lane % 4 holds columns 16 s + 2 t4 (+1) and + 8 of step s.  Rows >= T: 0.
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p, bool ok) {
    return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ void load_q_bf16(uint32_t (&qa)[4][4], const __nv_bfloat16* q0p,
                                            const __nv_bfloat16* q1p, bool ok0, bool ok1) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
        qa[s][0] = ld_bf16x2(q0p + s * 16, ok0);
        qa[s][1] = ld_bf16x2(q1p + s * 16, ok1);
        qa[s][2] = ld_bf16x2(q0p + s * 16 + 8, ok0);
        qa[s][3] = ld_bf16x2(q1p + s * 16 + 8, ok1);
    }
}

}  // namespace
