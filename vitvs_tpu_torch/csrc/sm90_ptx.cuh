// Inline PTX the Hopper kernels of this directory share: cp.async copies
// into shared memory (16, 8 and 4 bytes, and into the 128-byte swizzle that
// wgmma reads), ldmatrix fragment loads (plain and transposed), the bf16 and
// tf32 mma.sync, the wgmma products (bf16, s8 and tf32) with their
// shared-memory descriptors and the fences around them, transaction barriers
// and st.async stores between the blocks of a cluster, the A fragments of
// bf16 query rows, the TF32 split of an f32 value, and the one-instruction
// exp2.

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

// 8 bytes global -> shared, asynchronous (a source only 8-byte aligned);
// bytes = 0 writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
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

// the four 8 x 8 b16 matrices read transposed: thread lane holds rows
// 2 (lane % 4) and + 1 of column lane / 4 of each (the B fragments of an
// operand stored k-rows first)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// D (16 x 8, f32) += A (16 x 8 tf32) B (8 x 8 tf32).  g = lane / 4, t = lane % 4:
// a = {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}, b = {(t, g), (t + 4, g)},
// d = {(g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
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

// Transaction barriers in shared memory for stores between the blocks of a
// cluster: a consumer arms its barrier with the bytes a phase brings
// (arrive.expect_tx, one arrival), producers write into its shared memory by
// st.async, each store completing its bytes on that barrier, and the phase
// ends when all have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

// the barriers' initialization becomes visible to the cluster (then a cluster barrier)
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// until the phase of the given parity has completed; acquires the cluster's stores
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile("{\n.reg .pred P1;\nLAB_WAIT:\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
                 "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n"
                 :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// the shared::cluster address of local shared address addr in block `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

// stores into another block's shared memory (cluster addresses), each
// completing its bytes on that block's barrier bar
__device__ __forceinline__ void st_async(uint32_t addr, float x, float y, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
                 :: "r"(addr), "f"(x), "f"(y), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                         uint32_t d, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
                 :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async(uint32_t addr, float x, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
                 :: "r"(addr), "f"(x), "r"(bar) : "memory");
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
