// Fused int8-QK^T attention for the int8 serving ViT: int8 scores with a
// dequantizing FMA, a no-max exp2 softmax and bf16 P.V, in one kernel.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attn_int8.py:_kernel
// (fused_int8_attention).  Q and K arrive as int8 per (token, head) with
// f32 scales (attn_int8.py:_quant_th, outside the kernel; the Q scales carry
// hd^-0.5 * log2(e)), V in bf16, all in the ViT's natural (B, T, H*64)
// layout: Q and K contiguous, V read in place with its own row stride (the
// column slice of the qkv output, row stride 3 * H * 64), so no head
// transpose is ever written.  The output is (B, T, H*64) bf16, contiguous.
//
// The TPU kernel loops the heads inside one program over a (TQ, T) score
// tile resident in VMEM.  Here one block computes 64 query rows of one
// (batch, head), and the heads are a grid axis; K/V stream through shared
// memory in 64-row tiles.  Each of the four warps owns 16 query rows:
//   * S = Q K^T on the int8 tensor cores (mma.sync m16n8k32 s8 -> s32);
//   * s = (acc * qs_row) * ks_col, e = exp2(s), no running max: the logits
//     are bounded (|s| < ~80 after scaling), as on the TPU; key columns
//     >= T get e = 0 (the TPU's -1e30 bias row gives the same 0);
//   * f32 row sums of e, and e rounded to bf16 feeds P.V (mma.sync
//     m16n8k16 bf16 -> f32) straight from registers: the accumulator layout
//     of the score product is the A-operand layout of the P.V product;
//   * 1/denom multiplies the (16 x 64) output once at the end.
// The int32 sums are exact in f32 (|acc| <= 64 * 127^2 < 2^24).
//
// Bound on the card (H100 SXM) at B = 1, T = 1370, H = 12 (ViT-B/14 @ 518):
// 2.9 G int8 operations in 1.5 us at 1979 TOPS plus 2.9 GFLOP of bf16 P.V in
// 2.9 us at 989 TFLOP/s, against 6.4 MB read and written in 1.9 us:
// operations bound it.  This first version keeps every K/V tile in plain
// shared-memory loads; wgmma/TMA are later work.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int HD = 64;              // head dim
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // key rows per tile
constexpr int LDK = HD + 16;        // int8 row stride of the K tile in shared memory (bytes)
constexpr int LDV = HD + 8;         // bf16 row stride of the V tile in shared memory
constexpr int NWARP = BQ / 16;
constexpr int NTHREAD = NWARP * 32;

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0, int b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 p;
    p.x = lo;
    p.y = hi;
    return *reinterpret_cast<uint32_t*>(&p);
}

__global__ void __launch_bounds__(NTHREAD)
attn_int8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ qs,
                 const float* __restrict__ ks, __nv_bfloat16* __restrict__ o,
                 int T, int H, long v_bstride, long v_rstride) {
    __shared__ __align__(16) int8_t k_s[BK * LDK];
    __shared__ __align__(16) __nv_bfloat16 v_s[BK * LDV];
    __shared__ float ks_s[BK];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;      // mma groupID, thread in group
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const long D = (long)H * HD;
    const int8_t* qb = q + (long)b * T * D + h * HD;
    const int8_t* kb = k + (long)b * T * D + h * HD;
    const __nv_bfloat16* vb = v + b * v_bstride + h * HD;
    const float* ksb = ks + (long)(b * H + h) * T;

    // this thread's query rows and their Q fragments (two k-steps of 32)
    const int row0 = blockIdx.x * BQ + warp * 16 + g, row1 = row0 + 8;
    int qa[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int c = s * 32 + t4 * 4;
        qa[s][0] = row0 < T ? *reinterpret_cast<const int*>(qb + row0 * D + c) : 0;
        qa[s][1] = row1 < T ? *reinterpret_cast<const int*>(qb + row1 * D + c) : 0;
        qa[s][2] = row0 < T ? *reinterpret_cast<const int*>(qb + row0 * D + c + 16) : 0;
        qa[s][3] = row1 < T ? *reinterpret_cast<const int*>(qb + row1 * D + c + 16) : 0;
    }
    const float qs0 = row0 < T ? qs[((long)b * T + row0) * H + h] : 0.f;
    const float qs1 = row1 < T ? qs[((long)b * T + row1) * H + h] : 0.f;

    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
        oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;

    for (int k0 = 0; k0 < T; k0 += BK) {
        __syncthreads();                       // the previous tile is consumed
        for (int i = tid; i < BK * (HD / 16); i += NTHREAD) {      // K: 16 bytes a load
            const int r = i / (HD / 16), c16 = i % (HD / 16);
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + r < T) val = *reinterpret_cast<const uint4*>(kb + (k0 + r) * D + c16 * 16);
            *reinterpret_cast<uint4*>(k_s + r * LDK + c16 * 16) = val;
        }
        for (int i = tid; i < BK * (HD / 8); i += NTHREAD) {       // V: 8 bf16 a load
            const int r = i / (HD / 8), c8 = i % (HD / 8);
            uint4 val = make_uint4(0u, 0u, 0u, 0u);                // rows >= T: 0, not garbage
            if (k0 + r < T) val = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_rstride + c8 * 8);
            *reinterpret_cast<uint4*>(v_s + r * LDV + c8 * 8) = val;
        }
        if (tid < BK) ks_s[tid] = k0 + tid < T ? ksb[k0 + tid] : 0.f;
        __syncthreads();

        // S (16 x 64) = Q_w K^T in int32: 8 column tiles of 8 keys
        int sacc[BK / 8][4];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
            sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0;
            const int8_t* krow = k_s + (n * 8 + g) * LDK + t4 * 4;
#pragma unroll
            for (int s = 0; s < 2; ++s)
                mma_s8(sacc[n], qa[s], *reinterpret_cast<const int*>(krow + s * 32),
                       *reinterpret_cast<const int*>(krow + s * 32 + 16));
        }

        // dequant, exp2, row sums; P in bf16 as A fragments of P.V
        uint32_t pa[BK / 8][2];
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
            const int c = n * 8 + t4 * 2;
            float e[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int col = c + (i & 1);
                const float s = ((float)sacc[n][i] * (i < 2 ? qs0 : qs1)) * ks_s[col];
                e[i] = k0 + col < T ? exp2f(s) : 0.f;
            }
            sum0 += e[0] + e[1];
            sum1 += e[2] + e[3];
            pa[n][0] = pack_bf16(e[0], e[1]);
            pa[n][1] = pack_bf16(e[2], e[3]);
        }

        // O (16 x 64) += P (16 x 64 keys) V (64 keys x 64): 4 k-steps of 16 keys
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
            const uint32_t a[4] = {pa[2 * j][0], pa[2 * j][1], pa[2 * j + 1][0], pa[2 * j + 1][1]};
            const __nv_bfloat16* v0 = v_s + (j * 16 + t4 * 2) * LDV + g;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
                const __nv_bfloat16* vp = v0 + n * 8;
                mma_bf16(oacc[n], a, pack_bf16(vp[0], vp[LDV]),
                         pack_bf16(vp[8 * LDV], vp[9 * LDV]));
            }
        }
    }

    // the four threads of a group hold the 64 columns of rows g and g + 8
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    __nv_bfloat16* ob = o + (long)b * T * D + h * HD + t4 * 2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        if (row0 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + row0 * D + n * 8) =
                __floats2bfloat162_rn(oacc[n][0] * inv0, oacc[n][1] * inv0);
        if (row1 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + row1 * D + n * 8) =
                __floats2bfloat162_rn(oacc[n][2] * inv1, oacc[n][3] * inv1);
    }
}

}  // namespace

// q, k: (B, T, H*64) int8, contiguous; v: bf16 rows of H*64 at row stride
// v_rstride and batch stride v_bstride (elements); qs: (B, T, H) f32; ks:
// (B, H, T) f32; o: (B, T, H*64) bf16, contiguous.  Returns cudaGetLastError().
extern "C" int vitvs_attn_int8_fwd(const void* q, const void* k, const void* v, const void* qs,
                                   const void* ks, void* o, int B, int T, int H,
                                   long v_bstride, long v_rstride, void* stream) {
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    attn_int8_kernel<<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(qs),
        static_cast<const float*>(ks), static_cast<__nv_bfloat16*>(o), T, H, v_bstride,
        v_rstride);
    return static_cast<int>(cudaGetLastError());
}
