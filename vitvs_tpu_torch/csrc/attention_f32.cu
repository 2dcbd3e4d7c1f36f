// Exact softmax attention for the ViT in f32: f32 in and out, f32 logits,
// probabilities kept in f32, f32 P.V (the f32 servo step, the reference's
// strict-parity numerics).  The bf16 kernel is csrc/attention.cu.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel
// (mha_attention(fast=False)) on f32 inputs, where it sizes its output as
// q's dtype and its cast of P to v's dtype is a no-op.  Arithmetic: f32 FMA
// on the CUDA cores, not TF32 (a 10-bit mantissa, about 1e-3 relative,
// which would show in the descriptors).  The logits are q.k scaled by
// hd^-0.5 = 0.125 (exact), the softmax takes a running row max, and the
// probabilities exp2((s - m) 0.125 log2(e)) stay f32; the division by the
// row sum comes after P.V (the TPU kernel divides before; the same softmax
// up to rounding).  Key columns >= T get -inf before the max; the first
// 64-key chunk of every row holds a real key, so the max is finite.
//
// Layout: q, k, v, o are (B, T, H, 64) contiguous.  One block computes 32
// query rows of one (batch, head), 128 threads: 8 row groups of 4 rows x
// 16 column groups.  Per 64-key chunk:
//   * S (32 x 64) = Q K^T: each thread holds a 4 x 4 register tile of S
//     (its 4 rows, keys tx + 16 j), reading Q and K rows from shared
//     memory as float4 (rows padded to 68 floats: conflict-free);
//   * the chunk's row max and the rescale of O and of the row sums, with
//     shuffles over the 16 threads of a row group (one half warp);
//   * P through shared memory, stored transposed (key-major, 4 rows of a
//     row group in one float4); the half warp that writes a row group's P
//     is the one that reads it, so a __syncwarp orders the two;
//   * O (32 x 64) += P V: each thread a 4 x 4 tile of O (its rows, head
//     dims 4 tx ..), P and V read as float4.
// In f32 a head's K/V at T = 485 is 248 KB, over the 227 KB a block may
// hold, so K/V stream through a 2-stage cp.async ring of 64-key chunks:
// chunk it + 2 loads while chunk it + 1 waits and chunk it computes.
//
// Bound on the card (H100 SXM) at (1, 485, 6, 64): operations, 0.361 GFLOP
// of f32 FMA in 5.4 us at 67 TFLOP/s, against 2.98 MB of q, k, v, o in
// 0.9 us at 3.35 TB/s.  32-row blocks make 16 x 6 = 96 blocks at that
// shape (64-row ones would leave 84 of the 132 SMs idle); each block's
// 1.99 M FMAs take 8.5 us at the SM's 128 FMA a clock.  What holds it above
// that: shared-memory reads (one float4 per 8 FMAs at a 4 x 4 tile) and
// one block of 4 warps an SM to hide their latency.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int HD = 64;              // head dim
constexpr int BQ = 32;              // query rows a block
constexpr int BK = 64;              // keys a chunk
constexpr int NT = 128;             // 8 row groups x 16 column groups
constexpr int LD = HD + 4;          // f32 row stride of staged Q, K, V rows
constexpr int LDP = BQ + 4;         // row stride of the key-major P
constexpr int STAGES = 2;
constexpr float C = 0.125f * 1.4426950408889634f;   // hd^-0.5 log2(e)
constexpr int SMEM = (BQ * LD + STAGES * 2 * BK * LD + BK * LDP) * 4;   // 87,552 bytes

// rows [r0, r0 + ROWS) of a (T, row_stride) f32 matrix (64 used columns)
// into ROWS x LD floats; rows >= T load as zeros
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int T, long row_stride, int tid) {
#pragma unroll
    for (int i = tid; i < ROWS * (HD / 4); i += NT) {
        const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
        const bool ok = r0 + r < T;
        cp_async16(dst + r * LD + c, ok ? src + (long)(r0 + r) * row_stride + c : src, ok ? 16 : 0);
    }
}

__device__ __forceinline__ void fma4(float (&acc)[4], float x, const float4& y) {
    acc[0] = fmaf(x, y.x, acc[0]);
    acc[1] = fmaf(x, y.y, acc[1]);
    acc[2] = fmaf(x, y.z, acc[2]);
    acc[3] = fmaf(x, y.w, acc[3]);
}

__global__ void __launch_bounds__(NT)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int T, int H) {
    extern __shared__ __align__(16) float smem[];
    float* q_s = smem;                       // BQ x LD
    float* k_s = q_s + BQ * LD;              // STAGES x BK x LD
    float* v_s = k_s + STAGES * BK * LD;     // STAGES x BK x LD
    float* p_s = v_s + STAGES * BK * LD;     // BK x LDP: P, key-major

    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const long row_stride = (long)H * HD;
    const long base = (long)b * T * row_stride + (long)h * HD;
    const int q0 = blockIdx.x * BQ;
    const int nt = (T + BK - 1) / BK;

    // Q with chunk 0, then chunk 1: one commit group each, empty ones included
    load_rows<BQ>(q_s, q + base, q0, T, row_stride, tid);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
        if (st < nt) {
            load_rows<BK>(k_s + st * BK * LD, k + base, st * BK, T, row_stride, tid);
            load_rows<BK>(v_s + st * BK * LD, v + base, st * BK, T, row_stride, tid);
        }
        cp_async_commit();
    }

    float oacc[4][4], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
        m[i] = -INFINITY;
        l[i] = 0.f;
    }

    for (int it = 0; it < nt; ++it) {
        cp_async_wait<STAGES - 1>();   // chunk it has landed (STAGES + it groups committed)
        __syncthreads();               // ... for every thread
        const float* ks = k_s + (it % STAGES) * BK * LD;
        const float* vs = v_s + (it % STAGES) * BK * LD;

        // s[i][j]: row ty * 4 + i, key it * 64 + tx + 16 j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < HD / 4; ++d4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * LD + d4 * 4);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d4 * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }
        const int k0 = it * BK;
        if (k0 + BK > T) {             // the chunk that holds column T
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (k0 + tx + 16 * j >= T) s[0][j] = s[1][j] = s[2][j] = s[3][j] = -INFINITY;
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = fmaxf(fmaxf(m[i], fmaxf(s[i][0], s[i][1])), fmaxf(s[i][2], s[i][3]));
#pragma unroll
            for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
            const float alpha = ex2((m[i] - mx) * C);   // m = -inf on the first chunk: 0
            m[i] = mx;                                  // finite: key 0 of chunk 0 is real
            l[i] *= alpha;
#pragma unroll
            for (int c = 0; c < 4; ++c) oacc[i][c] *= alpha;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = ex2((s[i][j] - mx) * C);
                l[i] += s[i][j];
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float4*>(p_s + (tx + 16 * j) * LDP + ty * 4) =
                make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        __syncwarp();                  // this row group's P, written by its own half warp

#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            const float4 p = *reinterpret_cast<const float4*>(p_s + kk * LDP + ty * 4);
            const float4 vv = *reinterpret_cast<const float4*>(vs + kk * LD + tx * 4);
            fma4(oacc[0], p.x, vv);
            fma4(oacc[1], p.y, vv);
            fma4(oacc[2], p.z, vv);
            fma4(oacc[3], p.w, vv);
        }
        __syncthreads();               // the slot and P are consumed by every thread
        if (it + STAGES < nt) {        // uniform over the block
            load_rows<BK>(k_s + (it % STAGES) * BK * LD, k + base, (it + STAGES) * BK, T,
                          row_stride, tid);
            load_rows<BK>(v_s + (it % STAGES) * BK * LD, v + base, (it + STAGES) * BK, T,
                          row_stride, tid);
        }
        cp_async_commit();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int w = 1; w < 16; w <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
        const int row = q0 + ty * 4 + i;
        if (row < T)
            *reinterpret_cast<float4*>(o + base + (long)row * row_stride + tx * 4) =
                make_float4(oacc[i][0] / l[i], oacc[i][1] / l[i], oacc[i][2] / l[i],
                            oacc[i][3] / l[i]);
    }
}

}  // namespace

// q, k, v, o: (B, T, H, 64) f32, contiguous, 16-byte aligned.  Returns the
// first CUDA error.
extern "C" int vitvs_attention_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int H, void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(attention_f32_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    attention_f32_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), T, H);
    return static_cast<int>(cudaGetLastError());
}
