// Exact softmax attention at any head width from 1 to 1024, bf16 or f32 in
// and out, f32 scores, softmax and accumulation.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel
// (mha_attention(fast=False)) where the head width is not 64.  The pixel
// baselines (vitvs_tpu/models/baselines.py) have one head of width 3 P^2:
// 48, 192, 588 and 768 for pixel4, 8, 14 and 16.  The TPU kernel's blocks
// are (1, q_tile, D) whatever D is; csrc/attention.cu and
// csrc/attention_f32.cu are built for D = 64 (a K/V row is one 128-byte
// swizzle row and four wgmma k-steps).  This kernel takes any width, in
// f32 FMA on the CUDA cores.
//
// Layout: q, k, v, o are (B, T, H, D) contiguous.  Grid (B * H, 64-row Q
// tiles, 64-wide slices of the output's head dims).  A block of 256
// threads (16 x 16) walks the keys 64 at a time.  For each key block it
// computes the full scores of its 64 rows over every head dim (Q and K
// staged through shared memory 32 dims at a time), scales them by the true
// head width's D^-0.5, keeps the running row max and row sum (an online
// softmax with exp of the max-subtracted logits), and accumulates P.V for
// its own slice of output columns only.  The scores are so computed once
// per output slice, ceil(D / 64) times: the price of the simple design.
// Thread (ty, tx) holds rows ty + 16 i and columns tx + 16 j (keys for S,
// output columns for O), i, j < 4: a row lives in one half-warp, so its
// max and sum reduce by four shuffles, and the shared rows, padded by one
// float, are read without bank conflicts.  Key columns >= T get no mass
// (-inf before the max); the first key block of every row is real, so the
// max is finite (T = 1 included).  Rows >= T and dims >= D are staged as
// zeros and never written.  bf16 inputs: P is rounded to bf16 before P.V,
// as the plain version rounds the probabilities to V's dtype.
//
// Bound on the card (H100 SXM) at pixel14 @ 308, (1, 485, 1, 588) bf16:
// 4 x 570 KB of q, k, v, o in 0.68 us at 3.35 TB/s against 0.55 GFLOP in
// 0.56 us at 989 TFLOP/s: bytes bound it.  This kernel does 10 times the
// score work, in f32 FMA at 67 TFLOP/s at most; its time is in PERF.md.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // query rows a block
constexpr int BK = 64;          // keys a step
constexpr int DV = 64;          // output columns a block
constexpr int DK = 32;          // head dims of a staged Q / K chunk
constexpr int NTHREAD = 256;    // 16 x 16
constexpr int MAX_D = 1024;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// P as P.V takes it: rounded to the inputs' dtype
__device__ __forceinline__ float as_input(float x, const float*) { return x; }
__device__ __forceinline__ float as_input(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(NTHREAD)
attention_hd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int n_tok, int H, int D, float scale) {
    // Q and K chunks while the scores accumulate, then P (they alias)
    __shared__ float qk_s[2 * BQ * (DK + 1)];
    __shared__ float v_s[BK * DV];
    float* q_s = qk_s;
    float* k_s = qk_s + BQ * (DK + 1);
    float* p_s = qk_s;                      // BQ x (BK + 1) <= 2 x BQ x (DK + 1)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int bh = blockIdx.x, q0 = blockIdx.y * BQ, d0 = blockIdx.z * DV;
    const long row_stride = (long)H * D;
    const long base = ((long)(bh / H) * n_tok * H + bh % H) * D;
    const T* qb = q + base;
    const T* kb = k + base;
    const T* vb = v + base;

    float oacc[4][4], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < n_tok; k0 += BK) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

        for (int c0 = 0; c0 < D; c0 += DK) {
            for (int e = tid; e < BQ * DK; e += NTHREAD) {
                const int r = e / DK, c = e % DK;
                const bool in_d = c0 + c < D;
                q_s[r * (DK + 1) + c] =
                    (in_d && q0 + r < n_tok) ? load(qb + (q0 + r) * row_stride + c0 + c) : 0.f;
                k_s[r * (DK + 1) + c] =
                    (in_d && k0 + r < n_tok) ? load(kb + (k0 + r) * row_stride + c0 + c) : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int c = 0; c < DK; ++c) {
                float a[4], b[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * (DK + 1) + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * (DK + 1) + c];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
            }
            __syncthreads();
        }

        // the online softmax of the block's scaled scores; P into shared memory
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float mx = m[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = k0 + tx + 16 * j < n_tok ? s[i][j] * scale : -INFINITY;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float alpha = expf(m[i] - mx);     // m = -inf on the first block: 0
            m[i] = mx;
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - mx);
                sum += p;
                p_s[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = as_input(p, q);
                oacc[i][j] *= alpha;
            }
#pragma unroll
            for (int off = 1; off < 16; off <<= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
        }
        for (int e = tid; e < BK * DV; e += NTHREAD) {
            const int r = e / DV, c = e % DV;
            v_s[e] = (k0 + r < n_tok && d0 + c < D) ? load(vb + (k0 + r) * row_stride + d0 + c)
                                                    : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = p_s[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = v_s[kk * DV + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) oacc[i][j] = fmaf(a[i], b[j], oacc[i][j]);
        }
        __syncthreads();
    }

    T* ob = o + base;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= n_tok) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = d0 + tx + 16 * j;
            if (col < D) store(ob + row * row_stride + col, oacc[i][j] / l[i]);
        }
    }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int n_tok, int H,
           int D, float scale, void* stream) {
    if (B < 1 || n_tok < 1 || H < 1 || D < 1 || D > MAX_D)
        return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(B * H, (n_tok + BQ - 1) / BQ, (D + DV - 1) / DV);
    attention_hd_kernel<T><<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), n_tok, H, D, scale);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, T, H, D) bf16, contiguous, 1 <= D <= 1024; scale D^-0.5
// as f32.  Returns the first CUDA error.
extern "C" int vitvs_attention_hd_fwd(const void* q, const void* k, const void* v, void* o,
                                      int B, int T, int H, int D, float scale, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, o, B, T, H, D, scale, stream);
}

// the same in f32
extern "C" int vitvs_attention_hd_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                          int B, int T, int H, int D, float scale,
                                          void* stream) {
    return launch<float>(q, k, v, o, B, T, H, D, scale, stream);
}
