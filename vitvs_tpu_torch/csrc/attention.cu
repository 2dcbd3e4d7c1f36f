// Exact softmax attention for the ViT, bf16 in/out, f32 accumulation (an
// online softmax).  The no-max serving variant is csrc/attention_fast.cu.
//
// Exact: replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel
// (mha_attention(fast=False)).  On the TPU the whole K/V of one
// (batch, head) sits in VMEM and each Q tile scores against all of it at
// once.  Here that would be 2 x 512 x 64 bf16 = 128 KB per block, beyond
// the 48 KB of static shared memory, so K/V stream through shared memory in
// 64-row tiles with a running row max and sum (online softmax): the result
// is exact softmax up to rounding, and the (T x T) scores never reach
// device memory.
//
// Layout: q, k, v, o are (B, T, H, 64) contiguous; one block computes 64
// query rows of one (batch, head).  Four warps each own 16 query rows and
// run their products on the tensor cores through WMMA (16x16x16 bf16 ->
// f32).  Key columns >= T are masked to -inf; T need not divide the tile.
//
// Bound on the card (H100 SXM): one launch at T = 485, H = 6 moves
// 4 x 372 KB (0.44 us at 3.35 TB/s) and computes 0.36 GFLOP (0.37 us at
// 989 TFLOP/s): bytes bound it.  This first version is far from that bound
// (48 blocks at T = 485, scores staged through shared memory); wgmma/TMA
// and a better work split are later work.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int HD = 64;              // head dim
constexpr int BQ = 64;              // query rows per block
constexpr int BK = 64;              // key rows per tile
constexpr int LDH = HD + 8;         // bf16 row stride in shared memory
constexpr int LDS = BK + 4;         // f32 row stride in shared memory
constexpr int NWARP = BQ / 16;
constexpr int NTHREAD = NWARP * 32;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Copy rows [r0, r0 + 64) of one head into a shared tile; rows >= T are zero.
__device__ __forceinline__ void load_tile(const __nv_bfloat16* __restrict__ src,
                                          __nv_bfloat16* dst, int r0, int T,
                                          long row_stride, int tid) {
    for (int i = tid; i < 64 * (HD / 8); i += NTHREAD) {
        const int r = i / (HD / 8), c8 = i % (HD / 8);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (r0 + r < T)
            val = *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * row_stride + c8 * 8);
        *reinterpret_cast<uint4*>(dst + r * LDH + c8 * 8) = val;
    }
}

__global__ void __launch_bounds__(NTHREAD)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int T, int H, float scale) {
    __shared__ __align__(128) __nv_bfloat16 qp_s[BQ * LDH];  // Q tile, then each warp's P rows
    __shared__ __align__(128) __nv_bfloat16 k_s[BK * LDH];
    __shared__ __align__(128) __nv_bfloat16 v_s[BK * LDH];
    __shared__ __align__(128) float s_s[BQ * LDS];           // scores, then P.V of the tile

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const int q0 = blockIdx.x * BQ;
    const long row_stride = (long)H * HD;
    const long base = (long)b * T * row_stride + (long)h * HD;

    load_tile(q + base, qp_s, q0, T, row_stride, tid);
    __syncthreads();
    FragA qf[HD / 16];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        wmma::load_matrix_sync(qf[kk], qp_s + warp * 16 * LDH + kk * 16, LDH);

    // lanes 2r and 2r+1 own row r of the warp's 16 rows, 32 columns each
    const int r = lane >> 1, half = lane & 1;
    float* s_w = s_s + warp * 16 * LDS;
    __nv_bfloat16* p_w = qp_s + warp * 16 * LDH;
    float m_run = -INFINITY, l_run = 0.f;
    float acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = 0.f;

    for (int k0 = 0; k0 < T; k0 += BK) {
        __syncthreads();                       // the previous tile is consumed
        load_tile(k + base, k_s, k0, T, row_stride, tid);
        load_tile(v + base, v_s, k0, T, row_stride, tid);
        __syncthreads();

        // S (16 x 64) = Q_w K^T
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
            FragC sf;
            wmma::fill_fragment(sf, 0.f);
#pragma unroll
            for (int kk = 0; kk < HD / 16; ++kk) {
                FragBCol kf;
                wmma::load_matrix_sync(kf, k_s + n * 16 * LDH + kk * 16, LDH);
                wmma::mma_sync(sf, qf[kk], kf, sf);
            }
            wmma::store_matrix_sync(s_w + n * 16, sf, LDS, wmma::mem_row_major);
        }
        __syncwarp();

        // softmax numerators of this tile; columns >= T get no mass
        float* srow = s_w + r * LDS + half * 32;
        const int col0 = k0 + half * 32;
        __nv_bfloat16* prow = p_w + r * LDH + half * 32;
        float psum = 0.f;
        float tmax = -INFINITY;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            const float x = (col0 + c < T) ? srow[c] * scale : -INFINITY;
            srow[c] = x;
            tmax = fmaxf(tmax, x);
        }
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        const float m_new = fmaxf(m_run, tmax);      // finite: column k0 < T is real
        const float alpha = __expf(m_run - m_new);   // 0 on the first tile
#pragma unroll
        for (int c = 0; c < 32; ++c) {
            const float p = __expf(srow[c] - m_new);
            psum += p;
            prow[c] = __float2bfloat16(p);
        }
        m_run = m_new;
        psum += __shfl_xor_sync(0xffffffffu, psum, 1);
        l_run = l_run * alpha + psum;
        __syncwarp();

        // P.V (16 x 64) into the warp's score rows, then acc = acc * alpha + P.V
#pragma unroll
        for (int n = 0; n < HD / 16; ++n) {
            FragC of;
            wmma::fill_fragment(of, 0.f);
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk) {
                FragA pf;
                FragBRow vf;
                wmma::load_matrix_sync(pf, p_w + kk * 16, LDH);
                wmma::load_matrix_sync(vf, v_s + kk * 16 * LDH + n * 16, LDH);
                wmma::mma_sync(of, pf, vf, of);
            }
            wmma::store_matrix_sync(s_w + n * 16, of, LDS, wmma::mem_row_major);
        }
        __syncwarp();
        const float* pv = s_w + r * LDS + half * 32;
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] = acc[c] * alpha + pv[c];
    }

    const int qrow = q0 + warp * 16 + r;
    if (qrow < T) {
        const float inv = 1.f / l_run;
        __nv_bfloat16* dst = o + base + (long)qrow * row_stride + half * 32;
#pragma unroll
        for (int c = 0; c < 32; c += 2)
            *reinterpret_cast<__nv_bfloat162*>(dst + c) =
                __floats2bfloat162_rn(acc[c] * inv, acc[c + 1] * inv);
    }
}

}  // namespace

extern "C" const char* vitvs_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (B, T, H, 64) bf16, contiguous.  Returns cudaGetLastError().
extern "C" int vitvs_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int T, int H, void* stream) {
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    attention_kernel<<<grid, NTHREAD, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H,
        0.125f /* 64^-0.5 */);
    return static_cast<int>(cudaGetLastError());
}
