// Exact softmax attention for the ViT, bf16 in/out, f32 scores and
// accumulation (an online softmax).  The no-max serving variant is
// csrc/attention_fast.cu, whose structure this kernel shares.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel
// (mha_attention(fast=False)).  On the TPU the whole K/V of one
// (batch, head) sits in VMEM and each Q tile scores against all of it; its
// Q is pre-scaled by hd^-0.5 = 0.125, exact in bf16.  Here the f32 scores s
// of the unscaled Q go through exp2(s c - m c) with c = 0.125 log2(e) and m
// the running row max, one FFMA and one ex2.approx.ftz a score: the same
// softmax up to rounding.  Key columns >= T get no mass; only the 64-key
// block that holds column T is masked (to -inf, before the max), and the
// first block of every row is real, so the max is finite (T = 1 included).
//
// Layout: q, k, v, o are (B, T, H, 64) contiguous.  One block computes BQ
// query rows (64 or 128) of one (batch, head) with KG key groups of
// warpgroups, 128 threads a 64-row half and key group.  Per 64-key block a
// warpgroup runs, on the bf16 tensor cores:
//   * S (64 x 64) = Q K^T: wgmma m64n64k16, Q from registers (read once from
//     device memory in the A-fragment layout), K from shared memory;
//   * the block's row max (four threads hold a row), the rescale of O and
//     of the row sums by exp2((m_old - m_new) c) (0 on the first block),
//     and exp2 of the scores, rounded to bf16 in place as the A fragments of
//     P.V: the accumulator layout is the A register layout, so no score or P
//     tile touches shared memory;
//   * O (64 x 64) += P V: wgmma with A = P from registers, V from shared
//     memory read transposed (an MN-major B).
// K/V stream through a 2-stage ring of KG * SUBS * 64-key stages filled by
// cp.async into the 128-byte swizzle that wgmma reads: both stages load at
// once, and a stage refills once every thread is done with it.  At the end
// the key groups merge (m, l, O) through shared memory:
// M = max m_j, O = sum O_j 2^((m_j - M) c) / sum l_j 2^((m_j - M) c).
//
// The work split (the entry point picks it; chip_smoke.py times both): at
// T = 485, H = 6 (ViT-S/14 @ 308) 128-row blocks would be 4 x 6 = 24 blocks
// on 132 SMs.  So while 128-row blocks do not fill the SMs, a block takes
// 64 rows and four key groups of one 64-key block a stage (256 keys): the
// whole K/V of a head (2 x 512 x 128 B = 128 KB at T <= 512) sits in the
// ring, as in VMEM on the TPU, and each K/V byte is loaded once per block
// (48 blocks of 512 threads).  At T = 1370, H = 12 (ViT-B/14 @ 518) the
// blocks take 128 rows and two key groups of three 64-key blocks a stage
// (11 x 12 = 132 blocks), K/V streaming through the ring as in the no-max
// kernel.
//
// Bound on the card (H100 SXM): at T = 485, H = 6, 4 x 372 KB of q, k, v, o
// in 0.44 us at 3.35 TB/s against 0.36 GFLOP in 0.37 us at 989 TFLOP/s:
// bytes bound it.  What sets the time there is latency (the first stage's
// load, then two 64-key blocks a warpgroup) and the SMs left idle; at
// T = 1370, H = 12 operations bound it (5.77 GFLOP in 5.8 us).
//
// The bf16-logits variant (BF16L, entry vitvs_attention_bf16l_fwd) is the
// reference's softmax under ViTConfig.softmax_f32 = False (vitvs_tpu/models/
// vit.py:445-447 with bf16 logits, and the int8 'none' mode): the same
// kernel with three roundings to bf16.  The f32 score accumulator is rounded
// to bf16, the einsum's output dtype there; the scale hd^-0.5 = 0.125 is a
// power of two, so its bf16 product is exact and stays folded into C; and
// each unnormalized probability exp2(s c - m c) is rounded to bf16 before
// it enters the row sum and P.V.  The running max, the row sums and O stay
// f32.  ops/attention.py:mha_attention_plain(bf16_logits=True) does the
// same roundings in the same order.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int HD = 64;              // head dim: a K or V row is 128 B, one swizzle row
constexpr int KSUB = 64;            // keys of one S block
constexpr int STAGES = 2;
constexpr float C = 0.125f * 1.4426950408889634f;   // hd^-0.5 log2(e), applied to f32 scores

// BQ_ query rows a block, KG_ key groups, SUBS_ 64-key blocks of a key group a stage
template <int BQ_, int KG_, int SUBS_>
struct Split {
    static constexpr int BQ = BQ_, KG = KG_, SUBS = SUBS_;
    static constexpr int BK = KSUB * KG * SUBS;                  // keys a ring stage
    static constexpr int NTHREAD = 128 * (BQ / 64) * KG;
    static constexpr int TILE = BK * HD;                         // bf16 of one K or V stage
    static constexpr int RING = STAGES * 2 * TILE * 2;
    // the merge: O (f32, rows padded by 4) and (m, l) of key groups 1..
    static constexpr int MERGE = (KG - 1) * BQ * (HD + 4 + 2) * 4;
    static constexpr int SMEM = (RING > MERGE ? RING : MERGE) + 1024;   // + alignment slack
};

using Wide = Split<128, 2, 3>;      // 132 blocks at T = 1370, H = 12: 197,632 B
using Narrow = Split<64, 4, 1>;     // 48 blocks at T = 485, H = 6: 132,096 B

// x rounded to the nearest bf16 (ties to even), as an f32
__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// One warpgroup's 64 rows against keys [k0, k0 + 64) at shared addresses
// ks_addr (K) and vs_addr (V): S, the running max and the rescale, exp2 and
// the row sums, P.V.  m, l: this thread's two rows' running max (of the raw
// scores) and its share of their sums.  MASK: some columns are >= T.  BF16L:
// the scores and the probabilities rounded to bf16 (the bf16-logits variant).
template <bool MASK, bool BF16L>
__device__ __forceinline__ void key_block(const uint32_t (&qa)[HD / 16][4], uint32_t ks_addr,
                                          uint32_t vs_addr, int k0, int T, int t4,
                                          float (&oacc)[HD / 8][4], float (&m)[2],
                                          float (&l)[2]) {
    // sacc[n][i]: row g (+8 for i >= 2) of this warp's 16, key k0 + 8n + 2 t4 + (i & 1)
    float sacc[KSUB / 8][4];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < HD / 16; ++s)      // 16 head dims a step: 32 B along K's rows
        wgmma_m64n64k16<0>(sacc, qa[s], gmma_desc<128>(ks_addr + s * 32), s);
    wgmma_commit_wait();
    if constexpr (BF16L) {
#pragma unroll
        for (int n = 0; n < KSUB / 8; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) sacc[n][i] = round_bf16(sacc[n][i]);
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < KSUB / 8; ++n) {
        if constexpr (MASK) {
            const int col = k0 + n * 8 + 2 * t4;
            if (col >= T) sacc[n][0] = sacc[n][2] = -INFINITY;
            if (col + 1 >= T) sacc[n][1] = sacc[n][3] = -INFINITY;
        }
        mx[0] = fmaxf(mx[0], fmaxf(sacc[n][0], sacc[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[n][2], sacc[n][3]));
    }
    float mc[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {          // the four threads of a group hold a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float alpha = ex2((m[r] - mx[r]) * C);    // m = -inf on the first block: 0
        m[r] = mx[r];                                   // finite: column k0 < T is real
        mc[r] = mx[r] * C;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            oacc[n][2 * r] *= alpha;
            oacc[n][2 * r + 1] *= alpha;
        }
    }

    uint32_t pa[KSUB / 8][2];
#pragma unroll
    for (int n = 0; n < KSUB / 8; ++n) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            e[i] = ex2(fmaf(sacc[n][i], C, -mc[i >> 1]));
            if constexpr (BF16L) e[i] = round_bf16(e[i]);
        }
        l[0] += e[0] + e[1];
        l[1] += e[2] + e[3];
        pa[n][0] = pack_bf16(e[0], e[1]);
        pa[n][1] = pack_bf16(e[2], e[3]);
    }

    wgmma_fence();
#pragma unroll
    for (int j = 0; j < KSUB / 16; ++j) {  // 16 keys a step: 2 swizzle atoms of V's rows
        const uint32_t a[4] = {pa[2 * j][0], pa[2 * j][1], pa[2 * j + 1][0], pa[2 * j + 1][1]};
        wgmma_m64n64k16<1>(oacc, a, gmma_desc<128>(vs_addr + j * 16 * HD * 2), 1);
    }
    wgmma_commit_wait();
}

template <class S, bool BF16L>
__global__ void __launch_bounds__(S::NTHREAD, 1)
attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int T, int H) {
    constexpr int BQ = S::BQ, KG = S::KG, SUBS = S::SUBS;
    constexpr int BK = S::BK, NTHREAD = S::NTHREAD, TILE = S::TILE;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the swizzle is a function of address bits: the ring starts 1024-aligned
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* v_s = k_s + STAGES * TILE;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;          // mma groupID, thread in group
    const int rw = warp % (BQ / 16), kg = warp / (BQ / 16);   // 16-row slice, key group
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const long row_stride = (long)H * HD;
    const long base = (long)b * T * row_stride + (long)h * HD;
    const __nv_bfloat16* kb = k + base;
    const __nv_bfloat16* vb = v + base;
    const int nt = (T + BK - 1) / BK;

    // every slot of the ring loads at once (at T <= 512 with 64-row blocks:
    // the whole K/V); one commit group a stage, empty ones included
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
        if (st < nt) {
            cp_async_rows_sw128<BK, NTHREAD>(k_s + st * TILE, kb, st * BK, T, row_stride, tid);
            cp_async_rows_sw128<BK, NTHREAD>(v_s + st * TILE, vb, st * BK, T, row_stride, tid);
        }
        cp_async_commit();
    }

    const int row0 = blockIdx.x * BQ + rw * 16 + g, row1 = row0 + 8;
    uint32_t qa[HD / 16][4];
    load_q_bf16(qa, q + base + (long)row0 * row_stride + 2 * t4,
                q + base + (long)row1 * row_stride + 2 * t4, row0 < T, row1 < T);

    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    for (int it = 0; it < nt; ++it) {
        cp_async_wait<STAGES - 1>();   // stage it has landed (STAGES + it groups committed)
        fence_async_smem();
        __syncthreads();               // ... for every thread
        const int slot = it % STAGES;
#pragma unroll
        for (int j = 0; j < SUBS; ++j) {
            const int sub = kg * SUBS + j;
            const int k0 = it * BK + sub * KSUB;
            if (k0 >= T) break;        // keys past T only: nothing to add
            const uint32_t ks = smem_addr(k_s + slot * TILE + sub * KSUB * HD);
            const uint32_t vs = smem_addr(v_s + slot * TILE + sub * KSUB * HD);
            if (k0 + KSUB <= T)
                key_block<false, BF16L>(qa, ks, vs, k0, T, t4, oacc, m, l);
            else
                key_block<true, BF16L>(qa, ks, vs, k0, T, t4, oacc, m, l);
        }
        if (it + STAGES < nt) {        // uniform over the block
            __syncthreads();           // the slot is consumed by every thread
            cp_async_rows_sw128<BK, NTHREAD>(k_s + slot * TILE, kb, (it + STAGES) * BK, T,
                                             row_stride, tid);
            cp_async_rows_sw128<BK, NTHREAD>(v_s + slot * TILE, vb, (it + STAGES) * BK, T,
                                             row_stride, tid);
        }
        cp_async_commit();
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {          // the four threads of a group: one row's sum
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    // key groups 1.. hand their (m, l) and O to key group 0 through the ring
    cp_async_wait<0>();
    __syncthreads();
    float* o_s = reinterpret_cast<float*>(smem);            // (KG - 1, BQ, HD + 4)
    float* ml_s = o_s + (KG - 1) * BQ * (HD + 4);          // (KG - 1, BQ, 2): m, l
    const int lr = rw * 16 + g;
    if (kg > 0) {
        if (t4 == 0) {
            float* ml = ml_s + ((kg - 1) * BQ + lr) * 2;
            ml[0] = m[0];
            ml[1] = l[0];
            ml[16] = m[1];
            ml[17] = l[1];
        }
        float* p = o_s + ((kg - 1) * BQ + lr) * (HD + 4) + 2 * t4;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            p[n * 8] = oacc[n][0];
            p[n * 8 + 1] = oacc[n][1];
            p[8 * (HD + 4) + n * 8] = oacc[n][2];
            p[8 * (HD + 4) + n * 8 + 1] = oacc[n][3];
        }
    }
    __syncthreads();
    if (kg > 0) return;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int rr = lr + 8 * r;
        float M = m[r];
#pragma unroll
        for (int j = 1; j < KG; ++j) M = fmaxf(M, ml_s[((j - 1) * BQ + rr) * 2]);
        // M is finite (group 0's first block is real); a group with no key
        // block has m = -inf and weight 0
        const float f0 = ex2((m[r] - M) * C);
        float L = l[r] * f0;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            oacc[n][2 * r] *= f0;
            oacc[n][2 * r + 1] *= f0;
        }
#pragma unroll
        for (int j = 1; j < KG; ++j) {
            const float* ml = ml_s + ((j - 1) * BQ + rr) * 2;
            const float fj = ex2((ml[0] - M) * C);
            L += ml[1] * fj;
            const float* p = o_s + ((j - 1) * BQ + rr) * (HD + 4) + 2 * t4;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
                oacc[n][2 * r] += p[n * 8] * fj;
                oacc[n][2 * r + 1] += p[n * 8 + 1] * fj;
            }
        }
        inv[r] = 1.f / L;
    }

    __nv_bfloat16* ob = o + base + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        if (row0 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * row_stride + n * 8) =
                __floats2bfloat162_rn(oacc[n][0] * inv[0], oacc[n][1] * inv[0]);
        if (row1 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * row_stride + n * 8) =
                __floats2bfloat162_rn(oacc[n][2] * inv[1], oacc[n][3] * inv[1]);
    }
}

template <class S, bool BF16L>
int launch(const void* q, const void* k, const void* v, void* o, int B, int T, int H,
           cudaStream_t stream) {
    const cudaError_t err = cudaFuncSetAttribute(attention_kernel<S, BF16L>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + S::BQ - 1) / S::BQ, B * H);
    attention_kernel<S, BF16L><<<grid, S::NTHREAD, S::SMEM, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H);
    return static_cast<int>(cudaGetLastError());
}

// split 1: 64-row blocks with four key groups, 2: 128-row blocks with two,
// 0: 128-row blocks when they fill the SMs, else 64-row ones
template <bool BF16L>
int run(const void* q, const void* k, const void* v, void* o, int B, int T, int H, int split,
        void* stream) {
    if (split == 0) {
        int dev = 0, sms = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return static_cast<int>(err);
        split = (long)((T + Wide::BQ - 1) / Wide::BQ) * B * H >= sms ? 2 : 1;
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (split == 2) return launch<Wide, BF16L>(q, k, v, o, B, T, H, st);
    return launch<Narrow, BF16L>(q, k, v, o, B, T, H, st);
}

}  // namespace

extern "C" const char* vitvs_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, o: (B, T, H, 64) bf16, contiguous; split as run's.  Returns the
// first CUDA error.
extern "C" int vitvs_attention_split_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int T, int H, int split, void* stream) {
    return run<false>(q, k, v, o, B, T, H, split, stream);
}

// the split that fills the card (split 0)
extern "C" int vitvs_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int T, int H, void* stream) {
    return run<false>(q, k, v, o, B, T, H, 0, stream);
}

// the bf16-logits variant, at the split that fills the card
extern "C" int vitvs_attention_bf16l_fwd(const void* q, const void* k, const void* v, void* o,
                                         int B, int T, int H, void* stream) {
    return run<true>(q, k, v, o, B, T, H, 0, stream);
}
