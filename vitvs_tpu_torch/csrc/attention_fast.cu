// No-max softmax attention for the ViT (the serving variant), bf16 in/out,
// f32 accumulation.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_fast_kernel
// (mha_attention(fast=True)).  Q arrives pre-scaled by hd^-0.5 * log2(e) (in
// Q's dtype, by the wrapper), so a score goes straight through exp2: no
// running max and no rescaling of the accumulator.  The row sums of the f32
// exp2 values and the unnormalized P.V (P rounded to bf16, as on the TPU)
// accumulate over the streamed K/V; 1/denom multiplies the output once at
// the end.  Key columns >= T contribute exactly 0 (the TPU kernel's iota
// select).  Precondition, as on the TPU: bounded logits (|s| < ~80), so
// exp2 neither overflows nor underflows a whole row.
//
// Layout: q, k, v, o are (B, T, H, 64) contiguous.  One block computes 128
// query rows of one (batch, head) with four warpgroups: two row halves of
// 64 rows, each twice, for the two halves of every K/V stage's keys (at
// T = 1370, H = 12: 11 x 12 = 132 blocks of 16 warps, one a SM).  Per
// 64-key block a warpgroup runs, on the bf16 tensor cores:
//   * S (64 x 64) = Q K^T: wgmma m64n64k16, Q from registers (read once from
//     device memory, in the mma A-fragment layout), K from shared memory;
//   * exp2 (one ex2.approx.ftz: bounded logits give no denormal result) and
//     the row sums on the accumulators, which are rounded to bf16 in place
//     as the A fragments of P.V: the wgmma accumulator layout is the A
//     register layout, so no score or P tile touches shared memory;
//   * O (64 x 64) += P V: wgmma with A = P from registers, V from shared
//     memory read transposed (V's rows are keys: an MN-major B).
// K/V stream through a 2-stage ring of 384-key stages filled by cp.async
// into the 128-byte swizzle that wgmma reads (one barrier a stage: stage
// i+1 loads while stage i multiplies); rows >= T load as zeros and only the
// 64-key block that holds column T is masked.  The key-group pairs add
// their O and row sums through shared memory at the end.
//
// Bound on the card (H100 SXM) at T = 1370, H = 12 (ViT-B/14 @ 518):
// 5.77 GFLOP in 5.8 us on the bf16 tensor cores against 8.4 MB in 2.5 us:
// operations bound it.  The exponentials (22.5 M on the SFUs) are not
// overlapped with the products inside a warpgroup; the four warpgroups of
// an SM overlap each other.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int HD = 64;              // head dim: a K or V row is 128 B, one swizzle row
constexpr int BQ = 128;             // query rows per block: 2 warpgroups of 64
constexpr int KSUB = 64;            // keys of one S block
constexpr int KG = 2;               // key groups: warpgroup pairs that split a stage's keys
constexpr int SUBS = 3;             // 64-key blocks of one key group in a stage
constexpr int BK = KSUB * KG * SUBS;   // keys per ring stage: 384
constexpr int STAGES = 2;
constexpr int NTHREAD = 128 * (BQ / 64) * KG;     // 512
constexpr int TILE = BK * HD;       // bf16 elements of one K or V stage
constexpr int SMEM = STAGES * 2 * TILE * 2 + 1024;   // 197,632 bytes: the ring + alignment slack

// rows [r0, r0 + BK) of one head's K and V into a ring stage, 128B-swizzled
__device__ __forceinline__ void load_kv(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                        const __nv_bfloat16* __restrict__ k,
                                        const __nv_bfloat16* __restrict__ v, int r0, int T,
                                        long row_stride, int tid) {
    cp_async_rows_sw128<BK, NTHREAD>(ks, k, r0, T, row_stride, tid);
    cp_async_rows_sw128<BK, NTHREAD>(vs, v, r0, T, row_stride, tid);
}

// One warpgroup's 64 rows against keys [k0, k0 + 64) at shared addresses
// ks_addr (K) and vs_addr (V): S, exp2 and row sums, P.V.
// MASK: some of these columns are >= T and get no mass.
template <bool MASK>
__device__ __forceinline__ void key_block(const uint32_t (&qa)[HD / 16][4], uint32_t ks_addr,
                                          uint32_t vs_addr, int k0, int T, int t4,
                                          float (&oacc)[HD / 8][4], float& sum0, float& sum1) {
    // sacc[n][i]: row g (+8 for i >= 2) of this warp's 16, key k0 + 8n + 2 t4 + (i & 1)
    float sacc[KSUB / 8][4];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < HD / 16; ++s)      // 16 head dims a step: 32 B along K's rows
        wgmma_m64n64k16<0>(sacc, qa[s], gmma_desc<128>(ks_addr + s * 32), s);
    wgmma_commit_wait();

    uint32_t pa[KSUB / 8][2];
#pragma unroll
    for (int n = 0; n < KSUB / 8; ++n) {
        const int col = k0 + n * 8 + 2 * t4;
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = ex2(sacc[n][i]);
        if constexpr (MASK) {
            if (col >= T) e[0] = e[2] = 0.f;
            if (col + 1 >= T) e[1] = e[3] = 0.f;
        }
        sum0 += e[0] + e[1];
        sum1 += e[2] + e[3];
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

__global__ void __launch_bounds__(NTHREAD, 1)
attention_fast_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int T, int H) {
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

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < nt) load_kv(k_s + st * TILE, v_s + st * TILE, kb, vb, st * BK, T, row_stride, tid);
        cp_async_commit();
    }

    // this thread's query rows and their A fragments, 4 k-steps of 16; warp
    // w % 4 of a warpgroup holds rows 16 (w % 4) ... of its 64 (the wgmma layout)
    const int row0 = blockIdx.x * BQ + rw * 16 + g, row1 = row0 + 8;
    const __nv_bfloat16* q0p = q + base + (long)row0 * row_stride + 2 * t4;
    const __nv_bfloat16* q1p = q + base + (long)row1 * row_stride + 2 * t4;
    uint32_t qa[HD / 16][4];
    load_q_bf16(qa, q0p, q1p, row0 < T, row1 < T);

    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;

    for (int it = 0; it < nt; ++it) {
        cp_async_wait<STAGES - 2>();   // stage it has landed
        fence_async_smem();
        __syncthreads();               // ... for every thread, and stage it-1 is consumed
        const int pre = it + STAGES - 1;
        if (pre < nt)
            load_kv(k_s + (pre % STAGES) * TILE, v_s + (pre % STAGES) * TILE, kb, vb, pre * BK, T,
                    row_stride, tid);
        cp_async_commit();
#pragma unroll
        for (int j = 0; j < SUBS; ++j) {
            const int sub = kg * SUBS + j;
            const int k0 = it * BK + sub * KSUB;
            if (k0 >= T) break;        // keys past T only: nothing to add
            const uint32_t ks = smem_addr(k_s + (it % STAGES) * TILE + sub * KSUB * HD);
            const uint32_t vs = smem_addr(v_s + (it % STAGES) * TILE + sub * KSUB * HD);
            if (k0 + KSUB <= T)
                key_block<false>(qa, ks, vs, k0, T, t4, oacc, sum0, sum1);
            else
                key_block<true>(qa, ks, vs, k0, T, t4, oacc, sum0, sum1);
        }
    }

    // the four threads of a group hold the 64 columns of rows g and g + 8
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

    // key group 1 hands its O and row sums to key group 0 through the ring
    cp_async_wait<0>();
    __syncthreads();
    float* o_s = reinterpret_cast<float*>(smem);     // (BQ, HD + 4)
    float* l_s = o_s + BQ * (HD + 4);                // (BQ,)
    const int lr = rw * 16 + g;
    if (kg == 1) {
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            float* p = o_s + lr * (HD + 4) + n * 8 + 2 * t4;
            p[0] = oacc[n][0];
            p[1] = oacc[n][1];
            p[8 * (HD + 4)] = oacc[n][2];
            p[8 * (HD + 4) + 1] = oacc[n][3];
        }
        if (t4 == 0) {
            l_s[lr] = sum0;
            l_s[lr + 8] = sum1;
        }
    }
    __syncthreads();
    if (kg == 1) return;

    const float inv0 = 1.f / (sum0 + l_s[lr]), inv1 = 1.f / (sum1 + l_s[lr + 8]);
    __nv_bfloat16* ob = o + base + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        const float* p = o_s + lr * (HD + 4) + n * 8 + 2 * t4;
        if (row0 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * row_stride + n * 8) =
                __floats2bfloat162_rn((oacc[n][0] + p[0]) * inv0, (oacc[n][1] + p[1]) * inv0);
        if (row1 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * row_stride + n * 8) =
                __floats2bfloat162_rn((oacc[n][2] + p[8 * (HD + 4)]) * inv1,
                                      (oacc[n][3] + p[8 * (HD + 4) + 1]) * inv1);
    }
}

}  // namespace

// q (pre-scaled by 64^-0.5 * log2(e)), k, v, o: (B, T, H, 64) bf16,
// contiguous.  Returns the first CUDA error.
extern "C" int vitvs_attention_fast_fwd(const void* q, const void* k, const void* v, void* o,
                                        int B, int T, int H, void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(attention_fast_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    attention_fast_kernel<<<grid, NTHREAD, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H);
    return static_cast<int>(cudaGetLastError());
}
