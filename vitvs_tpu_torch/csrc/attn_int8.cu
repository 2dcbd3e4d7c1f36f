// Fused int8-QK^T attention for the int8 serving ViT, with its Q/K
// quantization: per-(token, head) int8 Q and K, int8 scores with a
// dequantizing FMA, a no-max exp2 softmax and bf16 P.V, in one kernel.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attn_int8.py:_kernel
// (fused_int8_attention) and the quantization ahead of it (_quant_th).  The
// kernel takes the bf16 q, k, v column slices of the qkv output as they are
// (the ViT's natural (B, T, H*64) layout, row stride 3 * H * 64 on the main
// path) and reads all three in place, so no head transpose, int8 tensor or
// scale tensor is ever written.  The output is (B, T, H*64) bf16, contiguous.
//
// Quantization is local to one row: the amax of a (token, head) runs over
// the 64 values of one 128-byte row segment.  quant_row is _quant_th's
// arithmetic bit for bit: s = max(amax, 1e-12) * f32(1/127) (the jitted
// reference's reciprocal multiply), inv = bf16(1 / s),
// q = clamp(rint(bf16(x * inv)), -127, 127);
// the returned scale is max(amax, 1e-12) times the wrapper's factor, which is
// f32(1/127) for K and f32(f32(1/127) * hd^-0.5 log2(e)) for Q: XLA folds the
// reference's (amax / 127) * c into amax * (f32(1/127) * c).  A block quantizes its own Q rows once, in the registers that feed
// the products, and each K row as the row enters shared memory.
// vitvs_quant_th_probe runs the same quant_row calls on a whole matrix so
// that a test can hold them to _quant_th.
//
// The quantizer keeps type conversions out: the card converts (I2F, F2I,
// FRND, F2F) at 16 a clock an SM, the rate of ex2, and a first version that
// converted each score once and each quantized element three times ran at
// 1.8x the no-max kernel's time.  Here x * inv is one bf16x2 FMA, the clamp
// one bf16x2 min.xorsign.abs, the round half to even a 1.5 * 2^23 FADD, and
// the int32 product sums become f32 through the same constant.
//
// Layout as the no-max kernel (csrc/attention_fast.cu): one block computes
// 128 query rows of one (batch, head) with four warpgroups, two row halves
// of 64 rows, each twice, for the two key groups of every stage's 384 keys
// (at T = 1370, H = 12: 11 x 12 = 132 blocks of 16 warps).  Per stage:
//   * K's bf16 rows land in a staging tile (cp.async), four threads a row,
//     and the thread that copied a quarter row quantizes it into one of two
//     int8 tiles in the 64-byte swizzle (half the no-max kernel's K bytes),
//     with the row scales: its own cp.async wait is all it waits for, so the
//     quantization of the next stage runs while this stage's P.V products
//     are in flight on the tensor cores (one barrier a stage);
//   * V's bf16 rows stream through a 2-stage cp.async ring in the 128-byte
//     swizzle, the next stage loading while this one multiplies.
// Per 64-key block a warpgroup runs:
//   * S (64 x 64, s32) = Q K^T: wgmma m64n64k32 s8.s8.s32 (two k-steps), Q
//     from registers, K from shared memory; integer wgmma takes both
//     operands K-major, and Q and K rows are both hd-contiguous;
//   * s = (acc * qs_row) * ks_col in f32 (exact int32 sums: |acc| <= 64 *
//     127^2 < 2^24), e = exp2(s) in one ex2.approx.ftz, no running max: the
//     logits are bounded (|s| < ~80 after scaling), as on the TPU; only the
//     block holding column T is masked (the TPU's -1e30 bias gives the same
//     0); f32 row sums, and e rounded to bf16 in place as the A fragments of
//     P.V (the accumulator layout is the A register layout);
//   * O (64 x 64) += P V: bf16 wgmma m64n64k16, V read as an MN-major B.
// The key groups add their O and row sums through shared memory; 1/denom
// multiplies the output once.
//
// Bound on the card (H100 SXM) at B = 1, T = 1370, H = 12 (ViT-B/14 @ 518):
// 2.9 G int8 operations in 1.5 us at 1979 TOPS plus 2.9 GFLOP of bf16 P.V in
// 2.9 us at 989 TFLOP/s, against 8.4 MB of bf16 q, k, v read and o written
// in 2.5 us: operations bound it.  What the kernel adds to the no-max one:
// the quantization of K, which each of a head's 11 blocks repeats for all
// its 1370 rows, and the dequantizing multiplies.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int HD = 64;              // head dim: a bf16 row is 128 B, an int8 row 64 B
constexpr int BQ = 128;             // query rows per block: 2 warpgroups of 64
constexpr int KSUB = 64;            // keys of one S block
constexpr int KG = 2;               // key groups: warpgroup pairs that split a stage's keys
constexpr int SUBS = 3;             // 64-key blocks of one key group in a stage
constexpr int BK = KSUB * KG * SUBS;   // keys per stage: 384
constexpr int STAGES = 2;           // of the V ring and of the int8 K tiles with their scales
constexpr int NTHREAD = 128 * (BQ / 64) * KG;     // 512
constexpr int QPT = BK * 4 / NTHREAD;             // quarter K rows a thread quantizes a stage: 3
static_assert(BK * 4 % NTHREAD == 0, "every thread quantizes whole quarter rows");
// shared memory, from a 1024-aligned base: the V ring (128B swizzle), the
// int8 K tiles (64B swizzle), the bf16 K staging tile, the K row scales
constexpr int V_BYTES = STAGES * BK * HD * 2;      // 98,304
constexpr int K8_BYTES = STAGES * BK * HD;         // 49,152
constexpr int KST_BYTES = BK * HD * 2;             // 49,152
constexpr int SMEM = V_BYTES + K8_BYTES + KST_BYTES + STAGES * BK * 4 + 1024;   // 200,704

// bf16x2 arithmetic on words of two bf16 values (the first in the low half)
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
    uint32_t d;   // a * b rounded once to bf16 (the -0 addend keeps a zero's sign)
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
    return d;
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
    uint32_t d;
    asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
    return d;
}

// each half of a clamped to [-127, 127] in one instruction: min(|a|, 127)
// with the sign of a (127's sign bit is 0)
__device__ __forceinline__ uint32_t bf16x2_clamp127(uint32_t a) {
    uint32_t d;
    asm("min.xorsign.abs.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0x42FE42FEu));
    return d;
}

// 1.5 * 2^23: for |y| < 2^22, y + MAGIC rounds y to an integer (half to
// even, the FADD's rounding) held in the low bits of the sum, and the bits
// of MAGIC plus an integer i are the float MAGIC + i.  Both keep the
// conversions (16 a clock an SM, the rate of ex2) out of the inner loops.
constexpr float MAGIC = 12582912.f;
// f32(1/127), bits 0x3C010204
constexpr float INV127 = 0.007874015718698502f;
constexpr uint32_t MAGIC_BITS = 0x4B400000u;

// One (token, head) row of 64 bf16 values, spread over LANES consecutive
// lanes (a power of 2) that hold N values each (x: N / 2 words of bf16
// pairs), to int8 (four a word, the first in the low byte) in _quant_th's
// arithmetic: amax in bf16; s = max(amax, 1e-12) * f32(1/127), as XLA
// computes the reference's division by 127 under jit; inv = bf16(1 / s);
// q = rint(clamp(bf16(x * inv), -127, 127)),
// which is clamp(rint(.)) for integer bounds.  Returns max(amax, 1e-12)
// times ``factor`` (f32; INV127 gives s itself).  Every lane of the warp must
// call it.
template <int N, int LANES>
__device__ __forceinline__ float quant_row(const uint32_t (&x)[N / 2], uint32_t (&w)[N / 4],
                                           float factor) {
    static_assert(N * LANES == HD && N % 4 == 0, "a row is 64 values");
    uint32_t m2 = 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) m2 = bf16x2_max(m2, x[i] & 0x7FFF7FFFu);
    float amax = fmaxf(__uint_as_float(m2 << 16), __uint_as_float(m2 & 0xFFFF0000u));
#pragma unroll
    for (int off = 1; off < LANES; off *= 2)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float a = fmaxf(amax, 1e-12f);
    const float s = __fmul_rn(a, INV127);
    const uint32_t inv = __bfloat16_as_ushort(__float2bfloat16_rn(__frcp_rn(s)));
    const uint32_t inv2 = inv | (inv << 16);
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
        uint32_t b[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t y = bf16x2_clamp127(bf16x2_mul(x[2 * j + h], inv2));
            b[2 * h] = __float_as_uint(__uint_as_float(y << 16) + MAGIC);
            b[2 * h + 1] = __float_as_uint(__uint_as_float(y & 0xFFFF0000u) + MAGIC);
        }
        // the low byte of each sum is the int8 value
        w[j] = __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040),
                           0x5410);
    }
    return __fmul_rn(a, factor);
}

// an int32 product sum as f32, exact for |i| < 2^22 (|acc| <= 64 * 127^2)
__device__ __forceinline__ float i2f(int i) {
    return __uint_as_float(MAGIC_BITS + static_cast<uint32_t>(i)) - MAGIC;
}

// The 16 values of query row p a thread feeds to the s8 A fragments: columns
// 4 t4 .. 4 t4 + 3 of each 16-column quarter (k-step s = quarter / 2, the
// low or high 16 of its 32).  Rows >= T: zeros.
__device__ __forceinline__ void load_q_row(uint32_t (&x)[8], const __nv_bfloat16* p, int t4,
                                           bool ok) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const uint2 raw =
            ok ? *reinterpret_cast<const uint2*>(p + c * 16 + 4 * t4) : make_uint2(0u, 0u);
        x[2 * c] = raw.x;
        x[2 * c + 1] = raw.y;
    }
}

// quant_row over the query rows of a thread: words (cols 4 t4 + 16 c) are the
// A fragments qa[c / 2][(c % 2) * 2 + half] of wgmma k32 (half 0: row g, 1: row g + 8)
__device__ __forceinline__ float quant_q_row(uint32_t (&qa)[2][4], int half,
                                             const __nv_bfloat16* p, int t4, bool ok,
                                             float q_scale) {
    uint32_t x[8];
    load_q_row(x, p, t4, ok);
    uint32_t w[4];
    const float s = quant_row<16, 4>(x, w, q_scale);
#pragma unroll
    for (int c = 0; c < 4; ++c) qa[c / 2][(c % 2) * 2 + half] = w[c];
    return s;
}

// A quarter of a K row, 16-byte chunks t4 and t4 + 4 (columns 8 t4 ... and
// 32 + 8 t4 ...), through quant_row with four lanes a row; out0, out1: the
// int8 values of the two chunks
__device__ __forceinline__ float quant_k_quarter(uint2& out0, uint2& out1, const uint4 lo,
                                                 const uint4 hi, float extra) {
    const uint32_t x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t w[4];
    const float s = quant_row<16, 4>(x, w, extra);
    out0 = make_uint2(w[0], w[1]);
    out1 = make_uint2(w[2], w[3]);
    return s;
}

// byte offset of 16-byte chunk c of row r in a 64B-swizzled tile of 64-byte
// rows: chunk c ^ ((r / 2) % 4), the address bits [4, 6) xor [7, 9)
__device__ __forceinline__ int sw64(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// One warpgroup's 64 rows against keys [k0, k0 + 64): K int8 at k8_addr, its
// row scales at ks, V at vs_addr.  MASK: some of these columns are >= T.
// overlap() runs while P.V is in flight (it must not touch O, P or Q); under
// P.V fewer registers are live than under Q K^T.
template <bool MASK, class Overlap>
__device__ __forceinline__ void key_block(const uint32_t (&qa)[2][4], float qs0, float qs1,
                                          uint32_t k8_addr, const float* ks, uint32_t vs_addr,
                                          int k0, int T, int t4, float (&oacc)[HD / 8][4],
                                          float& sum0, float& sum1, Overlap&& overlap) {
    int sacc[KSUB / 8][4];
    wgmma_fence();
    wgmma_m64n64k32_s8(sacc, qa[0], gmma_desc<64>(k8_addr), 0);
    wgmma_m64n64k32_s8(sacc, qa[1], gmma_desc<64>(k8_addr + 32), 1);
    wgmma_commit_wait();

    uint32_t pa[KSUB / 8][2];
#pragma unroll
    for (int n = 0; n < KSUB / 8; ++n) {
        const int c = n * 8 + 2 * t4;
        const float2 kc = *reinterpret_cast<const float2*>(ks + c);
        float e[4];
        e[0] = ex2(__fmul_rn(__fmul_rn(i2f(sacc[n][0]), qs0), kc.x));
        e[1] = ex2(__fmul_rn(__fmul_rn(i2f(sacc[n][1]), qs0), kc.y));
        e[2] = ex2(__fmul_rn(__fmul_rn(i2f(sacc[n][2]), qs1), kc.x));
        e[3] = ex2(__fmul_rn(__fmul_rn(i2f(sacc[n][3]), qs1), kc.y));
        if constexpr (MASK) {
            if (k0 + c >= T) e[0] = e[2] = 0.f;
            if (k0 + c + 1 >= T) e[1] = e[3] = 0.f;
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
    wgmma_commit();
    overlap();
    wgmma_wait();
    wgmma_fence_operand(oacc);
}

// Quarter K row j (0 .. QPT) of this thread in a stage: row i / 4, quarter
// i % 4 for i = tid + j * NTHREAD.  The thread that copies a quarter row
// into the staging tile also quantizes it, so its own cp.async wait is all
// the quantization waits for.
__device__ __forceinline__ void load_k_quarter(__nv_bfloat16* kst,
                                               const __nv_bfloat16* __restrict__ k, int r0, int T,
                                               long k_rs, int i) {
    const int r = i / 4, t = i % 4;
    const bool ok = r0 + r < T;
    const __nv_bfloat16* src = ok ? k + (long)(r0 + r) * k_rs : k;
    cp_async16(kst + r * HD + t * 8, src + t * 8, ok ? 16 : 0);
    cp_async16(kst + r * HD + 32 + t * 8, src + 32 + t * 8, ok ? 16 : 0);
}

__device__ __forceinline__ void quant_k_quarter_tile(const __nv_bfloat16* kst, int8_t* k8,
                                                     float* ks, int i) {
    const int r = i / 4, t = i % 4;
    uint2 w0, w1;
    const float s = quant_k_quarter(w0, w1, *reinterpret_cast<const uint4*>(kst + r * HD + t * 8),
                                    *reinterpret_cast<const uint4*>(kst + r * HD + 32 + t * 8),
                                    INV127);
    // int8 columns 8 t and 32 + 8 t: 16-byte chunks t / 2 and 2 + t / 2
    *reinterpret_cast<uint2*>(k8 + sw64(r, t / 2) + (t % 2) * 8) = w0;
    *reinterpret_cast<uint2*>(k8 + sw64(r, 2 + t / 2) + (t % 2) * 8) = w1;
    if (t == 0) ks[r] = s;
}

// K rows [r0, r0 + BK) into the staging tile (plain rows of 128 B, each
// thread its quarter rows) as one commit group, V rows into a ring slot
// (128B swizzle) as the next; rows >= T load as zeros
__device__ __forceinline__ void load_stage(__nv_bfloat16* kst, __nv_bfloat16* vs,
                                           const __nv_bfloat16* __restrict__ k,
                                           const __nv_bfloat16* __restrict__ v, int r0, int T,
                                           long k_rs, long v_rs, int tid) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) load_k_quarter(kst, k, r0, T, k_rs, tid + j * NTHREAD);
    cp_async_commit();
    cp_async_rows_sw128<BK, NTHREAD>(vs, v, r0, T, v_rs, tid);
    cp_async_commit();
}

__global__ void __launch_bounds__(NTHREAD, 1)
attn_int8_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int T, int H, long q_bs, long q_rs, long k_bs, long k_rs, long v_bs, long v_rs,
                 float q_scale) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the swizzles are functions of address bits: the tiles start 1024-aligned
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
    __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem);
    int8_t* k8_s = reinterpret_cast<int8_t*>(smem + V_BYTES);
    __nv_bfloat16* kst_s = reinterpret_cast<__nv_bfloat16*>(smem + V_BYTES + K8_BYTES);
    float* ks_s = reinterpret_cast<float*>(smem + V_BYTES + K8_BYTES + KST_BYTES);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;          // mma groupID, thread in group
    const int rw = warp % (BQ / 16), kg = warp / (BQ / 16);   // 16-row slice, key group
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const __nv_bfloat16* kb = k + b * k_bs + h * HD;
    const __nv_bfloat16* vb = v + b * v_bs + h * HD;
    const int nt = (T + BK - 1) / BK;

    load_stage(kst_s, v_s, kb, vb, 0, T, k_rs, v_rs, tid);

    // this thread's query rows, quantized into the s8 A fragments (k-steps of 32)
    const int row0 = blockIdx.x * BQ + rw * 16 + g, row1 = row0 + 8;
    const __nv_bfloat16* qb = q + b * q_bs + h * HD;
    uint32_t qa[2][4];
    const float qs0 = quant_q_row(qa, 0, qb + (long)row0 * q_rs, t4, row0 < T, q_scale);
    const float qs1 = quant_q_row(qa, 1, qb + (long)row1 * q_rs, t4, row1 < T, q_scale);

    // the quantization of stage it+1's K, a quarter row at a time, runs under
    // the P.V products of stage it; stage 0's runs here
    int qdone = 0, qslot = 0;          // quarter rows of the pending stage done; its tiles
    auto quant_next = [&]() {
        if (qdone == QPT) return;
        if (qdone == 0) cp_async_wait<1>();   // this thread's K copies (V's group may pend)
        quant_k_quarter_tile(kst_s, k8_s + qslot * BK * HD, ks_s + qslot * BK,
                             tid + qdone * NTHREAD);
        ++qdone;
    };
    while (qdone < QPT) quant_next();

    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float sum0 = 0.f, sum1 = 0.f;

    for (int it = 0; it < nt; ++it) {
        cp_async_wait<0>();            // stage it's V slot has landed
        fence_async_smem();            // the int8 tile and V are read by wgmma (async proxy)
        __syncthreads();               // ... for every thread; stage it-1 is consumed
        // stage it+1 loads, and is quantized, under this stage's products: the
        // staging tile's quarter rows are each thread's own, the int8 tile and
        // V slot were last read by the products of stage it-1
        const int slot = it % STAGES, next = (it + 1) % STAGES;
        if (it + 1 < nt) {
            load_stage(kst_s, v_s + next * BK * HD, kb, vb, (it + 1) * BK, T, k_rs, v_rs, tid);
            qdone = 0;
            qslot = next;
        }
        const __nv_bfloat16* vslot = v_s + slot * BK * HD;
        const int8_t* k8 = k8_s + slot * BK * HD;
        const float* ks = ks_s + slot * BK;
#pragma unroll
        for (int j = 0; j < SUBS; ++j) {
            const int sub = kg * SUBS + j;
            const int k0 = it * BK + sub * KSUB;
            if (k0 >= T) break;        // keys past T only: nothing to add
            const uint32_t k8a = smem_addr(k8 + sub * KSUB * HD);
            const uint32_t vs = smem_addr(vslot + sub * KSUB * HD);
            if (k0 + KSUB <= T)
                key_block<false>(qa, qs0, qs1, k8a, ks + sub * KSUB, vs, k0, T, t4, oacc, sum0,
                                 sum1, quant_next);
            else
                key_block<true>(qa, qs0, qs1, k8a, ks + sub * KSUB, vs, k0, T, t4, oacc, sum0,
                                sum1, quant_next);
        }
        while (qdone < QPT) quant_next();
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
    const long D = (long)H * HD;
    __nv_bfloat16* ob = o + (long)b * T * D + h * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        const float* p = o_s + lr * (HD + 4) + n * 8 + 2 * t4;
        if (row0 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * D + n * 8) =
                __floats2bfloat162_rn((oacc[n][0] + p[0]) * inv0, (oacc[n][1] + p[1]) * inv0);
        if (row1 < T)
            *reinterpret_cast<__nv_bfloat162*>(ob + (long)row1 * D + n * 8) =
                __floats2bfloat162_rn((oacc[n][2] + p[8 * (HD + 4)]) * inv1,
                                      (oacc[n][3] + p[8 * (HD + 4) + 1]) * inv1);
    }
}

// quant_row on every row of x (rows, heads * 64) bf16 at row stride rs, the
// scales the clamped amax times factor ``extra``, four lanes a row: the attention kernel's Q path (the
// A-fragment columns) or, with k_path, its K path (quarter rows).  q8:
// (rows, heads * 64) int8, s: (rows, heads) f32, both contiguous.  One warp
// a (row block, head).
__global__ void quant_probe_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ q8,
                                   float* __restrict__ s, int rows, int heads, long rs,
                                   float extra, int k_path) {
    const int lane = threadIdx.x % 32, h = blockIdx.y;
    const long D = (long)heads * HD;
    if (k_path) {                      // eight rows a warp, four lanes a row
        const int r = blockIdx.x * 8 + lane / 4, t = lane % 4;
        const bool ok = r < rows;
        const __nv_bfloat16* p = x + (ok ? r : 0) * rs + h * HD + t * 8;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        uint2 w0, w1;
        const float sc = quant_k_quarter(w0, w1, ok ? *reinterpret_cast<const uint4*>(p) : zero,
                                         ok ? *reinterpret_cast<const uint4*>(p + 32) : zero,
                                         extra);
        if (!ok) return;
        *reinterpret_cast<uint2*>(q8 + r * D + h * HD + t * 8) = w0;
        *reinterpret_cast<uint2*>(q8 + r * D + h * HD + 32 + t * 8) = w1;
        if (t == 0) s[(long)r * heads + h] = sc;
    } else {                           // eight rows a warp, four lanes a row
        const int g = lane / 4, t4 = lane % 4, r = blockIdx.x * 8 + g;
        const bool ok = r < rows;
        uint32_t qa[2][4];
        const float sc = quant_q_row(qa, 0, x + (ok ? r : 0) * rs + h * HD, t4, ok, extra);
        if (!ok) return;
#pragma unroll
        for (int c = 0; c < 4; ++c)
            *reinterpret_cast<uint32_t*>(q8 + r * D + h * HD + c * 16 + 4 * t4) =
                qa[c / 2][(c % 2) * 2];
        if (t4 == 0) s[(long)r * heads + h] = sc;
    }
}

}  // namespace

// q, k, v: bf16 rows of H * 64 at unit column stride, batch and row strides
// (elements) q_bs, q_rs, ... (16-byte aligned); o: (B, T, H * 64) bf16,
// contiguous; q_scale: f32(f32(1/127) * hd^-0.5 log2(e)), the factor of the
// Q scales (the clamped amax times it).  Returns the first CUDA error.
extern "C" int vitvs_attn_int8_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int T, int H, long q_bs, long q_rs, long k_bs,
                                   long k_rs, long v_bs, long v_rs, float q_scale,
                                   void* stream) {
    const cudaError_t err = cudaFuncSetAttribute(attn_int8_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((T + BQ - 1) / BQ, B * H);
    attn_int8_kernel<<<grid, NTHREAD, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), T, H, q_bs, q_rs,
        k_bs, k_rs, v_bs, v_rs, q_scale);
    return static_cast<int>(cudaGetLastError());
}

// x: (rows, heads * 64) bf16 at row stride rs (elements, 16-byte aligned
// rows); q8: (rows, heads * 64) int8, s: (rows, heads) f32, contiguous.
// k_path = 0: the kernel's Q quantization, 1: its K quantization; both
// return the clamped amax times extra as the scales.  Returns the first CUDA error.
extern "C" int vitvs_quant_th_probe(const void* x, void* q8, void* s, int rows, int heads,
                                    long rs, float extra, int k_path, void* stream) {
    const dim3 grid((rows + 7) / 8, heads);
    quant_probe_kernel<<<grid, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q8), static_cast<float*>(s),
        rows, heads, rs, extra, k_path);
    return static_cast<int>(cudaGetLastError());
}
