// Cosine-similarity row/column max and argmax: the matcher kernels.
//
// Replace the Pallas kernel vitvs_tpu/ops/matcher.py:_matcher_kernel
// (dual_argmax_cosine).  The TPU kernel carries the column max across row
// tiles in scratch because its grid runs in order on one core.  Blocks on
// the card run in parallel and in no order, and a block that waits on
// another can deadlock, so here no block waits on another outside its
// cluster.  Two kernels, one for each arithmetic of ops/matcher.py; neither
// writes the (t1 x t2) matrix, and both end alike: one 64-bit atomicMax per
// row and column on a packed key (order-preserving float bits high, ~index
// low), so the result does not depend on the order the blocks finish in and
// ties go to the first index, as jnp.argmax and torch.argmax do; the last
// block to finish decodes the keys into the outputs and zeroes them again,
// so the wrapper's scratch needs no clearing before the next launch.  One
// launch each, for the goal's rows against one frame or a chunk of B frames:
// the reference vmaps its pallas_call over the chunk (a batch axis in its
// grid), and here item z of the batch is the grid's z, with its own rows of
// b, its own outputs, its own packed keys and its own finished-block count,
// so its last block decodes it alone, and its arithmetic is that of a launch
// on it alone (bit for bit).
//
// bf16 mode (the servo step's default, the reference's default arithmetic):
// the rows arrive as bf16 unit rows (normalized by the wrapper), and the
// kernel computes the similarity on the bf16 tensor cores (mma.sync
// m16n8k16, f32 accumulation: bf16 products are exact in f32, so this is
// the reference's arithmetic up to summation order).  One block per
// (32-row, 64-column) tile, 4 warps of 16 x 32; 128-deep chunks of both
// tiles stream through a 3-stage cp.async ring, so two chunks load while
// one multiplies, one barrier a chunk.  The epilogue reduces row and column
// max/argmax from the accumulator registers (warp shuffles, then shared
// memory).  Bound on the card (H100 SXM) at t = 484, d = 3456: 6.7 MB of
// bf16 rows read, 2.0 us at 3.35 TB/s, against 1.62 GFLOP, 1.6 us at 989
// TFLOP/s: bytes bound it.  Each block re-reads its rows from L2 (85 MB over
// the grid), and a 128-block grid of 4 warps a block hides little of that
// latency: that is what this tiling leaves on the table.
//
// f32 mode (use_match_kernel=True, f32 descriptors: the TPU kernel's
// arithmetic): the raw rows, cast to f32 by the wrapper, are multiplied in
// f32 FMA on the CUDA cores (exact f32 products; tensor cores would need a
// split-precision scheme such as 3xTF32, another arithmetic), then
// sim = acc * ainv * binv with inv = rsqrt(sum(x^2) + 1e-24), as the TPU
// kernel folds its inverse norms in after the product.  Bound on the card
// at t = 484, d = 3456: f32 operations, 1.62 GFLOP in 24 us at 67 TFLOP/s,
// against 13.4 MB read (4 us).  One cluster of 8 CTAs per 64 x 64 output
// tile, each CTA an eighth of d (8 x 8 tiles at t = 484: 512 CTAs of 128
// threads, four an SM, where 64 one-CTA tiles would leave half the 132 SMs
// idle).  A CTA streams 32-deep chunks of its 64 rows of each side through
// a 2-stage ring of 16-byte cp.async copies (4-byte ones when the rows are
// not 16-byte aligned), one barrier a chunk; each thread holds an 8 x 4
// register tile (rows ty + 8 i, columns tx + 16 j) and reads both operands
// as float4 along the depth.  Each CTA also sums the squares of its 64 + 64
// rows over its slice from the chunks it holds.  At the end the eight
// partial tiles and sums of squares meet through distributed shared memory:
// CTA r of the cluster adds the eight partials of rows 8 r .. 8 r + 7 in
// rank order (a fixed order: two launches give bit-identical results),
// applies the inverse norms and reduces its 8 rows x 64 columns into the
// packed keys.  The wrapper makes this one launch; no inverse-norm pass, no
// partial scratch, no reduce pass.  What
// holds it above the bound: the FMA loop, whose operands are float4 along
// the depth (an accumulator's four FMAs depend on each other; a build
// without the chunk loads ran about as slow), and the launch, first loads
// and epilogue (cluster barriers, the atomics and the last block's decode),
// which do not shrink with d.
// Tile shapes (64 x 128, 128 x 64), 8 x 8 register tiles, 4-CTA clusters,
// 3 stages and a k-major layout filled through registers all ran slower on
// the card at this shape.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

// (value, index) -> a key whose unsigned order is value order, then the
// lower index first
__device__ __forceinline__ unsigned long long pack_key(float v, int idx) {
    uint32_t u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<unsigned long long>(u) << 32) | static_cast<uint32_t>(~idx);
}

__device__ __forceinline__ void unpack_key(unsigned long long key, float& v, int& idx) {
    const uint32_t u = static_cast<uint32_t>(key >> 32);
    v = __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
    idx = static_cast<int>(~static_cast<uint32_t>(key));
}

// the larger value, the lower index on a tie
__device__ __forceinline__ void take_better(float& v, int& i, float ov, int oi) {
    if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
}

// work: this batch item's (t1 + t2) packed keys, then the count of its
// finished blocks, zero at launch.  Called by every thread of every block
// after the block's atomics: the item's last block to finish decodes its
// keys into its outputs and leaves its work zero again.
template <int NTHREAD>
__device__ __forceinline__ void finish_grid(unsigned long long* __restrict__ work,
                                            float* __restrict__ rmax, int* __restrict__ rarg,
                                            float* __restrict__ cmax, int* __restrict__ carg,
                                            int t1, int t2) {
    __shared__ bool last_s;
    const int tid = threadIdx.x;
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        unsigned int* done = reinterpret_cast<unsigned int*>(work + t1 + t2);
        last_s = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    constexpr int U = 8;               // keys in flight a thread
    for (int base = 0; base < t1 + t2; base += U * NTHREAD) {   // every block's atomics are
        unsigned long long key[U];                              // in: decode
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = base + u * NTHREAD + tid;
            key[u] = i < t1 + t2 ? __ldcg(work + i) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = base + u * NTHREAD + tid;
            float v;
            int idx;
            unpack_key(key[u], v, idx);
            if (i < t1) { rmax[i] = v; rarg[i] = idx; }
            else if (i < t1 + t2) { cmax[i - t1] = v; carg[i - t1] = idx; }
            if (i < t1 + t2) work[i] = 0ull;
        }
    }
    if (tid == 0) work[t1 + t2] = 0ull;
}

// ---- f32 mode --------------------------------------------------------------

constexpr int FT = 64;                 // rows and columns of a cluster's output tile
constexpr int FCL = 8;                 // CTAs of a cluster, one slice of d each
constexpr int FDK = 32;                // depth of a pipeline chunk
constexpr int FLD = FDK + 4;           // f32 row stride of a staged chunk (144 B: float4
                                       // reads of 8 rows fall in distinct banks)
constexpr int FSTAGES = 2;
constexpr int FNT = 128;               // threads: FRG row groups x FCG column groups
constexpr int FRG = 8;                 // row groups: rows ty + FRG i of the tile
constexpr int FCG = FNT / FRG;         // column groups: columns tx + FCG j of the tile
constexpr int FTM = FT / FRG;          // rows a thread
constexpr int FTN = FT / FCG;          // columns a thread
constexpr int FROWS = 2 * FT;          // staged rows: a's, then b's; thread t sums row t's squares
static_assert(FROWS == FNT, "one staged row a thread");
constexpr int FQ = FT / FCL;           // rows of the tile a CTA reduces
constexpr int FRL = FNT / FQ;          // lanes that reduce one of those rows
static_assert(FRL >= 1 && FRL <= 32 && FT % FRL == 0, "epilogue lanes");
constexpr int FSTAGE = FROWS * FLD;    // floats of one stage
constexpr int FLDR = FT + 1;           // row stride of the partial and final tiles
constexpr int SMEM_F32 = FSTAGES * FSTAGE * 4;   // dynamic shared memory
// the epilogue reuses the ring: the partial tile, the sums of squares, this
// CTA's reduced rows and their inverse norms (rows, then columns)
static_assert(FT * FLDR + FROWS + FQ * FLDR + FQ + FT <= FSTAGES * FSTAGE, "epilogue fits");

// one FDK-deep chunk of this tile's FT rows of a and FT rows of b into a
// stage; rows past t1 / t2 and depth past d load as zeros.  VEC: every row
// starts 16-byte aligned and is copied 16 bytes at a time.
template <bool VEC>
__device__ __forceinline__ void load_f32_stage(float* st, const float* __restrict__ a,
                                               const float* __restrict__ b, int r0, int c0,
                                               int k0, int t1, int t2, int d, int tid) {
    constexpr int W = VEC ? 4 : 1;     // floats a copy
#pragma unroll 4
    for (int i = tid; i < FROWS * (FDK / W); i += FNT) {
        const int r = i / (FDK / W), c = (i % (FDK / W)) * W, gk = k0 + c;
        const bool in_a = r < FT;
        const int grow = in_a ? r0 + r : c0 + r - FT;
        const float* src = in_a ? a : b + (long)blockIdx.z * t2 * d;   // this item's frame
        const bool ok = grow < (in_a ? t1 : t2) && gk < d;
        const float* from = ok ? src + (long)grow * d + gk : src;
        if constexpr (VEC) cp_async16(st + r * FLD + c, from, ok ? 16 : 0);
        else cp_async4(st + r * FLD + c, from, ok ? 4 : 0);
    }
}

// work: (t1 + t2 + 1) entries a batch item, as finish_grid; zero at
// launch.  Grid: (FCL x column tiles, row tiles, batch items), clusters of
// FCL along x; CTA r of a cluster multiplies depth [r d_slice, (r + 1)
// d_slice), d_slice a multiple of FDK.
template <bool VEC>
__global__ void __launch_bounds__(FNT)
sim_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
               unsigned long long* __restrict__ work, float* __restrict__ rmax,
               int* __restrict__ rarg, float* __restrict__ cmax, int* __restrict__ carg,
               int t1, int t2, int d, int d_slice) {
    extern __shared__ __align__(16) float fsm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, ty = tid / FCG, tx = tid % FCG;
    const int r0 = blockIdx.y * FT, c0 = (blockIdx.x / FCL) * FT;
    const int kbeg = rank * d_slice;
    const int len = min(d_slice, d - kbeg);
    const int nk = len > 0 ? (len + FDK - 1) / FDK : 0;

    float acc[FTM][FTN];
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) acc[i][j] = 0.f;
    float sq = 0.f;                    // squares of staged row tid

#pragma unroll
    for (int s = 0; s < FSTAGES - 1; ++s) {
        if (s < nk) load_f32_stage<VEC>(fsm + s * FSTAGE, a, b, r0, c0, kbeg + s * FDK, t1, t2, d, tid);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<FSTAGES - 2>();  // chunk kt has landed
        __syncthreads();               // ... for every thread; chunk kt-1 is consumed
        const int pre = kt + FSTAGES - 1;
        if (pre < nk)
            load_f32_stage<VEC>(fsm + (pre % FSTAGES) * FSTAGE, a, b, r0, c0, kbeg + pre * FDK,
                                t1, t2, d, tid);
        cp_async_commit();

        const float* sa = fsm + (kt % FSTAGES) * FSTAGE;
        const float* sb = sa + FT * FLD;
#pragma unroll
        for (int c4 = 0; c4 < FDK / 4; ++c4) {
            const float4 x = *reinterpret_cast<const float4*>(sa + tid * FLD + c4 * 4);
            sq = fmaf(x.x, x.x, sq);
            sq = fmaf(x.y, x.y, sq);
            sq = fmaf(x.z, x.z, sq);
            sq = fmaf(x.w, x.w, sq);
        }
#pragma unroll
        for (int d4 = 0; d4 < FDK / 4; ++d4) {
            float4 av[FTM];
#pragma unroll
            for (int i = 0; i < FTM; ++i)
                av[i] = *reinterpret_cast<const float4*>(sa + (ty + FRG * i) * FLD + d4 * 4);
#pragma unroll
            for (int j = 0; j < FTN; ++j) {
                const float4 bv = *reinterpret_cast<const float4*>(sb + (tx + FCG * j) * FLD + d4 * 4);
#pragma unroll
                for (int i = 0; i < FTM; ++i) {
                    acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
                    acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
                    acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
                    acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();                   // the ring is free

    // this CTA's partial tile and sums of squares, for the cluster to read
    float* red = fsm;                  // FT x FLDR
    float* ss = red + FT * FLDR;       // FROWS: a's rows, then b's
    float* fin = ss + FROWS;           // FQ x FLDR: this CTA's rows, reduced
    float* inv = fin + FQ * FLDR;      // FQ rows, then FT columns
#pragma unroll
    for (int i = 0; i < FTM; ++i)
#pragma unroll
        for (int j = 0; j < FTN; ++j) red[(ty + FRG * i) * FLDR + tx + FCG * j] = acc[i][j];
    ss[tid] = sq;
    cluster.sync();                    // every CTA's partials are in

    const float* part[FCL];
#pragma unroll
    for (int r = 0; r < FCL; ++r) part[r] = cluster.map_shared_rank(red, r);
    const int q0 = rank * FQ;          // this CTA's rows of the tile
    for (int i = tid; i < FQ + FT; i += FNT) {
        const int at = i < FQ ? q0 + i : FT + (i - FQ);
        float s = part[0][FT * FLDR + at];
#pragma unroll
        for (int r = 1; r < FCL; ++r) s += part[r][FT * FLDR + at];   // rank order
        inv[i] = rsqrtf(s + 1e-24f);
    }
    __syncthreads();
#pragma unroll 4
    for (int e = tid; e < FQ * FT; e += FNT) {
        const int rr = e / FT, c = e % FT;
        float s = part[0][(q0 + rr) * FLDR + c];
#pragma unroll
        for (int r = 1; r < FCL; ++r) s += part[r][(q0 + rr) * FLDR + c];
        fin[rr * FLDR + c] = s * inv[rr] * inv[FQ + c];
    }
    cluster.sync();                    // no CTA leaves while another reads its partials;
                                       // fin is complete for this CTA's threads

    // row max/argmax over the tile's columns (FRL lanes a row, each a run of
    // columns, then shuffles); column max/argmax over this CTA's rows; strict
    // '>' in increasing order and take_better keep the first index
    const int nrows = min(FQ, t1 - r0 - q0), ncols = min(FT, t2 - c0);
    // this batch item's keys and outputs, offset here and not at the start,
    // where the pointers would hold registers through the main loop
    const long z = blockIdx.z;
    unsigned long long* const wk = work + z * (t1 + t2 + 1);
    {
        const int rr = tid / FRL, cb = (tid % FRL) * (FT / FRL);
        float best = -INFINITY;
        int arg = 0x7fffffff;
        for (int c = cb; c < min(cb + FT / FRL, ncols); ++c)
            if (fin[rr * FLDR + c] > best) { best = fin[rr * FLDR + c]; arg = c0 + c; }
#pragma unroll
        for (int m = 1; m < FRL; m <<= 1)
            take_better(best, arg, __shfl_xor_sync(0xffffffffu, best, m),
                        __shfl_xor_sync(0xffffffffu, arg, m));
        if (tid % FRL == 0 && rr < nrows) atomicMax(wk + r0 + q0 + rr, pack_key(best, arg));
    }
    if (tid < ncols && nrows > 0) {
        float best = -INFINITY;
        int arg = r0 + q0;
        for (int rr = 0; rr < nrows; ++rr)
            if (fin[rr * FLDR + tid] > best) { best = fin[rr * FLDR + tid]; arg = r0 + q0 + rr; }
        atomicMax(wk + t1 + c0 + tid, pack_key(best, arg));
    }
    finish_grid<FNT>(wk, rmax + z * t1, rarg + z * t1, cmax + z * t2, carg + z * t2, t1, t2);
}

// ---- bf16 mode -------------------------------------------------------------

constexpr int BR = 32;                 // rows of desc1 per block
constexpr int BC = 64;                 // rows of desc2 (similarity columns) per block
constexpr int BKD = 128;               // depth chunk of one pipeline stage
constexpr int LDB = BKD + 8;           // bf16 row stride of a staged chunk (272 B: ldmatrix
                                       // rows fall in distinct banks)
constexpr int STAGES = 3;
constexpr int NTB = 128;               // 4 warps: 2 row halves x 2 column halves
constexpr int STAGE_ELEMS = (BR + BC) * LDB;
constexpr int SMEM_BF16 = STAGES * STAGE_ELEMS * 2;   // 78,336 bytes: dynamic shared memory

// one (BR x BKD) chunk of a and one (BC x BKD) chunk of b into a stage;
// rows past t1 / t2 and depth past d load as zeros
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b, int r0, int c0,
                                           int k0, int t1, int t2, int d, int tid) {
    for (int i = tid; i < (BR + BC) * (BKD / 8); i += NTB) {
        const int r = i / (BKD / 8), c8 = (i % (BKD / 8)) * 8, gk = k0 + c8;
        const bool in_a = r < BR;
        const int grow = in_a ? r0 + r : c0 + r - BR;
        const __nv_bfloat16* src = in_a ? a : b + (long)blockIdx.z * t2 * d;   // this item's frame
        const bool ok = grow < (in_a ? t1 : t2) && gk < d;
        cp_async16(st + r * LDB + c8, ok ? src + (long)grow * d + gk : src, ok ? 16 : 0);
    }
}

// work: (t1 + t2 + 1) entries a batch item, as finish_grid; zero at
// launch.  Grid: (column tiles, row tiles, batch items).
__global__ void __launch_bounds__(NTB)
sim_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                unsigned long long* __restrict__ work, float* __restrict__ rmax,
                int* __restrict__ rarg, float* __restrict__ cmax, int* __restrict__ carg,
                int t1, int t2, int d) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __shared__ float rv_s[2][BR], cv_s[2][BC];
    __shared__ int ri_s[2][BR], ci_s[2][BC];

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int wr = warp & 1, wc = warp >> 1;          // 16-row half, 32-column half
    const int r0 = blockIdx.y * BR, c0 = blockIdx.x * BC;
    const int nk = (d + BKD - 1) / BKD;

    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_stage(ring + s * STAGE_ELEMS, a, b, r0, c0, s * BKD, t1, t2, d, tid);
        cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<STAGES - 2>();                   // chunk kt has landed
        __syncthreads();                               // ... for every thread; chunk kt-1 is consumed
        const int pre = kt + STAGES - 1;
        if (pre < nk)
            load_stage(ring + (pre % STAGES) * STAGE_ELEMS, a, b, r0, c0, pre * BKD, t1, t2, d, tid);
        cp_async_commit();

        const __nv_bfloat16* sa = ring + (kt % STAGES) * STAGE_ELEMS;
        const __nv_bfloat16* sb = sa + BR * LDB;
#pragma unroll
        for (int ks = 0; ks < BKD / 16; ++ks) {
            uint32_t af[4];
            ldmatrix_x4(af, sa + (wr * 16 + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int np = 0; np < 2; ++np) {
                uint32_t bf[4];
                ldmatrix_x4(bf, sb + (wc * 32 + np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB
                                    + ks * 16 + ((lane >> 3) & 1) * 8);
                mma_bf16(acc[2 * np], af, bf[0], bf[1]);
                mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
            }
        }
    }
    cp_async_wait<0>();

    // acc[n][i]: row wr*16 + g (+8 for i >= 2), column wc*32 + n*8 + 2*t4 + (i & 1)
    const int grow0 = r0 + wr * 16 + g;
    // row max/argmax over this warp's 32 columns, in increasing column order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float best = -INFINITY;
        int arg = 0x7fffffff;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int gc = c0 + wc * 32 + n * 8 + 2 * t4 + j;
                if (gc < t2 && acc[n][2 * h + j] > best) { best = acc[n][2 * h + j]; arg = gc; }
            }
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1)
            take_better(best, arg, __shfl_xor_sync(0xffffffffu, best, m),
                        __shfl_xor_sync(0xffffffffu, arg, m));
        if (t4 == 0) { rv_s[wc][wr * 16 + h * 8 + g] = best; ri_s[wc][wr * 16 + h * 8 + g] = arg; }
    }
    // column max/argmax over this warp's 16 rows
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            float best = grow0 < t1 ? acc[n][j] : -INFINITY;
            int arg = grow0 < t1 ? grow0 : 0x7fffffff;
            if (grow0 + 8 < t1 && acc[n][2 + j] > best) { best = acc[n][2 + j]; arg = grow0 + 8; }
#pragma unroll
            for (int m = 4; m <= 16; m <<= 1)
                take_better(best, arg, __shfl_xor_sync(0xffffffffu, best, m),
                            __shfl_xor_sync(0xffffffffu, arg, m));
            if (g == 0) {
                cv_s[wr][wc * 32 + n * 8 + 2 * t4 + j] = best;
                ci_s[wr][wc * 32 + n * 8 + 2 * t4 + j] = arg;
            }
        }
    __syncthreads();

    // combine the two halves, then the blocks; this batch item's keys and
    // outputs, offset here and not at the start (registers through the loop)
    const long z = blockIdx.z;
    unsigned long long* const wk = work + z * (t1 + t2 + 1);
    if (tid < BR) {
        float v = rv_s[0][tid];
        int i = ri_s[0][tid];
        take_better(v, i, rv_s[1][tid], ri_s[1][tid]);
        if (r0 + tid < t1 && i != 0x7fffffff) atomicMax(wk + r0 + tid, pack_key(v, i));
    } else if (tid < BR + BC) {
        const int c = tid - BR;
        float v = cv_s[0][c];
        int i = ci_s[0][c];
        take_better(v, i, cv_s[1][c], ci_s[1][c]);
        if (c0 + c < t2 && i != 0x7fffffff) atomicMax(wk + t1 + c0 + c, pack_key(v, i));
    }
    finish_grid<NTB>(wk, rmax + z * t1, rarg + z * t1, cmax + z * t2, carg + z * t2, t1, t2);
}

template <bool VEC>
cudaError_t launch_f32(const void* a, const void* b, void* work, void* rmax, void* rarg,
                       void* cmax, void* carg, int nb, int t1, int t2, int d, int grid_x,
                       int grid_y, int d_slice, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(sim_f32_kernel<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_F32);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid_x, grid_y, nb);
    cfg.blockDim = dim3(FNT);
    cfg.dynamicSmemBytes = SMEM_F32;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = FCL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, sim_f32_kernel<VEC>, static_cast<const float*>(a),
                             static_cast<const float*>(b), static_cast<unsigned long long*>(work),
                             static_cast<float*>(rmax), static_cast<int*>(rarg),
                             static_cast<float*>(cmax), static_cast<int*>(carg), t1, t2, d, d_slice);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// f32 mode.  a: (t1, d), b: (nb, t2, d) f32, contiguous; work: nb (t1 + t2
// + 1) x 8 bytes of scratch, zero at launch and left zero.  grid_x = 8 x
// column tiles, grid_y = row tiles (64 x 64 tiles), d_slice = the depth each
// CTA of a cluster takes, a multiple of 32 with 8 d_slice >= d
// (ops/matcher.py:f32_launch); other values are refused
// (cudaErrorInvalidValue).  Outputs rmax/rarg (nb, t1), cmax/carg (nb, t2).
// Returns the first CUDA error.
extern "C" int vitvs_dual_argmax_cosine(const void* a, const void* b, void* work, void* rmax,
                                        void* rarg, void* cmax, void* carg, int nb, int t1,
                                        int t2, int d, int grid_x, int grid_y, int d_slice,
                                        void* stream) {
    if (nb < 1 || nb > 65535 || t1 < 1 || t2 < 1 || d < 1 || grid_x != FCL * ((t2 + FT - 1) / FT)
        || grid_y != (t1 + FT - 1) / FT || d_slice < FDK || d_slice % FDK != 0
        || (long)FCL * d_slice < d)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // 16-byte copies where every row starts 16-byte aligned
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0
                     && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const cudaError_t err = vec
        ? launch_f32<true>(a, b, work, rmax, rarg, cmax, carg, nb, t1, t2, d, grid_x, grid_y,
                           d_slice, s)
        : launch_f32<false>(a, b, work, rmax, rarg, cmax, carg, nb, t1, t2, d, grid_x, grid_y,
                            d_slice, s);
    return static_cast<int>(err);
}

// bf16 mode.  a: (t1, d), b: (nb, t2, d) bf16 unit rows, contiguous, d a
// multiple of 8; work: nb (t1 + t2 + 1) x 8 bytes of scratch, zero at
// launch and left zero.  Outputs rmax/rarg (nb, t1), cmax/carg (nb, t2).
// Returns the first CUDA error.
extern "C" int vitvs_dual_argmax_bf16(const void* a, const void* b, void* work, void* rmax,
                                      void* rarg, void* cmax, void* carg, int nb, int t1,
                                      int t2, int d, void* stream) {
    if (nb < 1 || nb > 65535 || t1 < 1 || t2 < 1 || d < 8 || d % 8 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(sim_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t2 + BC - 1) / BC, (t1 + BR - 1) / BR, nb);
    sim_bf16_kernel<<<grid, NTB, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<unsigned long long*>(work), static_cast<float*>(rmax),
        static_cast<int*>(rarg), static_cast<float*>(cmax), static_cast<int*>(carg), t1, t2, d);
    return static_cast<int>(cudaGetLastError());
}
