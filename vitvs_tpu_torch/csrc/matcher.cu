// Cosine-similarity row/column max and argmax: the matcher kernels.
//
// Replace the Pallas kernel vitvs_tpu/ops/matcher.py:_matcher_kernel
// (dual_argmax_cosine).  The TPU kernel carries the column max across row
// tiles in scratch because its grid runs in order on one core.  Blocks on
// the card run in parallel and in no order, and a block that waits on
// another can deadlock, so here no block waits.  Two kernels, one for each
// arithmetic of ops/matcher.py; neither writes the (t1 x t2) matrix.
//
// bf16 mode (the servo step's default, the reference's default arithmetic):
// the rows arrive as bf16 unit rows (normalized by the wrapper), and one
// launch computes the similarity on the bf16 tensor cores
// (mma.sync m16n8k16, f32 accumulation: bf16 products are exact in f32, so
// this is the reference's arithmetic up to summation order).  One block per
// (32-row, 64-column) tile, 4 warps of 16 x 32; 128-deep chunks of both
// tiles stream through a 3-stage cp.async ring, so two chunks load while
// one multiplies, one barrier a chunk.  The epilogue reduces row and column
// max/argmax from the accumulator registers (warp shuffles, then shared
// memory) and combines the blocks by one 64-bit atomicMax per row and
// column on a packed key: order-preserving float bits high, ~index low, so
// the result does not depend on the order the blocks finish in and ties go
// to the first index.  The last block to finish decodes the keys into the
// outputs.  Bound on the card (H100 SXM) at t = 484, d = 3456: 6.7 MB of
// bf16 rows read, 2.0 us at 3.35 TB/s, against 1.62 GFLOP, 1.6 us at 989
// TFLOP/s: bytes bound it.  Each block re-reads its rows from L2 (85 MB over
// the grid), and a 128-block grid of 4 warps a block hides little of that
// latency: that is what this tiling leaves on the table.
//
// f32 mode (use_match_kernel=True, f32 descriptors: the TPU kernel's
// arithmetic, rows cast to f32, inverse norms folded in after the product):
//   pass 1: one block per (32-row, 64-column) tile of the similarity
//           matrix computes the tile in f32 (inverse norms folded in) and
//           writes its per-row and per-column max/argmax partials to
//           scratch: (n_col_tiles, t1) and (n_row_tiles, t2);
//   pass 2: one thread per row or column reduces its partials in tile
//           order; the strict '>' keeps the first index on ties, as
//           jnp.argmax and torch.argmax do.
// The scratch is (t1 + t2) x n_tiles.  Bound at t = 484, d = 3456: 1.62
// GFLOP of f32 FMA outside the tensor cores, 24 us at 67 TFLOP/s, against
// 13.4 MB read (4 us): f32 compute bounds it.  It tiles for shared-memory
// reuse (4 x 4 outputs a thread); tensor cores would need a split-precision
// scheme to keep f32 accuracy.

#include <math.h>
#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int TR = 32;    // rows of desc1 per block
constexpr int TC = 64;    // rows of desc2 (similarity columns) per block
constexpr int DK = 32;    // depth chunk staged in shared memory
constexpr int NT = 128;   // threads: 8 row groups x 16 column groups, 4 x 4 outputs each

__global__ void __launch_bounds__(NT)
sim_tile_kernel(const float* __restrict__ a, const float* __restrict__ b,
                const float* __restrict__ ainv, const float* __restrict__ binv,
                float* __restrict__ rpart_val, int* __restrict__ rpart_idx,
                float* __restrict__ cpart_val, int* __restrict__ cpart_idx,
                int t1, int t2, int d) {
    __shared__ __align__(16) float a_s[DK][TR + 4];   // transposed: a_s[k][row]
    __shared__ __align__(16) float b_s[DK][TC + 4];
    __shared__ float s_s[TR][TC + 1];

    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int r0 = blockIdx.y * TR, c0 = blockIdx.x * TC;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += DK) {
        for (int i = tid; i < TR * DK; i += NT) {
            const int r = i / DK, kk = i % DK, gr = r0 + r, gk = k0 + kk;
            a_s[kk][r] = (gr < t1 && gk < d) ? a[(long)gr * d + gk] : 0.f;
        }
        for (int i = tid; i < TC * DK; i += NT) {
            const int c = i / DK, kk = i % DK, gc = c0 + c, gk = k0 + kk;
            b_s[kk][c] = (gc < t2 && gk < d) ? b[(long)gc * d + gk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < DK; ++kk) {
            const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
            const float ar[4] = {av.x, av.y, av.z, av.w};
            const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int r = ty * 4 + i, c = tx * 4 + j, gr = r0 + r, gc = c0 + c;
            s_s[r][c] = (gr < t1 && gc < t2) ? acc[i][j] * ainv[gr] * binv[gc] : -INFINITY;
        }
    __syncthreads();

    if (tid < TR) {                      // row partials over this tile's columns
        const int gr = r0 + tid;
        float best = -INFINITY;
        int arg = c0;
        for (int c = 0; c < TC && c0 + c < t2; ++c)
            if (s_s[tid][c] > best) { best = s_s[tid][c]; arg = c0 + c; }
        if (gr < t1) {
            rpart_val[(long)blockIdx.x * t1 + gr] = best;
            rpart_idx[(long)blockIdx.x * t1 + gr] = arg;
        }
    } else if (tid < TR + TC) {          // column partials over this tile's rows
        const int c = tid - TR, gc = c0 + c;
        float best = -INFINITY;
        int arg = r0;
        for (int r = 0; r < TR && r0 + r < t1; ++r)
            if (s_s[r][c] > best) { best = s_s[r][c]; arg = r0 + r; }
        if (gc < t2) {
            cpart_val[(long)blockIdx.y * t2 + gc] = best;
            cpart_idx[(long)blockIdx.y * t2 + gc] = arg;
        }
    }
}

__global__ void reduce_partials_kernel(const float* __restrict__ rpart_val,
                                       const int* __restrict__ rpart_idx, int n_ct,
                                       const float* __restrict__ cpart_val,
                                       const int* __restrict__ cpart_idx, int n_rt,
                                       float* __restrict__ rmax, int* __restrict__ rarg,
                                       float* __restrict__ cmax, int* __restrict__ carg,
                                       int t1, int t2) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < t1) {
        float best = -INFINITY;
        int arg = 0;
        for (int p = 0; p < n_ct; ++p) {
            const float val = rpart_val[(long)p * t1 + i];
            if (val > best) { best = val; arg = rpart_idx[(long)p * t1 + i]; }
        }
        rmax[i] = best;
        rarg[i] = arg;
    } else if (i < t1 + t2) {
        const int j = i - t1;
        float best = -INFINITY;
        int arg = 0;
        for (int p = 0; p < n_rt; ++p) {
            const float val = cpart_val[(long)p * t2 + j];
            if (val > best) { best = val; arg = cpart_idx[(long)p * t2 + j]; }
        }
        cmax[j] = best;
        carg[j] = arg;
    }
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

// one (BR x BKD) chunk of a and one (BC x BKD) chunk of b into a stage;
// rows past t1 / t2 and depth past d load as zeros
__device__ __forceinline__ void load_stage(__nv_bfloat16* st, const __nv_bfloat16* __restrict__ a,
                                           const __nv_bfloat16* __restrict__ b, int r0, int c0,
                                           int k0, int t1, int t2, int d, int tid) {
    for (int i = tid; i < (BR + BC) * (BKD / 8); i += NTB) {
        const int r = i / (BKD / 8), c8 = (i % (BKD / 8)) * 8, gk = k0 + c8;
        const bool in_a = r < BR;
        const int grow = in_a ? r0 + r : c0 + r - BR;
        const __nv_bfloat16* src = in_a ? a : b;
        const bool ok = grow < (in_a ? t1 : t2) && gk < d;
        cp_async16(st + r * LDB + c8, ok ? src + (long)grow * d + gk : src, ok ? 16 : 0);
    }
}

// work: (t1 + t2) packed keys, then the count of finished blocks; zero at launch
__global__ void __launch_bounds__(NTB)
sim_bf16_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                unsigned long long* __restrict__ work, float* __restrict__ rmax,
                int* __restrict__ rarg, float* __restrict__ cmax, int* __restrict__ carg,
                int t1, int t2, int d) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __shared__ float rv_s[2][BR], cv_s[2][BC];
    __shared__ int ri_s[2][BR], ci_s[2][BC];
    __shared__ bool last_s;

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

    // combine the two halves and the blocks
    if (tid < BR) {
        float v = rv_s[0][tid];
        int i = ri_s[0][tid];
        take_better(v, i, rv_s[1][tid], ri_s[1][tid]);
        if (r0 + tid < t1 && i != 0x7fffffff) atomicMax(work + r0 + tid, pack_key(v, i));
    } else if (tid < BR + BC) {
        const int c = tid - BR;
        float v = cv_s[0][c];
        int i = ci_s[0][c];
        take_better(v, i, cv_s[1][c], ci_s[1][c]);
        if (c0 + c < t2 && i != 0x7fffffff) atomicMax(work + t1 + c0 + c, pack_key(v, i));
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        unsigned int* done = reinterpret_cast<unsigned int*>(work + t1 + t2);
        last_s = atomicAdd(done, 1u) == gridDim.x * gridDim.y - 1;
    }
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    for (int i = tid; i < t1 + t2; i += NTB) {   // every block's atomics are in: decode
        float v;
        int idx;
        unpack_key(__ldcg(work + i), v, idx);
        if (i < t1) { rmax[i] = v; rarg[i] = idx; }
        else { cmax[i - t1] = v; carg[i - t1] = idx; }
    }
}

}  // namespace

extern "C" int vitvs_matcher_row_tile() { return TR; }
extern "C" int vitvs_matcher_col_tile() { return TC; }

// a: (t1, d), b: (t2, d) f32 contiguous; ainv (t1,), binv (t2,) inverse row
// norms.  Scratch: rpart (n_col_tiles, t1), cpart (n_row_tiles, t2).
// Outputs rmax/rarg (t1,), cmax/carg (t2,).  Returns cudaGetLastError().
extern "C" int vitvs_dual_argmax_cosine(const void* a, const void* b, const void* ainv,
                                        const void* binv, void* rmax, void* rarg, void* cmax,
                                        void* carg, void* rpart_val, void* rpart_idx,
                                        void* cpart_val, void* cpart_idx, int t1, int t2,
                                        int d, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_ct = (t2 + TC - 1) / TC, n_rt = (t1 + TR - 1) / TR;
    sim_tile_kernel<<<dim3(n_ct, n_rt), NT, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(ainv), static_cast<const float*>(binv),
        static_cast<float*>(rpart_val), static_cast<int*>(rpart_idx),
        static_cast<float*>(cpart_val), static_cast<int*>(cpart_idx), t1, t2, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    reduce_partials_kernel<<<(t1 + t2 + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const float*>(rpart_val), static_cast<const int*>(rpart_idx), n_ct,
        static_cast<const float*>(cpart_val), static_cast<const int*>(cpart_idx), n_rt,
        static_cast<float*>(rmax), static_cast<int*>(rarg), static_cast<float*>(cmax),
        static_cast<int*>(carg), t1, t2);
    return static_cast<int>(cudaGetLastError());
}

// bf16 mode.  a: (t1, d), b: (t2, d) bf16 unit rows, contiguous, d a
// multiple of 8; work: (t1 + t2 + 1) x 8 bytes of scratch (zeroed here).
// Outputs rmax/rarg (t1,), cmax/carg (t2,).  Returns the first CUDA error.
extern "C" int vitvs_dual_argmax_bf16(const void* a, const void* b, void* work, void* rmax,
                                      void* rarg, void* cmax, void* carg, int t1, int t2,
                                      int d, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaFuncSetAttribute(sim_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BF16);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaMemsetAsync(work, 0, (size_t)(t1 + t2 + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((t2 + BC - 1) / BC, (t1 + BR - 1) / BR);
    sim_bf16_kernel<<<grid, NTB, SMEM_BF16, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<unsigned long long*>(work), static_cast<float*>(rmax),
        static_cast<int*>(rarg), static_cast<float*>(cmax), static_cast<int*>(carg), t1, t2, d);
    return static_cast<int>(cudaGetLastError());
}
