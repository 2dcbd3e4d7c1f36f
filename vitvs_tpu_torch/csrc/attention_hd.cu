// Exact softmax attention at any head width from 1 to 1024, bf16 or f32 in
// and out, f32 scores, softmax and accumulation, on the tensor cores.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel (call
// :151, mha_attention(fast=False)) where the head width is not 64.  The
// pixel baselines (vitvs_tpu/models/baselines.py) have one head of width
// 3 P^2: 27, 48, 147, 192, 588 and 768 for pixel3, 4, 7, 8, 14 and 16.  The
// TPU kernel's blocks are (1, q_tile, D) whatever D is; csrc/attention.cu
// and csrc/attention_f32.cu are built for D = 64.  Q is scaled by D^-0.5,
// keys >= T get no mass, P is rounded to v's dtype before P.V, and the
// output is in q's dtype.
//
// Bound on the card (H100 SXM): at pixel14 @ 308, (1, 485, 1, 588) bf16,
// 4 x 570 KB of q, k, v, o in 0.68 us at 3.35 TB/s against 0.55 GFLOP in
// 0.56 us at 989 TFLOP/s: bytes.  At pixel8 @ 112, (1, 197, 1, 192) f32,
// three TF32 passes of 0.030 GFLOP in 0.18 us at 495 TFLOP/s against
// 0.61 MB in 0.18 us: operations, barely.  What holds a kernel at these
// sizes is latency: one head, a few 64-row Q tiles, a chain of key blocks.
//
// What the first design of this kernel lost: a grid of (B H, Q tiles, 64-wide
// output slices) in which every block recomputed the whole 64 x 64 score
// tile over all D dims for its own 64 output columns (10 times the QK^T
// work at D = 588), all of it in f32 FMA on the CUDA cores, Q, K and V
// staged an element a thread with nothing in flight under the arithmetic:
// 0.8159 ms bf16 at pixel14's shape and 0.1129 ms f32 at pixel8's, against
// SDPA's 0.1970 and 0.0336 ms (H100 80GB HBM3, 700.00 W).
//
// This design computes the scores once.  A thread-block cluster of CL <= 8
// blocks shares a 64-row Q tile; block rank r owns head dims [r S, r S + S),
// S = 16 NS (D zero-padded to the 16-dim k-step; CL = ceil(D / 32) up to 8,
// S as even as 16 allows: 8 x 80 at D = 588, 6 x 32 at 192, 2 x 32 at 48).
// Grid (ceil(T / 64) CL, B H), 128 threads a block, four warps of 16 rows.
// The scores of 64-row x 64-key block j:
//   * every block contracts its own dims of Q and K into a partial tile
//     (mma.sync) and stores row i into the shared memory of the row's owner
//     (rank i / ceil(64 / CL)) by st.async, which completes its bytes on the
//     owner's transaction barrier (mbarrier);
//   * the owner sums its rows' CL partials in rank order (two launches give
//     the same bits), masks keys >= T to -inf, runs the online softmax (a
//     running row max m and sum l in registers, P = exp2(s c - m c) with
//     c = D^-0.5 log2(e), alpha = exp2((m_old - m) c), 0 on the first
//     block) and stores P's rows and alpha into every block of the cluster
//     the same way;
//   * every block rescales its O slice by alpha and adds P V for its own
//     output columns (mma.sync).
// No block contracts Q and K over another block's dims or for another
// block's output columns, and a row's softmax runs once, in its owner.  The
// blocks meet by point-to-point transaction barriers, not by cluster
// barriers: two cluster barriers a key block, whose releases also wait for
// the copies in flight, held this design's first version far above its
// present time on the card.  The loop is
// pipelined: a block sends block j + 1's partial scores while P_j travels
// and applies P_j V after (two P tiles and two receive buffers, so no
// barrier guards their reuse: a block writes into a buffer only after the
// mbarrier chain shows its readers are past it).  At the end the owners
// send the row sums, one cluster barrier, and each block writes O / l.
//
// Products: bf16 mma.sync m16n8k16 with f32 accumulation, fragments by
// ldmatrix (V read transposed).  f32: split-precision TF32 (3 passes) on
// mma.sync m16n8k8, f32 accurate: each operand x splits into hi = tf32_hi(x)
// (the low 13 bits cleared) and lo = x - hi (exact), each product is
// lo.hi + hi.lo + hi.hi (lo.lo, below 2^-20 of a term, dropped), as
// csrc/attention_f32.cu does on wgmma; never one-pass TF32.  mma.sync, not
// wgmma: a slice is any multiple of 16 dims and its rows arrive at whatever
// alignment the pointers allow, which the 128-byte-swizzled operand layouts
// of wgmma do not take.  The kernel is a template on NS, so the products
// unroll without a per-tile guard (a runtime guard serialized them).
//
// Loads: Q's slice once, the slices of K and V of each key block through a
// ring of 3 stages (2 where 3 do not fit: f32 at S >= 96) of cp.async, one
// key block ahead of the scores.  The copy width is the widest of 16, 8 and
// 4 bytes that divides every pointer and a row's D * sizeof(T) bytes (so
// also the row stride): pixel14's k and v, slices of one (3, B, T, 1, 588)
// tensor, start 8 bytes past a 16-byte boundary and take 8-byte copies;
// bf16 rows of odd D (pixel3's 27, pixel7's 147) are 2-byte aligned and
// load by scalar loads.  Rows >= T and dims >= D load as zeros.  One launch
// a call, no copy kernel.
//
// Rounding: the f32 scores are summed over the cluster, scaled through c,
// and exp2 is one ex2.approx.ftz.  bf16: the unnormalized P = exp2(s c -
// m c) of the running max is rounded to bf16 before P.V (the TPU kernel
// and the plain version round the normalized P), l sums the unrounded f32
// P, and O is divided by l at the end.  f32: P stays f32 until its split.
// Every key block holds a real key, so a row's max is finite (T = 1 and a
// ragged last block included).
//
// Shared memory (dynamic, cudaFuncSetAttribute): Q slice, ring, P tiles with
// their alphas, two receive buffers of CL x ceil(64 / CL) score rows, the
// row sums and four barriers: 132,896 bytes at D = 588 bf16, 227,296 at
// most (f32 at D = 560; f32 above D = 896 keeps one P tile to fit).  The geometry (cluster, slice, stages, P tiles,
// copy width, bytes) is make_plan below, which
// vitvs_tpu_torch/ops/attention.py:hd_plan mirrors; vitvs_attention_hd_plan
// returns it so that chip_smoke.py holds the two equal.
//
// Measured (chip_smoke.py time_pixel_kernels, CUDA events over 200 calls,
// H100 80GB HBM3, 700.00 W): 0.0343 ms bf16 at (1, 485, 1, 588) against
// SDPA's 0.2032; 0.0221 ms f32 at (1, 197, 1, 192) against SDPA f32's
// 0.0341; 0.1670 ms bf16 at (1, 1370, 1, 588) against 0.1934.  Per key
// block the time goes to the distributed shared memory traffic (16 KB of
// partial scores and 8 to 16 KB of P a block), which shares the memory pipe
// with the loads and the fragment reads: the issue of the copies, the
// owner's softmax with its P stores and the score stores take most of a key
// block's cycles (scripts/port_attention_hd_profile.py).  PERF.md keeps the
// times.

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "sm90_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BQ = 64;              // query rows a cluster: four warps of 16
constexpr int BK = 64;              // keys a step
constexpr int NT = 128;             // threads a block
constexpr int KSTEP = 16;           // head dims are padded to the bf16 mma's k
constexpr int MIN_SLICE = 32;       // head dims a block at least, where D allows
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_D = 1024;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have
constexpr int LDS = BK + 4;         // floats a row of the receive buffer
constexpr int ROWS_A_PASS = NT / 8; // the owner's softmax: 8 threads a row
constexpr int OWN_PASSES = BQ / ROWS_A_PASS;

struct Plan {
    int cluster, slice, stages, pbufs, copy, smem;
    int ldq, ldv, ldp, rpo;         // row strides (elements) of Q and K, V, P; rows an owner has
};

// the launch geometry for head width D, elements of es bytes and pointers
// whose OR is addr (ops/attention.py:hd_plan computes the same)
Plan make_plan(int D, int es, unsigned long long addr) {
    Plan p{};
    const int dp = (D + KSTEP - 1) / KSTEP * KSTEP;
    int cl = (dp + MIN_SLICE - 1) / MIN_SLICE;
    if (cl > MAX_CLUSTER) cl = MAX_CLUSTER;
    p.slice = ((dp + cl - 1) / cl + KSTEP - 1) / KSTEP * KSTEP;
    p.cluster = (dp + p.slice - 1) / p.slice;
    p.copy = 16;
    const unsigned long long bits = addr | (unsigned long long)(D * es);
    while (p.copy > es && bits % p.copy) p.copy /= 2;
    // rows padded so that ldmatrix and the fragment loads meet no bank conflict
    p.ldq = p.slice + (es == 2 ? 8 : 4);
    p.ldv = p.slice + 8;
    p.ldp = BK + (es == 2 ? 8 : 4);
    p.rpo = (BQ + p.cluster - 1) / p.cluster;
    const int kv = BK * (p.ldq + p.ldv) * es;                 // a ring stage
    const int pb = BQ * p.ldp * es + BQ * 4;                  // a P tile and its alphas
    const int fixed = BQ * p.ldq * es + 2 * p.cluster * p.rpo * LDS * 4 + BQ * 4 + 4 * 8;
    // three stages and two P tiles where they fit, else two and two, else two and one
    p.stages = 3;
    p.pbufs = 2;
    if (fixed + 3 * kv + 2 * pb > SMEM_LIMIT) p.stages = 2;
    if (fixed + 2 * kv + 2 * pb > SMEM_LIMIT) p.pbufs = 1;
    p.smem = fixed + p.stages * kv + p.pbufs * pb;
    return p;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
    return __float2bfloat16_rn(0.f);
}

// rows [r0, r0 + 64) and head dims [d0, d0 + WIDTH) of a (T, row_stride)
// matrix into a shared tile of row stride ld: 16-byte units, each by copies
// of `copy` bytes (cp.async; 2: scalar loads).  Rows >= T and dims >= D are
// zeros (a copy lies wholly inside or wholly outside a row's D elements).
template <int WIDTH, typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* __restrict__ src, int r0,
                                          int n_tok, long row_stride, int d0, int D, int copy,
                                          int tid) {
    constexpr int EU = 16 / sizeof(T);             // elements a unit
    constexpr int U = WIDTH / EU;                  // units a row
    static_assert(64 * U % NT == 0, "whole units a thread");
#pragma unroll
    for (int it = 0; it < 64 * U / NT; ++it) {
        const int u = tid + it * NT, r = u / U, col = d0 + (u % U) * EU;
        const bool row_ok = r0 + r < n_tok;
        const T* s = src + (long)(row_ok ? r0 + r : 0) * row_stride + col;
        unsigned char* d = reinterpret_cast<unsigned char*>(dst + r * ld + (u % U) * EU);
        if (copy == 16) {
            const bool ok = row_ok && col < D;
            cp_async16(d, ok ? s : src, ok ? 16 : 0);
        } else if (copy == 8) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = h * (8 / sizeof(T));
                const bool ok = row_ok && col + c < D;
                cp_async8(d + 8 * h, ok ? s + c : src, ok ? 8 : 0);
            }
        } else if (copy == 4) {
#pragma unroll
            for (int h = 0; h < 4; ++h) {
                const int c = h * (4 / sizeof(T));
                const bool ok = row_ok && col + c < D;
                cp_async4(d + 4 * h, ok ? s + c : src, ok ? 4 : 0);
            }
        } else {
#pragma unroll
            for (int h = 0; h < EU; ++h)
                reinterpret_cast<T*>(d)[h] = row_ok && col + h < D ? s[h] : zero<T>();
        }
    }
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    const float h = tf32_hi(x);
    hi = __float_as_uint(h);
    lo = __float_as_uint(x - h);
}

// The exchanged score rows and the P rows hold the keys of each 16-key group
// in the order pi16(0), ..., pi16(15): 0, 1, 8, 9, 2, 3, 10, 11, ..., so that
// a thread's four scores of two 8-key tiles (keys 2t, 2t + 1 and 8 + 2t,
// 9 + 2t) are one 16-byte store.  P.V reads V's rows in the same order (the
// ldmatrix row addresses), which permutes the summed index only.
__device__ __forceinline__ int pi16(int p) { return 2 * (p >> 2) + (p & 1) + 8 * ((p >> 1) & 1); }

// the partial scores of this warp's 16 rows against the block's 64 keys over
// the slice's 16 NS dims: sacc[n][i] holds row g (+8 for i >= 2), key 8n + 2t (+1)
template <int NS>
__device__ __forceinline__ void scores(float (&sacc)[8][4], const __nv_bfloat16* q_s,
                                       const __nv_bfloat16* k_s, int ld, int warp, int lane) {
    const int m = lane >> 3, i = lane & 7;
#pragma unroll
    for (int ks = 0; ks < NS; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, q_s + (warp * 16 + (lane & 15)) * ld + ks * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < 4; ++np) {     // key tiles 2 np and 2 np + 1
            uint32_t b[4];
            ldmatrix_x4(b, k_s + (np * 16 + i + 8 * (m >> 1)) * ld + ks * 16 + 8 * (m & 1));
            mma_bf16(sacc[2 * np], a, b[0], b[1]);
            mma_bf16(sacc[2 * np + 1], a, b[2], b[3]);
        }
    }
}

template <int NS>
__device__ __forceinline__ void scores(float (&sacc)[8][4], const float* q_s, const float* k_s,
                                       int ld, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
    for (int ks = 0; ks < 2 * NS; ++ks) {
        const float* qa = q_s + (warp * 16 + g) * ld + ks * 8 + t;
        uint32_t ahi[4], alo[4];
        split(qa[0], ahi[0], alo[0]);
        split(qa[8 * ld], ahi[1], alo[1]);
        split(qa[4], ahi[2], alo[2]);
        split(qa[8 * ld + 4], ahi[3], alo[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const float* kb = k_s + (n * 8 + g) * ld + ks * 8 + t;
            uint32_t bhi0, blo0, bhi1, blo1;
            split(kb[0], bhi0, blo0);
            split(kb[4], bhi1, blo1);
            mma_tf32(sacc[n], alo, bhi0, bhi1);
            mma_tf32(sacc[n], ahi, blo0, blo1);
            mma_tf32(sacc[n], ahi, bhi0, bhi1);
        }
    }
}

// O (this warp's 16 rows x the slice's 2 NS 8-column tiles) += P V, P's
// columns in pi16 order within each 16-key group
template <int NS>
__device__ __forceinline__ void pv(float (&oacc)[2 * NS][4], const __nv_bfloat16* p_s, int ldp,
                                   const __nv_bfloat16* v_s, int ldv, int warp, int lane) {
    const int m = lane >> 3, i = lane & 7;
    const int vrow = pi16(8 * (m & 1) + i);          // this lane's V row of each 16-key group
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, p_s + (warp * 16 + (lane & 15)) * ldp + kk * 16 + 8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < NS; ++np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, v_s + (kk * 16 + vrow) * ldv + np * 16 + 8 * (m >> 1));
            mma_bf16(oacc[2 * np], a, b[0], b[1]);
            mma_bf16(oacc[2 * np + 1], a, b[2], b[3]);
        }
    }
}

template <int NS>
__device__ __forceinline__ void pv(float (&oacc)[2 * NS][4], const float* p_s, int ldp,
                                   const float* v_s, int ldv, int warp, int lane) {
    const int g = lane >> 2, t = lane & 3;
    // V rows of positions t and t + 4 of each half of a 16-key group
    const int vr[2][2] = {{pi16(t), pi16(t + 4)}, {pi16(8 + t), pi16(12 + t)}};
    for (int kb = 0; kb < BK / 16; ++kb) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const float* pa = p_s + (warp * 16 + g) * ldp + kb * 16 + hf * 8 + t;
            uint32_t ahi[4], alo[4];
            split(pa[0], ahi[0], alo[0]);
            split(pa[8 * ldp], ahi[1], alo[1]);
            split(pa[4], ahi[2], alo[2]);
            split(pa[8 * ldp + 4], ahi[3], alo[3]);
            const float* v0 = v_s + (kb * 16 + vr[hf][0]) * ldv + g;
            const float* v1 = v_s + (kb * 16 + vr[hf][1]) * ldv + g;
#pragma unroll
            for (int n = 0; n < 2 * NS; ++n) {
                uint32_t bhi0, blo0, bhi1, blo1;
                split(v0[n * 8], bhi0, blo0);
                split(v1[n * 8], bhi1, blo1);
                mma_tf32(oacc[n], alo, bhi0, bhi1);
                mma_tf32(oacc[n], ahi, blo0, blo1);
                mma_tf32(oacc[n], ahi, bhi0, bhi1);
            }
        }
    }
}

// 8 probabilities of a row into block `dst`'s P row at cluster address at
// (bf16: rounded), completing their bytes on its barrier bar
__device__ __forceinline__ void send_p(uint32_t at, const float (&e)[8], uint32_t bar,
                                       const __nv_bfloat16*) {
    st_async(at, pack_bf16(e[0], e[1]), pack_bf16(e[2], e[3]), pack_bf16(e[4], e[5]),
             pack_bf16(e[6], e[7]), bar);
}
__device__ __forceinline__ void send_p(uint32_t at, const float (&e)[8], uint32_t bar,
                                       const float*) {
    st_async(at, __float_as_uint(e[0]), __float_as_uint(e[1]), __float_as_uint(e[2]),
             __float_as_uint(e[3]), bar);
    st_async(at + 16, __float_as_uint(e[4]), __float_as_uint(e[5]), __float_as_uint(e[6]),
             __float_as_uint(e[7]), bar);
}

// grid: (ceil(T / 64) x CL, B x H), clusters of CL blocks along x; slices of 16 NS dims
template <typename T, int NS>
__global__ void __launch_bounds__(NT, 1)
attention_hd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ o, int n_tok, int H, int D, float scale, Plan pl) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int CL = pl.cluster, rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int q0 = (blockIdx.x / CL) * BQ;
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const long row_stride = (long)H * D;
    const long base = ((long)b * n_tok * H + h) * D;
    const int d0 = rank * pl.slice;                 // the last slice may run past D: zeros
    constexpr int width = 16 * NS;
    const int ldq = pl.ldq, ldv = pl.ldv, ldp = pl.ldp, rpo = pl.rpo;
    const int nown = min(rpo, BQ - rank * rpo);     // rows this rank owns
    const int nbuf = pl.pbufs;
    const float C = scale * 1.4426950408889634f;    // D^-0.5 log2(e)

    // Q | ring of K, V stages | P tiles and alphas | 2 receive buffers | row sums | barriers
    T* q_s = reinterpret_cast<T*>(smem);
    T* ring = q_s + BQ * ldq;
    const int stage_elems = BK * (ldq + ldv);
    T* p_s = ring + pl.stages * stage_elems;                          // nbuf x BQ x ldp
    float* alpha_s = reinterpret_cast<float*>(p_s + nbuf * BQ * ldp);  // nbuf x BQ
    float* recv = alpha_s + nbuf * BQ;                                 // 2 x CL x rpo x LDS
    float* lfin_s = recv + 2 * CL * rpo * LDS;                         // BQ
    uint64_t* bar_recv = reinterpret_cast<uint64_t*>(lfin_s + BQ);      // 2
    uint64_t* bar_p = bar_recv + 2;                                    // nbuf
    const uint32_t p_bytes = BQ * BK * sizeof(T) + BQ * 4;            // a P phase, all owners
    const uint32_t recv_bytes = CL * nown * BK * 4;                    // a receive phase

    const T* qb = q + base;
    const T* kb = k + base;
    const T* vb = v + base;
    const int nkb = (n_tok + BK - 1) / BK;
    const auto load_kv = [&](int j) {
        T* st = ring + (j % pl.stages) * stage_elems;
        load_rows<width>(st, ldq, kb, j * BK, n_tok, row_stride, d0, D, pl.copy, tid);
        load_rows<width>(st + BK * ldq, ldv, vb, j * BK, n_tok, row_stride, d0, D, pl.copy, tid);
    };

    if (tid == 0) {
        for (int i = 0; i < 2; ++i) mbar_init(bar_recv + i, 1);
        for (int i = 0; i < nbuf; ++i) mbar_init(bar_p + i, 1);
        fence_mbar_init();
        for (int i = 0; i < 2 && i < nkb; ++i) mbar_arrive_expect_tx(bar_recv + i, recv_bytes);
        for (int i = 0; i < nbuf && i < nkb; ++i) mbar_arrive_expect_tx(bar_p + i, p_bytes);
    }
    cluster.sync();                                 // every block's barriers are armed

    // Q's slice with key block 0, then blocks 1 .. stages - 2: a commit group each
    load_rows<width>(q_s, ldq, qb, q0, n_tok, row_stride, d0, D, pl.copy, tid);
    for (int j = 0; j < pl.stages - 1; ++j) {
        if (j < nkb) load_kv(j);
        cp_async_commit();
    }

    // cluster addresses: this thread's rows' slots in their owners' receive
    // buffers, and the barriers; the owners' P rows go to every block
    uint32_t slot[2], slot_bar[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r, own = row / rpo;
        slot[r] = mapa(smem_addr(recv + (rank * rpo + row - own * rpo) * LDS + 4 * t4), own);
        slot_bar[r] = mapa(smem_addr(bar_recv), own);
    }
    const uint32_t recv_half = CL * rpo * LDS * 4;  // bytes from one receive buffer to the next

    // this slice's partial scores of key block j (landed), row i to its owner
    float sacc[8][4];
    const auto score_block = [&](int j) {
        const T* k_s = ring + (j % pl.stages) * stage_elems;
#pragma unroll
        for (int n = 0; n < 8; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
        scores<NS>(sacc, q_s, k_s, ldq, warp, lane);
    };
    const auto send_scores = [&](int j) {         // key tiles 2m, 2m + 1: 16 bytes (pi16)
        const uint32_t off = (j & 1) * recv_half;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int m = 0; m < 4; ++m)
                st_async(slot[r] + off + m * 64, __float_as_uint(sacc[2 * m][2 * r]),
                         __float_as_uint(sacc[2 * m][2 * r + 1]),
                         __float_as_uint(sacc[2 * m + 1][2 * r]),
                         __float_as_uint(sacc[2 * m + 1][2 * r + 1]), slot_bar[r] + (j & 1) * 8);
    };

    float oacc[2 * NS][4];
#pragma unroll
    for (int n = 0; n < 2 * NS; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float m_run[OWN_PASSES], l_run[OWN_PASSES];     // the owned rows' running max and sum
#pragma unroll
    for (int p = 0; p < OWN_PASSES; ++p) {
        m_run[p] = -INFINITY;
        l_run[p] = 0.f;
    }
    const int seg = tid & 7;                        // positions 8 seg .. 8 seg + 7 of an owned row
    int key[8];                                     // their keys in the block (pi16)
#pragma unroll
    for (int i = 0; i < 8; ++i) key[i] = 16 * (seg >> 1) + pi16(8 * (seg & 1) + i);

    if (pl.stages == 3)
        cp_async_wait<1>();
    else
        cp_async_wait<0>();
    __syncthreads();                                // Q and key block 0 landed
    score_block(0);
    send_scores(0);

    // Block j: the owner's softmax of S_j; the scores of block j + 1 sent
    // while P_j travels (two P tiles; with one, after P_j V); then P_j V
    for (int j = 0; j < nkb; ++j) {
        __syncthreads();                            // every warp is past P_{j-1} V
        if (j + pl.stages - 1 < nkb) load_kv(j + pl.stages - 1);   // into block j - 1's stage
        cp_async_commit();

        // the owner: S_j's rows summed in rank order, the online softmax, P_j and alpha out
        mbar_wait(bar_recv + (j & 1), (j >> 1) & 1);
        const float* rb = recv + (j & 1) * CL * rpo * LDS;
        const int k0 = j * BK, pb = j % nbuf;
#pragma unroll
        for (int pass = 0; pass < OWN_PASSES; ++pass) {
            if (pass * ROWS_A_PASS >= rpo) break;   // uniform
            const int lr = pass * ROWS_A_PASS + (tid >> 3);
            const bool mine = lr < nown;
            float s[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) s[i] = 0.f;
            if (mine) {
                for (int src = 0; src < CL; ++src) {   // rank order
                    const float* p = rb + (src * rpo + lr) * LDS + 8 * seg;
                    const float4 x0 = *reinterpret_cast<const float4*>(p);
                    const float4 x1 = *reinterpret_cast<const float4*>(p + 4);
                    s[0] += x0.x; s[1] += x0.y; s[2] += x0.z; s[3] += x0.w;
                    s[4] += x1.x; s[5] += x1.y; s[6] += x1.z; s[7] += x1.w;
                }
            }
            float mx = -INFINITY;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                if (k0 + key[i] >= n_tok) s[i] = -INFINITY;
                mx = fmaxf(mx, s[i]);
            }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
            const float m_new = fmaxf(m_run[pass], mx);     // finite: key k0 < T is real
            const float alpha = ex2((m_run[pass] - m_new) * C);   // 0 on the first block
            m_run[pass] = m_new;
            const float mc = m_new * C;
            float e[8], sum = 0.f;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                e[i] = ex2(fmaf(s[i], C, -mc));
                sum += e[i];
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            sum += __shfl_xor_sync(0xffffffffu, sum, 4);
            l_run[pass] = l_run[pass] * alpha + sum;
            if (mine) {
                const int row = rank * rpo + lr;
                const uint32_t at = smem_addr(p_s + (pb * BQ + row) * ldp + 8 * seg);
                const uint32_t at_alpha = smem_addr(alpha_s + pb * BQ + row);
                const uint32_t bar = smem_addr(bar_p + pb);
                for (int dst = 0; dst < CL; ++dst) {
                    send_p(mapa(at, dst), e, mapa(bar, dst), p_s);
                    if (seg == 0) st_async(mapa(at_alpha, dst), alpha, mapa(bar, dst));
                }
            }
        }
        if (tid == 0 && j + 2 < nkb) mbar_arrive_expect_tx(bar_recv + (j & 1), recv_bytes);

        // the scores of block j + 1 (landed: one block's loads ahead of these)
        if (j + 1 < nkb) {                          // uniform
            if (pl.stages == 3)
                cp_async_wait<1>();
            else
                cp_async_wait<0>();
            __syncthreads();
            score_block(j + 1);
            if (nbuf == 2) send_scores(j + 1);
        }

        // O = O alpha + P_j V_j for this block's output columns
        mbar_wait(bar_p + pb, (j / nbuf) & 1);
        if (tid == 0 && j + nbuf < nkb) mbar_arrive_expect_tx(bar_p + pb, p_bytes);
        const float a0 = alpha_s[pb * BQ + warp * 16 + g], a1 = alpha_s[pb * BQ + warp * 16 + g + 8];
#pragma unroll
        for (int n = 0; n < 2 * NS; ++n) {
            oacc[n][0] *= a0;
            oacc[n][1] *= a0;
            oacc[n][2] *= a1;
            oacc[n][3] *= a1;
        }
        pv<NS>(oacc, p_s + pb * BQ * ldp, ldp, ring + (j % pl.stages) * stage_elems + BK * ldq,
               ldv, warp, lane);
        if (nbuf == 1 && j + 1 < nkb) send_scores(j + 1);
    }
    cp_async_wait<0>();

    // the owners' row sums to every block, then O / l for this block's columns
#pragma unroll
    for (int pass = 0; pass < OWN_PASSES; ++pass) {
        if (pass * ROWS_A_PASS >= rpo) break;
        const int lr = pass * ROWS_A_PASS + (tid >> 3);
        if (lr < nown && seg == 0)
            for (int dst = 0; dst < CL; ++dst)
                cluster.map_shared_rank(lfin_s, dst)[rank * rpo + lr] = l_run[pass];
    }
    cluster.sync();                                 // no remote access after this
    T* ob = o + base;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int lrow = warp * 16 + g + 8 * r, row = q0 + lrow;
        if (row >= n_tok) continue;
        const float inv = 1.f / lfin_s[lrow];
#pragma unroll
        for (int n = 0; n < 2 * NS; ++n) {
            const int col = d0 + n * 8 + 2 * t4;
            if (col < D) store(ob + row * row_stride + col, oacc[n][2 * r] * inv);
            if (col + 1 < D) store(ob + row * row_stride + col + 1, oacc[n][2 * r + 1] * inv);
        }
    }
}

template <typename T, int NS>
cudaError_t launch_ns(const T* q, const T* k, const T* v, T* o, int B, int n_tok, int H, int D,
                      float scale, const Plan& pl, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(attention_hd_kernel<T, NS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n_tok + BQ - 1) / BQ * pl.cluster, B * H);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = pl.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = pl.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, attention_hd_kernel<T, NS>, q, k, v, o, n_tok, H, D, scale,
                              pl);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int n_tok, int H,
           int D, float scale, void* stream) {
    const unsigned long long addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
                                    | reinterpret_cast<uintptr_t>(v);
    if (B < 1 || n_tok < 1 || H < 1 || D < 1 || D > MAX_D || (long)B * H > 65535
        || addr % sizeof(T))
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan pl = make_plan(D, sizeof(T), addr);
    const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
            *tv = static_cast<const T*>(v);
    T* to = static_cast<T*>(o);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    switch (pl.slice / KSTEP) {
        case 1: err = launch_ns<T, 1>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 2: err = launch_ns<T, 2>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 3: err = launch_ns<T, 3>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 4: err = launch_ns<T, 4>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 5: err = launch_ns<T, 5>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 6: err = launch_ns<T, 6>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 7: err = launch_ns<T, 7>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
        case 8: err = launch_ns<T, 8>(tq, tk, tv, to, B, n_tok, H, D, scale, pl, st); break;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: (B, T, H, D) bf16, contiguous, 1 <= D <= 1024, B H <= 65535;
// scale D^-0.5 as f32.  Returns the first CUDA error.
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

// the geometry the entry points launch with, for head width D, elements of
// elem_bytes (2 or 4) and pointers whose OR is addr: out = {cluster, slice,
// ring stages, P tiles, copy width in bytes, dynamic shared memory in bytes}.  Runs on the
// host alone.
extern "C" int vitvs_attention_hd_plan(int D, int elem_bytes, long addr, int* out) {
    if (D < 1 || D > MAX_D || (elem_bytes != 2 && elem_bytes != 4))
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan p = make_plan(D, elem_bytes, static_cast<unsigned long long>(addr));
    out[0] = p.cluster;
    out[1] = p.slice;
    out[2] = p.stages;
    out[3] = p.pbufs;
    out[4] = p.copy;
    out[5] = p.smem;
    return 0;
}
