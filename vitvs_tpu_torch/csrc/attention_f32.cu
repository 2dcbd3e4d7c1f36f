// Exact softmax attention for the ViT in f32: f32 in and out, f32-accurate
// logits, probabilities and P.V (the f32 servo step, the reference's
// strict-parity numerics).  The bf16 kernel is csrc/attention.cu.
//
// Replaces the Pallas kernel vitvs_tpu/ops/attention.py:_flash_kernel
// (mha_attention(fast=False)) on f32 inputs, where it sizes its output as
// q's dtype and its cast of P to v's dtype is a no-op.
//
// Arithmetic: split-precision TF32 (3 passes) on the tensor cores, f32
// accurate.  One TF32 product keeps 10 mantissa bits (about 1e-3 relative,
// which would show in the descriptors), so each operand x is split as
// hi = x with its low 13 bits cleared (an integer AND: the card converts
// types at the SFU's rate) and lo = x - hi (exact in f32), and each product
// is hi.hi + hi.lo + lo.hi, three wgmma into one f32 accumulator (the small
// ones first); the dropped lo.lo is below 2^-20 of a term.  This is not the
// TF32 mode that ServoModel.create turns off for cuBLAS (one pass, 10 bits).
// The logits are q.k scaled by hd^-0.5 = 0.125 (exact), the softmax
// takes a running row max, and the probabilities
// exp2(s 0.125 log2(e) - m 0.125 log2(e)) (one FFMA and one ex2.approx.ftz)
// stay f32 until their own split; the division by the row sum comes after
// P.V (the TPU kernel divides before; the same softmax up to rounding).  Key
// columns >= T get -inf before the max; every key chunk holds a real key,
// so the max is finite.
//
// Layout: q, k, v, o are (B, T, H, 64) contiguous.  A block computes 128
// query rows of one (batch, head) with two warpgroups of 64 rows; a cluster
// of CL blocks along x splits the keys of those rows (block rank r takes the
// 64-key chunks r, r + CL, ...).  Per chunk a warpgroup runs, on the tensor
// cores:
//   * S (64 x 64) = Q K^T: wgmma m64n64k8 tf32, Q's hi and lo as register A
//     operands (split once at the start), K's hi and lo from shared memory
//     in the 128-byte swizzle (K's rows are along d: K-major as they come);
//   * the chunk's row max (four threads hold a row), the rescale of O and
//     of the row sums, and exp2 of the scores, split in registers into the
//     A operands of P.V: the accumulator holds keys 2t and 2t + 1 of each
//     8-key group where a tf32 A fragment holds t and t + 4, so V^T is
//     staged with the keys of each group in the order 0,2,4,6,1,3,5,7 (a
//     permutation of the summed index) and P feeds wgmma as it is;
//   * O (64 x 64) += P V: TF32 wgmma takes B K-major only, so V is staged
//     transposed (V^T's rows along the keys), hi and lo.
// Staging: cp.async copies each chunk's raw K and V rows (32 KB) into a
// 2-stage ring; all 256 threads then split them into the chunk's hi/lo K
// and V^T tiles (64 KB, 4 swizzled tiles; conflict-free float4 stores) in
// one of two slots.  The split of chunk it + 1 runs while the S products of
// chunk it are in flight, and the copy of chunk it + 3 starts once the ring
// stage of chunk it + 1 is split: 192 KB of shared memory a block.  At the
// end each block puts its rows' (m, l, O) in shared memory and the cluster
// merges them through distributed shared memory in rank order (M = max m_j,
// O = sum O_j 2^((m_j - M) c) / sum l_j 2^((m_j - M) c)): no atomics, two
// launches give the same bits.  The entry point picks CL when 128-row blocks
// alone would leave SMs idle: the fewest chunks a block that the SMs (and
// clusters of at most 4) allow, over as few blocks as give it: CL = 4 at
// (1, 485, 6, 64) (96 blocks, 2 chunks each), CL = 1 at (1, 1370, 12, 64)
// (132 blocks, 22 chunks each).
//
// Bound on the card (H100 SXM) at (1, 485, 6, 64): operations.  f32-accurate
// work on the tensor cores is 3 TF32 passes of 0.361 GFLOP, 2.19 us at 495
// TFLOP/s, against 2.98 MB of q, k, v, o in 0.89 us at 3.35 TB/s (the same
// work in f32 FMA outside the tensor cores: 5.4 us at 67 TFLOP/s).  At
// (1, 1370, 12, 64): 3 x 5.77 GFLOP in 35 us.  What holds it above the bound
// at T = 485 is fixed cost, not the passes (a build with one pass ran only a
// little faster): the first chunks' load and split, the cluster merge, 96 of
// 132 SMs busy, rows and keys padded to 512.  At T = 1370 it is the work:
// the three passes, P.V, and shared-memory traffic (each warpgroup reads its
// B operands from shared memory, beside the split's reads and writes): a
// build without any one of them ran visibly faster.  One warpgroup's products
// also wait on its own softmax (two warpgroups an SM).

#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sm90_ptx.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 64;              // head dim: a K or V row is 256 B, two swizzle rows
constexpr int BK = 64;              // keys a chunk
constexpr int RW = 2;               // warpgroups a block, 64 query rows each
constexpr int BQ = 64 * RW;         // query rows a block
constexpr int NT = 128 * RW;        // threads a block
constexpr int MAX_CLUSTER = 4;      // blocks of a cluster (the size measured fastest)
constexpr float C = 0.125f * 1.4426950408889634f;   // hd^-0.5 log2(e), applied to f32 scores
constexpr int TILE = BK * HD;       // floats of a 64 x 64 tile (16 KB)
constexpr int HALF = TILE / 2;      // floats of one 128-byte-swizzled half (32 columns)
constexpr int RAW = 2 * TILE;       // a ring stage: K rows, then V rows (row-major)
constexpr int PREP = 4 * TILE;      // a slot: K hi, K lo, V^T hi, V^T lo (swizzled)
constexpr int SLOTS = 2, STAGES = 2;
constexpr int SMEM = (SLOTS * PREP + STAGES * RAW) * 4 + 1024;   // + alignment slack
constexpr int LDO = HD + 4;         // row stride of the merge's O
static_assert(BQ * LDO + 2 * BQ <= STAGES * RAW, "the merge fits in the ring");

// a chunk's raw K and V rows [k0, k0 + 64) into a ring stage; rows >= T load as zeros
__device__ __forceinline__ void load_chunk(float* dst, const float* __restrict__ kb,
                                           const float* __restrict__ vb, int k0, int T,
                                           long row_stride, int tid) {
#pragma unroll
    for (int j0 = 0; j0 < 2 * BK * (HD / 4) / NT; ++j0) {
        const int i = tid + j0 * NT;
        const int which = i / (BK * (HD / 4)), j = i % (BK * (HD / 4));
        const int r = j / (HD / 4), c = (j % (HD / 4)) * 4;
        const float* src = which ? vb : kb;
        const bool ok = k0 + r < T;
        cp_async16(dst + which * TILE + r * HD + c,
                   ok ? src + (long)(k0 + r) * row_stride + c : src, ok ? 16 : 0);
    }
}

__device__ __forceinline__ void split4(const float4& x, float4& hi, float4& lo) {
    hi = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
    lo = make_float4(x.x - hi.x, x.y - hi.y, x.z - hi.z, x.w - hi.w);
}

// a ring stage's raw chunk into a slot's four tiles, each two 128-byte-swizzled
// halves of 64 rows x 32 floats (16-byte chunk c of row r at c ^ (r % 8)):
// K hi/lo with rows = keys, halves = d; V^T hi/lo with rows = d, halves =
// keys, the keys of each 8-key group in the order 0,2,4,6,1,3,5,7
__device__ __forceinline__ void split_chunk(float* __restrict__ slot,
                                            const float* __restrict__ raw, int tid) {
#pragma unroll
    for (int j = 0; j < BK * (HD / 4) / NT; ++j) {      // a float4 of K: key r, d 4 cc ..
        const int i = tid + j * NT;
        const int r = i / (HD / 4), cc = i % (HD / 4);
        float4 hi, lo;
        split4(*reinterpret_cast<const float4*>(raw + r * HD + cc * 4), hi, lo);
        const int at = (cc / 8) * HALF + r * 32 + (((cc % 8) ^ (r & 7)) * 4);
        *reinterpret_cast<float4*>(slot + at) = hi;
        *reinterpret_cast<float4*>(slot + TILE + at) = lo;
    }
    const float* vr = raw + TILE;
#pragma unroll
    for (int j = 0; j < BK * (HD / 4) / NT; ++j) {      // keys kk, kk + 2, + 4, + 6 at d
        const int i = tid + j * NT;
        const int d = i % HD, rest = i / HD;           // a warp: 32 d of one key group
        const int half = rest / 8, grp = (rest / 2) % 4, par = rest % 2;
        const int kk = half * 32 + grp * 8 + par;
        const float4 x = make_float4(vr[kk * HD + d], vr[(kk + 2) * HD + d],
                                     vr[(kk + 4) * HD + d], vr[(kk + 6) * HD + d]);
        float4 hi, lo;
        split4(x, hi, lo);
        const int at = half * HALF + d * 32 + (((2 * grp + par) ^ (d & 7)) * 4);
        *reinterpret_cast<float4*>(slot + 2 * TILE + at) = hi;
        *reinterpret_cast<float4*>(slot + 3 * TILE + at) = lo;
    }
}

// S (64 x 64) of this warpgroup's rows against a slot's K: the small
// products first, then hi.hi; committed, not waited for
__device__ __forceinline__ void issue_scores(float (&sacc)[8][4], const uint32_t (&qhi)[HD / 8][4],
                                             const uint32_t (&qlo)[HD / 8][4], uint32_t slot) {
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < HD / 8; ++s) {     // 8 head dims a step: 32 B along K's rows
        const uint32_t at = slot + (s / 4) * HALF * 4 + (s % 4) * 32;
        wgmma_m64n64k8_tf32(sacc, qlo[s], gmma_desc<128>(at), s);
        wgmma_m64n64k8_tf32(sacc, qhi[s], gmma_desc<128>(at + TILE * 4), 1);
    }
#pragma unroll
    for (int s = 0; s < HD / 8; ++s)
        wgmma_m64n64k8_tf32(sacc, qhi[s], gmma_desc<128>(slot + (s / 4) * HALF * 4 + (s % 4) * 32),
                            1);
    wgmma_commit();
}

// the chunk's softmax and O += P V for this thread's two rows, once S has
// landed.  m, l: the rows' running max (of the raw scores) and this thread's
// share of their sums.  MASK: some of the chunk's keys are >= T.
template <bool MASK>
__device__ __forceinline__ void softmax_pv(float (&sacc)[8][4], float (&oacc)[HD / 8][4],
                                           float (&m)[2], float (&l)[2], uint32_t slot, int k0,
                                           int T, int t4) {
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {     // sacc[n][i]: row g (+8 for i >= 2), key 8n + 2 t4 + (i & 1)
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
        const float alpha = ex2((m[r] - mx[r]) * C);    // m = -inf on the first chunk: 0
        m[r] = mx[r];                                   // finite: column k0 < T is real
        mc[r] = mx[r] * C;
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            oacc[n][2 * r] *= alpha;
            oacc[n][2 * r + 1] *= alpha;
        }
    }

    // A fragments of the 8-key step n: {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)}
    // in V^T's key order, that is keys {2t, 2t, 2t + 1, 2t + 1} of rows {g, g + 8, g, g + 8}
    uint32_t phi[BK / 8][4], plo[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
        float e[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = ex2(fmaf(sacc[n][i], C, -mc[i >> 1]));
        l[0] += e[0] + e[1];
        l[1] += e[2] + e[3];
        const float a[4] = {e[0], e[2], e[1], e[3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float hi = tf32_hi(a[i]);
            phi[n][i] = __float_as_uint(hi);
            plo[n][i] = __float_as_uint(a[i] - hi);
        }
    }

    const uint32_t vt = slot + 2 * TILE * 4;
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {     // 8 keys a step: 32 B along V^T's rows
        const uint32_t at = vt + (n / 4) * HALF * 4 + (n % 4) * 32;
        wgmma_m64n64k8_tf32(oacc, plo[n], gmma_desc<128>(at), 1);
        wgmma_m64n64k8_tf32(oacc, phi[n], gmma_desc<128>(at + TILE * 4), 1);
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
        wgmma_m64n64k8_tf32(oacc, phi[n], gmma_desc<128>(vt + (n / 4) * HALF * 4 + (n % 4) * 32),
                            1);
    wgmma_commit_wait();
    wgmma_fence_operand(oacc);
}

// grid: (ceil(T / 128) x CL, B x H), clusters of CL blocks along x
__global__ void __launch_bounds__(NT, 1)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int T, int H, int CL) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // the swizzle is a function of address bits: the slots start 1024-aligned
    float* smem = reinterpret_cast<float*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
    float* slots = smem;                       // SLOTS x PREP
    float* ring = smem + SLOTS * PREP;         // STAGES x RAW
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;    // mma groupID, thread in group
    const int b = blockIdx.y / H, h = blockIdx.y % H;
    const long row_stride = (long)H * HD;
    const long base = (long)b * T * row_stride + (long)h * HD;
    const float* kb = k + base;
    const float* vb = v + base;
    const int q0 = (blockIdx.x / CL) * BQ;
    const int nchunk = (T + BK - 1) / BK;
    const int nit = rank < nchunk ? (nchunk - rank + CL - 1) / CL : 0;   // this rank's chunks
    const auto key0 = [&](int it) { return (rank + CL * it) * BK; };

    // chunks 0 and 1 into the ring (one commit group each, empty ones included)
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
        if (st < nit) load_chunk(ring + st * RAW, kb, vb, key0(st), T, row_stride, tid);
        cp_async_commit();
    }

    // Q's A fragments, split: rows row0 and row0 + 8, head dims 8 s + t4 (+4)
    const int row0 = q0 + (warp / 4) * 64 + (warp % 4) * 16 + g, row1 = row0 + 8;
    uint32_t qhi[HD / 8][4], qlo[HD / 8][4];
    {
        const bool ok0 = row0 < T, ok1 = row1 < T;
        const float* p0 = q + base + (long)(ok0 ? row0 : 0) * row_stride + t4;
        const float* p1 = q + base + (long)(ok1 ? row1 : 0) * row_stride + t4;
#pragma unroll
        for (int s = 0; s < HD / 8; ++s) {
            const float x[4] = {ok0 ? p0[8 * s] : 0.f, ok1 ? p1[8 * s] : 0.f,
                                ok0 ? p0[8 * s + 4] : 0.f, ok1 ? p1[8 * s + 4] : 0.f};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float hi = tf32_hi(x[i]);
                qhi[s][i] = __float_as_uint(hi);
                qlo[s][i] = __float_as_uint(x[i] - hi);
            }
        }
    }

    float oacc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    if (nit > 0) {                             // uniform over the block
        cp_async_wait<STAGES - 1>();           // chunk 0 has landed
        __syncthreads();
        split_chunk(slots, ring, tid);
        fence_async_smem();
        __syncthreads();                       // slot 0 ready, ring stage 0 free
        if (2 < nit) load_chunk(ring, kb, vb, key0(2), T, row_stride, tid);
    }
    cp_async_commit();

    for (int it = 0; it < nit; ++it) {
        const int cur = it & 1;
        const uint32_t slot = smem_addr(slots + cur * PREP);
        float sacc[BK / 8][4];
        issue_scores(sacc, qhi, qlo, slot);
        if (it + 1 < nit) {                    // uniform: split chunk it + 1 under the products
            cp_async_wait<1>();                // chunk it + 1 has landed (it + 2 may be in flight)
            __syncthreads();
            split_chunk(slots + (cur ^ 1) * PREP, ring + ((it + 1) & 1) * RAW, tid);
            fence_async_smem();
        }
        wgmma_wait();
        wgmma_fence_operand(sacc);
        const int k0 = key0(it);
        if (k0 + BK <= T)
            softmax_pv<false>(sacc, oacc, m, l, slot, k0, T, t4);
        else
            softmax_pv<true>(sacc, oacc, m, l, slot, k0, T, t4);
        __syncthreads();                       // slot cur consumed, chunk it + 1 split, its stage free
        if (it + 3 < nit)                      // uniform
            load_chunk(ring + ((it + 1) & 1) * RAW, kb, vb, key0(it + 3), T, row_stride, tid);
        cp_async_commit();
    }
    cp_async_wait<0>();

#pragma unroll
    for (int r = 0; r < 2; ++r) {              // the four threads of a group: one row's sum
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }

    // this block's (m, l, O) of its 128 rows into the ring, for the cluster
    float* o_s = ring;                         // BQ x LDO
    float* ml_s = o_s + BQ * LDO;              // BQ x 2: m, l
    const int lr = row0 - q0;
    {
        float* p = o_s + lr * LDO + 2 * t4;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
            p[n * 8] = oacc[n][0];
            p[n * 8 + 1] = oacc[n][1];
            p[8 * LDO + n * 8] = oacc[n][2];
            p[8 * LDO + n * 8 + 1] = oacc[n][3];
        }
        if (t4 == 0) {
            ml_s[lr * 2] = m[0];
            ml_s[lr * 2 + 1] = l[0];
            ml_s[(lr + 8) * 2] = m[1];
            ml_s[(lr + 8) * 2 + 1] = l[1];
        }
    }
    cluster.sync();                            // every block's partials are in

    // rank r normalizes rows r, r + CL, ...: the partials of the cluster in rank order
    const int nrows = (BQ - rank + CL - 1) / CL;
    for (int e = tid; e < nrows * (HD / 4); e += NT) {
        const int rr = rank + CL * (e / (HD / 4)), c = (e % (HD / 4)) * 4;
        float M = -INFINITY;
        for (int j = 0; j < CL; ++j)
            M = fmaxf(M, cluster.map_shared_rank(ml_s, j)[rr * 2]);
        // M is finite (rank 0's chunk 0 is real); a rank with no chunk has m = -inf, weight 0
        float L = 0.f;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < CL; ++j) {
            const float* ml = cluster.map_shared_rank(ml_s, j) + rr * 2;
            const float f = ex2((ml[0] - M) * C);
            L += ml[1] * f;
            const float4 x =
                *reinterpret_cast<const float4*>(cluster.map_shared_rank(o_s, j) + rr * LDO + c);
            acc.x += x.x * f;
            acc.y += x.y * f;
            acc.z += x.z * f;
            acc.w += x.w * f;
        }
        const float inv = 1.f / L;
        if (q0 + rr < T)
            *reinterpret_cast<float4*>(o + base + (long)(q0 + rr) * row_stride + c) =
                make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
    }
    cluster.sync();                            // no block leaves while another reads its partials
}

}  // namespace

// q, k, v, o: (B, T, H, 64) f32, contiguous, 16-byte aligned.  Clusters of
// CL blocks split the keys when 128-row blocks alone would leave SMs idle
// (CL as in the header).  Returns the first CUDA error.
extern "C" int vitvs_attention_f32_fwd(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int H, void* stream) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(attention_f32_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long tiles = (long)((T + BQ - 1) / BQ) * B * H;
    const int nchunk = (T + BK - 1) / BK;
    const long fit = sms / tiles;              // blocks a tile could have, SMs shared out
    const int most = (int)(fit < 1 ? 1 : fit > MAX_CLUSTER ? MAX_CLUSTER : fit);
    const int per = (nchunk + most - 1) / most;            // chunks a block
    const int CL = (nchunk + per - 1) / per;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((T + BQ - 1) / BQ * CL, B * H);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, attention_f32_kernel, static_cast<const float*>(q),
                             static_cast<const float*>(k), static_cast<const float*>(v),
                             static_cast<float*>(o), T, H, CL);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
