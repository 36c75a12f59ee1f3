// Fused GP posterior (mean, gradient, dt/div/Laplacian) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel scripts/pallas_posterior.py: the tile body
// `_kernel`, its grid `dom_posterior_tiles` (pallas_call at :226), and the
// boundary-set and gradient assembly `_posterior_block_fused` that ran around
// it.  One call computes PosteriorOut for n evaluation rows against every
// training row.
//
// Input, prepared once per trained state (gp/fused_posterior.py):
//   cols (F + 7, ld)  the training rows as columns (F = d + 1, time last):
//                     the interior rows, then the boundary rows, then zero
//                     columns up to ld, a multiple of the tile kBJ.  Rows
//                     0..F-1 hold y, feature-major; rows F..F+6 hold each
//                     training row's record r1, r3, r4, r5, |y|^2, spatial
//                     sum of y, y_t.  A boundary row has weights
//                     [r2, 0, 0, 0], a padding column is all zero.  A boundary
//                     row contributes exactly what an interior row with those
//                     weights would, and a padding column exactly zero, so
//                     the boundary set needs no second pass and the tiles
//                     need no mask.
//
// Pair statistics in the norm form of the plain version (gp/kernels.py
// pair_stats) and of the Pallas kernel: r^2 = max(|x|^2 + |y|^2 - 2 x.y, 0),
// q = max(r^2 - dt^2, 0), s and dt from the row sums.  The y-side numbers are
// precomputed; the x-side ones come from this kernel's prologue.
//
// What bounds it on the H100: float32 operations.  Per (x, y) pair, counted
// in this norm form (an FMA as 2, an exp as 1): 2F + 25 for u, 20 + 2F more
// for the gradient (A_sp . Y and A_t . y_t), 52 more for dt/div/lap.  At the
// main path's shapes (m = 1200 training rows, n = 1200 to 10 800 evaluation
// rows, F = 21 or 101) that is 3 to 54 us at the 67 TFLOP/s float32 peak,
// while the inputs and outputs are a few MB (about 1 us at 3.35 TB/s): every
// call is bound by the FP32 FMA rate.  The x.y depth F is too shallow for
// tensor cores and must stay IEEE float32 (no TF32).  The kernel's times
// against that bound, shape by shape, are in PERF.md.
//
// Design, against what held the first version (one warp per row) back:
//  1. Occupancy.  A block holds kBI = 64 evaluation rows and 256 threads; each
//     thread owns a 4 x 4 micro-tile of (row, training row) pairs.  Where
//     ceil(n / 64) blocks cannot fill the card, the training set is split
//     over gridDim.y = S blocks (chosen by plan() in gp/fused_posterior.py
//     from the card's SM count and this kernel's occupancy).  Every output
//     is linear in the row sums, so each split writes its share of
//     PosteriorOut to a slice of scratch and fused_posterior_reduce adds the
//     S slices in split order.  No atomics: the same bits every run.
//  2. Shared-memory traffic of the distance product.  x.y is a register-
//     tiled SIMT product: per feature a thread loads 4 x and 4 y values as
//     two 16-byte loads and does 16 FMAs; the norm form costs one FMA per
//     feature and pair where the difference form cost three instructions.
//     kappa and the u/dt/div/lap polynomials are evaluated in registers on
//     the micro-tile, with each training row's factors computed once for
//     its four pairs and dt/div/lap written through P_u (the plain
//     version's polynomials, in fewer operations).  Row sums reduce over the
//     16 threads that share a row with a fixed butterfly of shuffles.
//  3. The gradient contraction is a second register-tiled product: the
//     micro-tiles write A_sp to shared memory (64 x 64), and each thread
//     accumulates a 4-row x NC-column block of A_sp . Y_sp in registers
//     across the whole training loop (columns tx + 16 c).  A_t . y_t is one
//     more FMA per pair in the micro-tile.
//  4. Tile staging.  The feature-major y tile and its records (seven rows of
//     the tile, not 32-byte records per training row, with which the 16
//     lanes of a row group read 16 addresses in one bank) are copied with
//     cp.async, 16 bytes a thread, into a double buffer: tile t + 1 loads
//     while tile t computes, with one __syncthreads per tile (two with the
//     gradient).  No integer division in the loop.  Dynamic shared memory
//     above 48 KB is requested with cudaFuncSetAttribute; at F = 256 the
//     block takes 226 KB and still keeps full 64-row tiles.
// All arithmetic is IEEE float32 (expf, no fast-math).
//
// The bf16-operand variant (BF16 = true; PrecisionPolicy.gram = 'bfloat16',
// the JAX package's operand_dtype) computes the pair statistics from x and y
// rounded to bfloat16, as gp/kernels.py pair_stats does: a product of two
// bf16 values is exact in float32, so x.y is a bf16 product with float32
// accumulation, and |x|^2, |y|^2, the spatial sums and the time come from
// the rounded rows (the y side from prepare_inputs with operand_dtype
// bfloat16).  Its x.y runs on the tensor cores, the one thing bf16 operands
// buy on Hopper: with x.y at the 989 TFLOP/s bf16 rate, the call's bound is
// its float32 epilogue (25 operations a pair for u, 45 + 2F with the
// gradient, 52 more for dt/div/lap) over 67 TFLOP/s.
//  - x.y is mma.sync.m16n8k16 bf16 with float32 accumulators, its operands
//    loaded by ldmatrix.  Each of the 8 warps owns a 16 x 32 slab of the
//    64 x 64 tile (four n8 tiles a k-step).  The depth is F padded with zeros
//    to Fp, a multiple of 16, which adds exactly zero.  Not wgmma: with x.y
//    on the tensor cores the float32 epilogue sets the pace at every F.
//  - The operands are row-major bf16 tiles in shared memory, rows padded by
//    8 values (16 bytes) so that ldmatrix's eight row addresses fall in
//    distinct banks: the block's x rows, rounded once in the prologue, and
//    the training rows, rounded once per trained state (prepare_inputs'
//    rows_bf16, (ld, Fp)) and copied with cp.async beside the records.
//    Without the gradient the y tile is double-buffered like the records.
//    With it, one y tile fits beside the float32 feature rows that A_sp . Y
//    and A_t . y_t read (at F = 256 the block takes 223.5 KB): its copy for
//    tile t + 1 starts once the A_sp tile is complete, when every warp is
//    done with tile t's products, and runs under A_sp . Y.
//  - The epilogue works on the mma fragments where they lie: each lane
//    holds 2 rows x 8 training rows of its warp's slab and runs the same
//    per-pair code (column_pairs) as the float32 micro-tile, so a warp goes
//    from its products to its pairs without waiting for the block.  After
//    the tile loop each row's sums are added over its 4 lanes and then over
//    its two warps through shared memory, in a fixed order.
//  - The gradient's x * rowsum - A_sp . Y and A_t . y_t terms keep the
//    unrounded float32 x (read from global memory in the epilogue) and
//    training rows (the float32 y tile), as the JAX posterior does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBI = 64;          // evaluation rows per block
constexpr int kBJ = 64;          // training rows per tile
constexpr int kThreads = 256;    // 16 x 16, a 4 x 4 micro-tile each
constexpr int kLdX = kBI + 4;    // feature-major row stride of the x tile
constexpr int kLdY = kBJ + 4;    // feature-major row stride of a y tile
constexpr int kLdA = kBJ + 4;    // row stride of the A_sp tile
constexpr int kRec = 7;          // record rows after the F feature rows
constexpr int kStages = 2;
constexpr int kMaxFeatures = 256;
constexpr int kPadB = 8;         // bf16 padding of a row of the bf16 tiles

// Floats of one call's outputs, laid out [u (n) | grad (n, F) | dt, div,
// lap (n each)]: the PosteriorOut buffer, and one split's slice of scratch.
__host__ __device__ __forceinline__ size_t out_floats(bool grad, bool ops, int n, int F) {
    return (size_t)n * (1 + (grad ? F : 0) + (ops ? 3 : 0));
}

__host__ __device__ __forceinline__ int stage_floats(int F) {
    return (F + kRec) * kLdY;
}

// The bf16 variant's x.y depth, and the row stride of its bf16 tiles.
__host__ __device__ __forceinline__ int padded_depth(int F) { return (F + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int bf16_row(int F) { return padded_depth(F) + kPadB; }

// One stage of the bf16 variant: the records, after the F float32 feature
// rows where the gradient reads them.
__host__ __device__ __forceinline__ int bf16_stage_floats(bool grad, int F) {
    return ((grad ? F : 0) + kRec) * kLdY;
}

__host__ __device__ __forceinline__ size_t smem_bytes(bool grad, int F, bool bf16) {
    if (bf16) {
        // x stats, the stages, A_sp with the gradient, then the bf16 x tile
        // and the bf16 y tiles: one with the gradient, two without
        const size_t floats = 3 * kBI + kStages * (size_t)bf16_stage_floats(grad, F) +
                              (grad ? (size_t)kBI * kLdA : 0);
        return floats * sizeof(float) + (size_t)(kBI + (grad ? 1 : kStages) * kBJ) *
                                            bf16_row(F) * sizeof(__nv_bfloat16);
    }
    const size_t floats = (size_t)F * kLdX + 3 * kBI + kStages * (size_t)stage_floats(F) +
                          (grad ? (size_t)kBI * kLdA : 0);
    return floats * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8 and receives row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of each.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// c (16 x 8, float32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16,
// column-major), the fragments in mma.sync's layout.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copies of training rows j0 .. j0 + kBJ - 1 of rows_bf16 (Fp
// values each) into the bf16 y tile, 16 bytes a thread.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* yb,
                                               const __nv_bfloat16* __restrict__ rows,
                                               int Fp, int j0, int tid) {
    const int per_row = Fp / 8, ldb = Fp + kPadB;
    for (int c = tid; c < kBJ * per_row; c += kThreads) {
        const int j = c / per_row, part = c - j * per_row;
        cp_async16(yb + j * ldb + part * 8, rows + (size_t)(j0 + j) * Fp + part * 8);
    }
}

// x.y of this warp's 16 x 32 slab of the tile on the tensor cores, rows
// row0 .. row0 + 15 and columns col0 .. col0 + 31, as four n8 tiles a k-step
// of 16: c[t] is mma.sync's accumulator of n8 tile t, rows lane / 4 and
// lane / 4 + 8, columns 8 t + 2 (lane % 4) + {0, 1}, as {c0, c1, c2, c3}.
__device__ __forceinline__ void tile_dot_mma(const __nv_bfloat16* xb, const __nv_bfloat16* yb,
                                             int Fp, int lane, int row0, int col0,
                                             float (&c)[4][4]) {
    const int ldb = Fp + kPadB;
    // A: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15); B, per pair of n8
    // tiles: (tile 0 | tile 1) x (k 0-7 | 8-15)
    const unsigned a_addr = (unsigned)__cvta_generic_to_shared(
        xb + (row0 + (lane & 15)) * ldb + (lane >> 4) * 8);
    const unsigned b_addr = (unsigned)__cvta_generic_to_shared(
        yb + (col0 + (lane >> 4) * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int t = 0; t < 4; ++t) c[t][0] = c[t][1] = c[t][2] = c[t][3] = 0.f;
    for (int k = 0; k < Fp; k += 16) {
        unsigned a[4], b[4];
        ldmatrix_x4(a, a_addr + 2 * k);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            ldmatrix_x4(b, b_addr + 2 * (16 * p * ldb + k));
            mma_bf16(c[2 * p], a, b[0], b[1]);
            mma_bf16(c[2 * p + 1], a, b[2], b[3]);
        }
    }
}

// Sum over the 16 lanes that share a row (lane bits 0-3), in a fixed order;
// every lane of the group ends with the same bits.
__device__ __forceinline__ float row_group_sum(float v) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Start the copies of training tile j0 into one stage: F + kRec rows of
// kBJ floats, 16 chunks of 16 bytes each.
__device__ __forceinline__ void load_tile(float* ys, const float* __restrict__ cols, int ld,
                                          int F, int j0, int tid) {
    const int chunks = (F + kRec) * (kBJ / 4);
    for (int c = tid; c < chunks; c += kThreads) {
        const int k = c >> 4, part = c & 15;
        cp_async16(ys + k * kLdY + part * 4, cols + (size_t)k * ld + j0 + part * 4);
    }
}

// Running sums of R evaluation rows over their pairs: u, the operators
// (OPS), and the gradient's row sums (GRAD).
template <int R>
struct RowSums {
    float u[R], dt[R], div[R], lap[R];
    float sp[R], t[R], c[R], e[R], yt[R];
};

// The constants of the pair polynomials, from gamma and d.
struct Poly {
    float gs, gt, gr, df, G, beta, gs2, lap0, ll0, llq, lls, ngs, ngt, ngr;
};

// The bf16 variant's pairs of one training row of the tile with R
// evaluation rows: the row's records (r1, r3, r4, r5, |y|^2, spatial sum,
// time) at rec, kLdY apart, and yt_g, its unrounded time; each pair's x.y
// in xy and its evaluation row's stats; each pair's A_sp goes to As,
// as_step apart (GRAD only).  The same arithmetic as the float32 micro-tile
// in the kernel, which keeps its own copy so that the float32
// specialisations compile to the code they always had.
template <bool GRAD, bool OPS, int R>
__device__ __forceinline__ void column_pairs(const Poly& P, const float* rec, float yt_g,
                                             const float (&xy)[R], const float (&xn2)[R],
                                             const float (&xsum)[R], const float (&xt)[R],
                                             RowSums<R>& a, float* As, int as_step) {
    const float r1 = rec[0], r3 = rec[kLdY], r4 = rec[2 * kLdY];
    const float r5 = rec[3 * kLdY], yn2 = rec[4 * kLdY];
    const float ysum = rec[5 * kLdY], yt = rec[6 * kLdY];
    // The training row's factors, shared by its pairs: P_u's dt and s
    // coefficients, and the r3 terms of A_sp, B_s and P_div.
    const float c4 = P.gt * r4, c5 = P.G * r5;
    const float c3s = 2.0f * P.gs2 * r3, c3r = 2.0f * P.beta * r3;
    const float c3d = 2.0f * P.G * r3, c5d = P.df * c5, c5l = 2.0f * P.G * c5;
#pragma unroll
    for (int ii = 0; ii < R; ++ii) {
        const float r2 = fmaxf(fmaf(-2.0f, xy[ii], xn2[ii] + yn2), 0.0f);
        const float dt = xt[ii] - yt;
        const float sd = xsum[ii] - ysum;
        const float dt2 = dt * dt;
        const float s2 = sd * sd;
        const float q = fmaxf(r2 - dt2, 0.0f);
        const float kap = expf(fmaf(P.ngs, q, fmaf(P.ngr, s2, P.ngt * dt2)));
        const float lapf = fmaf(P.gs2, q, fmaf(P.beta, s2, -P.lap0));
        const float Pu = fmaf(lapf, r3, fmaf(dt, c4, fmaf(sd, c5, r1)));
        const float kPu = kap * Pu;
        a.u[ii] += kPu;
        if (GRAD) {
            const float Asp = fmaf(-P.gs, kPu, kap * c3s);
            const float Bs = fmaf(-P.gr, kPu, kap * c3r);
            a.sp[ii] += Asp;
            a.t[ii] += kPu;                      // times -gt after the loop
            a.yt[ii] = fmaf(kPu, yt_g, a.yt[ii]);  // times -gt after the loop
            a.c[ii] += fmaf(Bs, sd, kap * c5);
            a.e[ii] = fmaf(kap, c4, a.e[ii]);
            As[ii * as_step] = Asp;
        }
        if (OPS) {
            // The operators' polynomials written through P_u: the same
            // functions as the plain version's P_dt, P_div and P_lap, in
            // fewer operations.
            const float LLq = fmaf(-P.llq, q, fmaf(-P.lls, s2, P.ll0));  // LL - lapf^2
            a.dt[ii] = fmaf(kap, fmaf(-P.gt * dt, Pu, c4), a.dt[ii]);
            a.div[ii] = fmaf(kap, fmaf(P.G * sd, c3d - Pu, c5d), a.div[ii]);
            a.lap[ii] = fmaf(kap, fmaf(lapf, Pu, fmaf(LLq, r3, -sd * c5l)), a.lap[ii]);
        }
    }
}

// Blocks per SM the compiler must fit (registers <= 65536 / (256 * it)):
// two, except where the gradient's accumulators need more than 128
// registers without spilling (F > 129, or F > 65 with dt/div/lap too).
template <bool GRAD, bool OPS, int NC, bool BF16>
__global__ void __launch_bounds__(kThreads, (GRAD && (NC >= 16 || (NC >= 8 && OPS))) ? 1 : 2)
fused_posterior_kernel(const float* __restrict__ x, const float* __restrict__ cols,
                       int n, int ld, int F, int tiles,
                       float gs, float gt, float gr, float* __restrict__ out,
                       const __nv_bfloat16* __restrict__ rows_bf16) {
    extern __shared__ __align__(16) float smem[];
    // float32: the x tile, its stats, the stages, A_sp (GRAD only).  bf16:
    // the stats, the stages (the records, after the float32 feature rows
    // with GRAD), A_sp (GRAD only), the bf16 x tile and the bf16 y tiles
    // (one with GRAD, a double buffer without).
    float* xs = smem;                    // (F, kLdX) this block's x rows, feature-major
    float* xst = BF16 ? smem : xs + F * kLdX;  // (3, kBI) |x|^2, spatial sum, time
    float* stage0 = xst + 3 * kBI;       // kStages x (F + kRec, kLdY): y tile, then records
    const int sf = BF16 ? bf16_stage_floats(GRAD, F) : stage_floats(F);
    float* As = stage0 + kStages * sf;   // (kBI, kLdA) A_sp of the tile (GRAD only)
    const int Fp = padded_depth(F), ldb = Fp + kPadB;
    __nv_bfloat16* const xb =            // (kBI, ldb), then (kBJ, ldb) a y stage
        reinterpret_cast<__nv_bfloat16*>(As + (GRAD ? kBI * kLdA : 0));
    __nv_bfloat16* const yb = xb + kBI * ldb;
    // The bf16 stages hold the feature rows only where the gradient reads them.
    const float* const cols_staged = cols + (BF16 && !GRAD ? (size_t)F * ld : 0);
    const int F_staged = BF16 && !GRAD ? 0 : F;

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int i0 = blockIdx.x * kBI;
    const int S = gridDim.y, s = blockIdx.y;
    const int t_begin = (int)(((long long)s * tiles) / S);
    const int t_end = (int)(((long long)(s + 1) * tiles) / S);
    const int d = F - 1;

    if (t_begin < t_end) {
        load_tile(stage0, cols_staged, ld, F_staged, t_begin * kBJ, tid);
        if constexpr (BF16) load_tile_bf16(yb, rows_bf16, Fp, t_begin * kBJ, tid);
    }
    cp_async_commit();

    if constexpr (BF16) {
        // Prologue: the x tile rounded to bf16, row-major (rows past n and
        // columns past F are zero), then the stats of the rounded rows,
        // four threads a row, each a quarter of the columns.
        const int rows = min(kBI, n - i0), di = kThreads / Fp, dk = kThreads - di * Fp;
        int i = tid / Fp, k = tid - i * Fp;
#pragma unroll 4
        for (int idx = tid; idx < kBI * Fp; idx += kThreads) {
            xb[i * ldb + k] =
                __float2bfloat16_rn(i < rows && k < F ? x[(size_t)(i0 + i) * F + k] : 0.f);
            i += di;
            k += dk;
            if (k >= Fp) {
                k -= Fp;
                ++i;
            }
        }
        __syncthreads();
        const __nv_bfloat16* const xr = xb + (tid >> 2) * ldb;
        float n2 = 0.f, sp = 0.f;
        for (int j = tid & 3; j < d; j += 4) {
            const float v = __bfloat162float(xr[j]);
            n2 = fmaf(v, v, n2);
            sp += v;
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            n2 += __shfl_xor_sync(0xffffffffu, n2, off);
            sp += __shfl_xor_sync(0xffffffffu, sp, off);
        }
        if ((tid & 3) == 0) {
            const float tv = __bfloat162float(xr[d]);
            xst[tid >> 2] = fmaf(tv, tv, n2);
            xst[kBI + (tid >> 2)] = sp;
            xst[2 * kBI + (tid >> 2)] = tv;
        }
    } else {
        // Prologue: the x tile, transposed (rows past n are zero), then its stats.
        const int lim = min(kBI, n - i0) * F;
        const float* xg = x + (size_t)i0 * F;
        for (int idx = tid; idx < kBI * F; idx += kThreads) {
            const int i = idx / F, k = idx - i * F;
            xs[k * kLdX + i] = idx < lim ? xg[idx] : 0.f;
        }
        __syncthreads();
        if (tid < kBI) {
            float n2 = 0.f, sp = 0.f;
            for (int k = 0; k < d; ++k) {
                const float v = xs[k * kLdX + tid];
                n2 = fmaf(v, v, n2);
                sp += v;
            }
            const float tv = xs[d * kLdX + tid];
            xst[tid] = fmaf(tv, tv, n2);
            xst[kBI + tid] = sp;
            xst[2 * kBI + tid] = tv;
        }
    }
    __syncthreads();

    const float df = (float)d;
    const float G = gs + df * gr;
    const float beta = 2.0f * gs * gr + df * gr * gr;
    const float gs2 = gs * gs;
    const float lap0 = df * (gs + gr);
    const float ll0 = 2.0f * df * (gs2 + beta);
    const float llq = 4.0f * gs2 * gs;
    const float lls = 4.0f * (gs2 * gr + beta * G);
    const float ngs = -0.5f * gs, ngt = -0.5f * gt, ngr = -0.5f * gr;
    const Poly P{gs, gt, gr, df, G, beta, gs2, lap0, ll0, llq, lls, ngs, ngt, ngr};

    float a_u[4], a_dt[4], a_div[4], a_lap[4];
    float a_sp[4], a_t[4], a_c[4], a_e[4], a_yt[4];
    float ay[4][NC > 0 ? NC : 1];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
        a_u[ii] = a_dt[ii] = a_div[ii] = a_lap[ii] = 0.f;
        a_sp[ii] = a_t[ii] = a_c[ii] = a_e[ii] = a_yt[ii] = 0.f;
#pragma unroll
        for (int c = 0; c < (NC > 0 ? NC : 1); ++c) ay[ii][c] = 0.f;
    }
    // bf16: lane (g, q) = (lane / 4, lane % 4) of warp w holds the mma
    // fragments' pairs, rows row0 + g and row0 + g + 8 against columns
    // col0 + 8 nt + 2 q + {0, 1}, and sums those two rows in b.
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
    const int row0 = (warp & 3) * 16, col0 = (warp >> 2) * 32;
    RowSums<2> b;
    float bx_n2[2], bx_sum[2], bx_t[2];
    if constexpr (BF16) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            b.u[rr] = b.dt[rr] = b.div[rr] = b.lap[rr] = 0.f;
            b.sp[rr] = b.t[rr] = b.c[rr] = b.e[rr] = b.yt[rr] = 0.f;
            const int i = row0 + g + 8 * rr;
            bx_n2[rr] = xst[i];
            bx_sum[rr] = xst[kBI + i];
            bx_t[rr] = xst[2 * kBI + i];
        }
    }

    for (int t = t_begin; t < t_end; ++t) {
        const int buf = (t - t_begin) & 1;
        const float* ys = stage0 + buf * sf;
        const float* rec = ys + F_staged * kLdY + tx * 4;  // this thread's 4 records, row by row
        cp_async_wait_all();
        __syncthreads();  // tile t has landed; every thread is done with tile t - 1
        if (t + 1 < t_end)
            load_tile(stage0 + (buf ^ 1) * sf, cols_staged, ld, F_staged, (t + 1) * kBJ, tid);
        if constexpr (BF16 && !GRAD) {
            if (t + 1 < t_end)
                load_tile_bf16(yb + (buf ^ 1) * kBJ * ldb, rows_bf16, Fp, (t + 1) * kBJ, tid);
        }
        cp_async_commit();

        if constexpr (BF16) {
            float c[4][4];
            tile_dot_mma(xb, yb + (GRAD ? 0 : buf * kBJ * ldb), Fp, lane, row0, col0, c);
            const float* const yrec = ys + F_staged * kLdY;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
                for (int cc = 0; cc < 2; ++cc) {
                    const int col = col0 + 8 * nt + 2 * q + cc;
                    const float xy[2] = {c[nt][cc], c[nt][2 + cc]};
                    // A_t . y_t takes the unrounded time (the tile's row d)
                    column_pairs<GRAD, OPS, 2>(P, yrec + col, GRAD ? ys[d * kLdY + col] : 0.f,
                                               xy, bx_n2, bx_sum, bx_t, b,
                                               As + (row0 + g) * kLdA + col, 8 * kLdA);
                }
            }
        } else {
            float acc[4][4];
#pragma unroll
            for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
            for (int k = 0; k < F; ++k) {
                const float4 xv = *reinterpret_cast<const float4*>(xs + k * kLdX + ty * 4);
                const float4 yv = *reinterpret_cast<const float4*>(ys + k * kLdY + tx * 4);
                const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
                const float ya[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
                for (int ii = 0; ii < 4; ++ii)
#pragma unroll
                    for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(xa[ii], ya[jj], acc[ii][jj]);
            }

            const float4 xn2v = *reinterpret_cast<const float4*>(xst + ty * 4);
            const float4 xsumv = *reinterpret_cast<const float4*>(xst + kBI + ty * 4);
            const float4 xtv = *reinterpret_cast<const float4*>(xst + 2 * kBI + ty * 4);
            const float xn2a[4] = {xn2v.x, xn2v.y, xn2v.z, xn2v.w};
            const float xsuma[4] = {xsumv.x, xsumv.y, xsumv.z, xsumv.w};
            const float xta[4] = {xtv.x, xtv.y, xtv.z, xtv.w};
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
                const float r1 = rec[jj], r3 = rec[kLdY + jj], r4 = rec[2 * kLdY + jj];
                const float r5 = rec[3 * kLdY + jj], yn2 = rec[4 * kLdY + jj];
                const float ysum = rec[5 * kLdY + jj], yt = rec[6 * kLdY + jj];
                // The training row's factors, shared by its four pairs: P_u's
                // dt and s coefficients, and the r3 terms of A_sp, B_s and P_div.
                const float c4 = gt * r4, c5 = G * r5;
                const float c3s = 2.0f * gs2 * r3, c3r = 2.0f * beta * r3;
                const float c3d = 2.0f * G * r3, c5d = df * c5, c5l = 2.0f * G * c5;
#pragma unroll
                for (int ii = 0; ii < 4; ++ii) {
                    const float r2 = fmaxf(fmaf(-2.0f, acc[ii][jj], xn2a[ii] + yn2), 0.0f);
                    const float dt = xta[ii] - yt;
                    const float sd = xsuma[ii] - ysum;
                    const float dt2 = dt * dt;
                    const float s2 = sd * sd;
                    const float q = fmaxf(r2 - dt2, 0.0f);
                    const float kap = expf(fmaf(ngs, q, fmaf(ngr, s2, ngt * dt2)));
                    const float lapf = fmaf(gs2, q, fmaf(beta, s2, -lap0));
                    const float Pu = fmaf(lapf, r3, fmaf(dt, c4, fmaf(sd, c5, r1)));
                    const float kPu = kap * Pu;
                    a_u[ii] += kPu;
                    if (GRAD) {
                        const float Asp = fmaf(-gs, kPu, kap * c3s);
                        const float Bs = fmaf(-gr, kPu, kap * c3r);
                        a_sp[ii] += Asp;
                        a_t[ii] += kPu;                    // times -gt after the loop
                        a_yt[ii] = fmaf(kPu, yt, a_yt[ii]);  // times -gt after the loop
                        a_c[ii] += fmaf(Bs, sd, kap * c5);
                        a_e[ii] = fmaf(kap, c4, a_e[ii]);
                        As[(ty * 4 + ii) * kLdA + tx * 4 + jj] = Asp;
                    }
                    if (OPS) {
                        // The operators' polynomials written through P_u: the
                        // same functions as the plain version's P_dt, P_div and
                        // P_lap, in fewer operations.
                        const float LLq = fmaf(-llq, q, fmaf(-lls, s2, ll0));  // LL - lapf^2
                        a_dt[ii] = fmaf(kap, fmaf(-gt * dt, Pu, c4), a_dt[ii]);
                        a_div[ii] = fmaf(kap, fmaf(G * sd, c3d - Pu, c5d), a_div[ii]);
                        a_lap[ii] =
                            fmaf(kap, fmaf(lapf, Pu, fmaf(LLq, r3, -sd * c5l)), a_lap[ii]);
                    }
                }
            }
        }

        if (GRAD) {
            __syncthreads();  // the whole A_sp tile is written
            if constexpr (BF16) {
                // every warp is done with the y tile: start the next one's copy
                if (t + 1 < t_end) load_tile_bf16(yb, rows_bf16, Fp, (t + 1) * kBJ, tid);
                cp_async_commit();
            }
#pragma unroll(NC >= 4 ? 1 : 2)  // at NC = 4 an unroll of 2 spills
            for (int j = 0; j < kBJ; j += 4) {
                float4 a[4];
#pragma unroll
                for (int r = 0; r < 4; ++r)
                    a[r] = *reinterpret_cast<const float4*>(As + (ty * 4 + r) * kLdA + j);
#pragma unroll
                for (int c = 0; c < (NC > 0 ? NC : 1); ++c) {
                    const int k = tx + 16 * c;
                    if (k < d) {
                        const float4 yv = *reinterpret_cast<const float4*>(ys + k * kLdY + j);
#pragma unroll
                        for (int r = 0; r < 4; ++r) {
                            float v = ay[r][c];
                            v = fmaf(a[r].x, yv.x, v);
                            v = fmaf(a[r].y, yv.y, v);
                            v = fmaf(a[r].z, yv.z, v);
                            v = fmaf(a[r].w, yv.w, v);
                            ay[r][c] = v;
                        }
                    }
                }
            }
        }
    }

    if constexpr (BF16) {
        // Each row's sums: over its 4 lanes, then its two column halves
        // (warps w and w + 4) through shared memory, in a fixed order.
        constexpr int kSums = GRAD ? 9 : OPS ? 4 : 1;
        __syncthreads();  // every warp is done with the tiles
        float* const red = stage0;  // (kSums, 2, kBI)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            const float v[9] = {b.u[rr], b.dt[rr], b.div[rr], b.lap[rr], b.sp[rr],
                                b.t[rr], b.c[rr], b.e[rr], b.yt[rr]};
#pragma unroll
            for (int k = 0; k < kSums; ++k) {
                if (!OPS && k >= 1 && k < 4) continue;
                float sum = v[k];
                sum += __shfl_xor_sync(0xffffffffu, sum, 1);
                sum += __shfl_xor_sync(0xffffffffu, sum, 2);
                if (q == 0) red[(2 * k + (warp >> 2)) * kBI + row0 + g + 8 * rr] = sum;
            }
        }
        __syncthreads();
        const auto total = [&](int k, int i) { return red[2 * k * kBI + i] + red[(2 * k + 1) * kBI + i]; };
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
            const int i = ty * 4 + ii;
            a_u[ii] = total(0, i);
            if (OPS) {
                a_dt[ii] = total(1, i);
                a_div[ii] = total(2, i);
                a_lap[ii] = total(3, i);
            }
            if (GRAD) {
                a_sp[ii] = total(4, i);
                a_t[ii] = -gt * total(5, i);
                a_c[ii] = total(6, i);
                a_e[ii] = total(7, i);
                a_yt[ii] = -gt * total(8, i);
            }
        }
    } else {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
            a_u[ii] = row_group_sum(a_u[ii]);
            if (OPS) {
                a_dt[ii] = row_group_sum(a_dt[ii]);
                a_div[ii] = row_group_sum(a_div[ii]);
                a_lap[ii] = row_group_sum(a_lap[ii]);
            }
            if (GRAD) {
                a_sp[ii] = row_group_sum(a_sp[ii]);
                a_t[ii] = -gt * row_group_sum(a_t[ii]);
                a_c[ii] = row_group_sum(a_c[ii]);
                a_e[ii] = row_group_sum(a_e[ii]);
                a_yt[ii] = -gt * row_group_sum(a_yt[ii]);
            }
        }
    }

    // Every output is linear in the row sums, so a split writes its share
    // of u, grad and the operators (the gradient with x . a_sp and a_c of
    // its own sums) and the splits add up to PosteriorOut.
    float* const o = out + (size_t)s * out_floats(GRAD, OPS, n, F);
    float* const grad_out = o + n;
    float* const ops_out = o + n + (GRAD ? (size_t)n * F : 0);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
        const int i = ty * 4 + ii;
        const int row = i0 + i;
        if (row >= n) continue;
        // x of the gradient's x * rowsum terms: unrounded, so from global
        // memory where the tile holds rounded values
        const float* const xrow = x + (size_t)row * F;
        if (tx == 0) {
            o[row] = a_u[ii];
            if (OPS) {
                ops_out[row] = a_dt[ii];
                ops_out[n + row] = a_div[ii];
                ops_out[2 * n + row] = a_lap[ii];
            }
            if (GRAD)
                grad_out[(size_t)row * F + d] =
                    (BF16 ? xrow[d] : xs[d * kLdX + i]) * a_t[ii] - a_yt[ii] + a_e[ii];
        }
        if (GRAD) {
#pragma unroll
            for (int c = 0; c < (NC > 0 ? NC : 1); ++c) {
                const int k = tx + 16 * c;
                if (k < d)
                    grad_out[(size_t)row * F + k] =
                        (BF16 ? xrow[k] : xs[k * kLdX + i]) * a_sp[ii] - ay[ii][c] + a_c[ii];
            }
        }
    }
}

// out[i] = the sum of the S splits' slices of scratch at i, in split order.
__global__ void __launch_bounds__(256)
fused_posterior_reduce(const float* __restrict__ scratch, long long total, int S,
                       float* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    float v = scratch[i];
    for (int s = 1; s < S; ++s) v += scratch[s * total + i];
    out[i] = v;
}

// Columns of A_sp . Y_sp a thread owns, rounded up to a power of two.
int column_chunks(int F) {
    const int nc = (F - 1 + 15) / 16;
    return nc <= 2 ? 2 : nc <= 4 ? 4 : nc <= 8 ? 8 : 16;
}

constexpr int kMaxDevices = 64;

template <bool GRAD, bool OPS, int NC, bool BF16>
cudaError_t prepare(size_t smem) {
    // Raise the dynamic shared-memory cap of this specialisation on the
    // current device, once per size the process uses there (the attribute
    // is per device).
    static size_t granted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || smem <= 48 * 1024) return e;
    if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(fused_posterior_kernel<GRAD, OPS, NC, BF16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
    return e;
}

struct Call {
    const float *x, *cols;
    const __nv_bfloat16* rows_bf16;
    int n, ld, F, splits;
    float gs, gt, gr;
    float *scratch, *out;
    cudaStream_t stream;
};

template <bool GRAD, bool OPS, int NC, bool BF16>
cudaError_t launch(const Call& c) {
    const size_t smem = smem_bytes(GRAD, c.F, BF16);
    cudaError_t e = prepare<GRAD, OPS, NC, BF16>(smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((c.n + kBI - 1) / kBI), (unsigned)c.splits);
    fused_posterior_kernel<GRAD, OPS, NC, BF16><<<grid, kThreads, smem, c.stream>>>(
        c.x, c.cols, c.n, c.ld, c.F, c.ld / kBJ, c.gs, c.gt, c.gr,
        c.splits > 1 ? c.scratch : c.out, c.rows_bf16);
    e = cudaGetLastError();
    if (e != cudaSuccess || c.splits == 1) return e;
    const long long total = (long long)out_floats(GRAD, OPS, c.n, c.F);
    fused_posterior_reduce<<<(unsigned)((total + 255) / 256), 256, 0, c.stream>>>(
        c.scratch, total, c.splits, c.out);
    return cudaGetLastError();
}

template <bool GRAD, bool OPS, int NC, bool BF16>
cudaError_t occupancy(int F, int* blocks) {
    const size_t smem = smem_bytes(GRAD, F, BF16);
    const cudaError_t e = prepare<GRAD, OPS, NC, BF16>(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_posterior_kernel<GRAD, OPS, NC, BF16>, kThreads, smem);
}

// The one dispatch from runtime flags and F to a specialisation.
template <template <bool, bool, int, bool> class Op, bool BF16, typename... Args>
cudaError_t dispatch_flags(bool grad, bool ops, int F, Args&&... args) {
    if (!grad) {
        return ops ? Op<false, true, 0, BF16>::run(args...)
                   : Op<false, false, 0, BF16>::run(args...);
    }
    switch (column_chunks(F)) {
        case 2: return ops ? Op<true, true, 2, BF16>::run(args...)
                           : Op<true, false, 2, BF16>::run(args...);
        case 4: return ops ? Op<true, true, 4, BF16>::run(args...)
                           : Op<true, false, 4, BF16>::run(args...);
        case 8: return ops ? Op<true, true, 8, BF16>::run(args...)
                           : Op<true, false, 8, BF16>::run(args...);
        default: return ops ? Op<true, true, 16, BF16>::run(args...)
                            : Op<true, false, 16, BF16>::run(args...);
    }
}

template <template <bool, bool, int, bool> class Op, typename... Args>
cudaError_t dispatch(bool grad, bool ops, bool bf16, int F, Args&&... args) {
    return bf16 ? dispatch_flags<Op, true>(grad, ops, F, args...)
                : dispatch_flags<Op, false>(grad, ops, F, args...);
}

template <bool GRAD, bool OPS, int NC, bool BF16>
struct LaunchOp {
    static cudaError_t run(const Call& c) { return launch<GRAD, OPS, NC, BF16>(c); }
};

template <bool GRAD, bool OPS, int NC, bool BF16>
struct OccupancyOp {
    static cudaError_t run(int F, int* blocks) {
        return occupancy<GRAD, OPS, NC, BF16>(F, blocks);
    }
};

}  // namespace

extern "C" {

const char* scasml_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Blocks of the specialisation for (want_grad, want_ops, bf16, F) that fit
// on one SM of the current device at once; returns a cudaError_t.
int scasml_fused_posterior_occupancy(int want_grad, int want_ops, int bf16, int F,
                                     int* blocks) {
    if (F < 2 || F > kMaxFeatures || blocks == nullptr) return (int)cudaErrorInvalidValue;
    return (int)dispatch<OccupancyOp>(want_grad != 0, want_ops != 0, bf16 != 0, F, F, blocks);
}

// Launches on `stream` of card `device` and returns cudaGetLastError() of the
// launches.  bf16 selects the bf16-operand variant, which also reads
// rows_bf16 (ld, F padded to a multiple of 16; prepare_inputs), null
// otherwise.  ld is the padded training-row count (a multiple of 64) and
// splits plan()'s S.  out receives [u (n) | grad (n, F) if want_grad | dt,
// div, lap (n each) if want_ops]; scratch holds S such slices and may be
// null when S = 1.
int scasml_fused_posterior(int device, int want_grad, int want_ops, int bf16, const float* x,
                           const float* cols, const void* rows_bf16, int n, int ld, int F,
                           float gs, float gt, float gr, int splits, float* scratch,
                           float* out, void* stream) {
    const int tiles = ld / kBJ;
    if (F < 2 || F > kMaxFeatures || n < 0 || ld < kBJ || ld % kBJ != 0 || splits < 1 ||
        splits > tiles || (splits > 1 && scratch == nullptr) || out == nullptr ||
        (bf16 != 0 && rows_bf16 == nullptr))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int prev = 0;
    cudaError_t e = cudaGetDevice(&prev);
    if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const Call c{x, cols, static_cast<const __nv_bfloat16*>(rows_bf16), n, ld, F, splits,
                 gs, gt, gr, scratch, out, (cudaStream_t)stream};
    e = dispatch<LaunchOp>(want_grad != 0, want_ops != 0, bf16 != 0, F, c);
    if (prev != device) cudaSetDevice(prev);
    return (int)e;
}

}  // extern "C"
