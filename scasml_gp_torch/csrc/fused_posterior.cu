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

// Floats of one call's outputs, laid out [u (n) | grad (n, F) | dt, div,
// lap (n each)]: the PosteriorOut buffer, and one split's slice of scratch.
__host__ __device__ __forceinline__ size_t out_floats(bool grad, bool ops, int n, int F) {
    return (size_t)n * (1 + (grad ? F : 0) + (ops ? 3 : 0));
}

__host__ __device__ __forceinline__ int stage_floats(int F) {
    return (F + kRec) * kLdY;
}

__host__ __device__ __forceinline__ size_t smem_bytes(bool grad, int F) {
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

// Blocks per SM the compiler must fit (registers <= 65536 / (256 * it)):
// two, except where the gradient's accumulators need more than 128
// registers without spilling (F > 129, or F > 65 with dt/div/lap too).
template <bool GRAD, bool OPS, int NC>
__global__ void __launch_bounds__(kThreads, (GRAD && (NC >= 16 || (NC >= 8 && OPS))) ? 1 : 2)
fused_posterior_kernel(const float* __restrict__ x, const float* __restrict__ cols,
                       int n, int ld, int F, int tiles,
                       float gs, float gt, float gr, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    float* xs = smem;                    // (F, kLdX) this block's x rows, feature-major
    float* xst = xs + F * kLdX;          // (3, kBI) |x|^2, spatial sum, time
    float* stage0 = xst + 3 * kBI;       // kStages x (F + kRec, kLdY): y tile, then records
    const int sf = stage_floats(F);
    float* As = stage0 + kStages * sf;   // (kBI, kLdA) A_sp of the tile (GRAD only)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int i0 = blockIdx.x * kBI;
    const int S = gridDim.y, s = blockIdx.y;
    const int t_begin = (int)(((long long)s * tiles) / S);
    const int t_end = (int)(((long long)(s + 1) * tiles) / S);
    const int d = F - 1;

    if (t_begin < t_end) load_tile(stage0, cols, ld, F, t_begin * kBJ, tid);
    cp_async_commit();

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

    for (int t = t_begin; t < t_end; ++t) {
        const int buf = (t - t_begin) & 1;
        const float* ys = stage0 + buf * sf;
        const float* rec = ys + F * kLdY + tx * 4;  // this thread's 4 records, row by row
        cp_async_wait_all();
        __syncthreads();  // tile t has landed; every thread is done with tile t - 1
        if (t + 1 < t_end) load_tile(stage0 + (buf ^ 1) * sf, cols, ld, F, (t + 1) * kBJ, tid);
        cp_async_commit();

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
                    a_t[ii] += kPu;                      // times -gt after the loop
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
                    a_lap[ii] = fmaf(kap, fmaf(lapf, Pu, fmaf(LLq, r3, -sd * c5l)), a_lap[ii]);
                }
            }
        }

        if (GRAD) {
            __syncthreads();  // the whole A_sp tile is written
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
        if (tx == 0) {
            o[row] = a_u[ii];
            if (OPS) {
                ops_out[row] = a_dt[ii];
                ops_out[n + row] = a_div[ii];
                ops_out[2 * n + row] = a_lap[ii];
            }
            if (GRAD)
                grad_out[(size_t)row * F + d] = xs[d * kLdX + i] * a_t[ii] - a_yt[ii] + a_e[ii];
        }
        if (GRAD) {
#pragma unroll
            for (int c = 0; c < (NC > 0 ? NC : 1); ++c) {
                const int k = tx + 16 * c;
                if (k < d)
                    grad_out[(size_t)row * F + k] = xs[k * kLdX + i] * a_sp[ii] - ay[ii][c] + a_c[ii];
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

template <bool GRAD, bool OPS, int NC>
cudaError_t prepare(size_t smem) {
    // Raise the dynamic shared-memory cap of this specialisation on the
    // current device, once per size the process uses there (the attribute
    // is per device).
    static size_t granted[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || smem <= 48 * 1024) return e;
    if (dev < kMaxDevices && smem <= granted[dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(fused_posterior_kernel<GRAD, OPS, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess && dev < kMaxDevices) granted[dev] = smem;
    return e;
}

struct Call {
    const float *x, *cols;
    int n, ld, F, splits;
    float gs, gt, gr;
    float *scratch, *out;
    cudaStream_t stream;
};

template <bool GRAD, bool OPS, int NC>
cudaError_t launch(const Call& c) {
    const size_t smem = smem_bytes(GRAD, c.F);
    cudaError_t e = prepare<GRAD, OPS, NC>(smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((unsigned)((c.n + kBI - 1) / kBI), (unsigned)c.splits);
    fused_posterior_kernel<GRAD, OPS, NC><<<grid, kThreads, smem, c.stream>>>(
        c.x, c.cols, c.n, c.ld, c.F, c.ld / kBJ, c.gs, c.gt, c.gr,
        c.splits > 1 ? c.scratch : c.out);
    e = cudaGetLastError();
    if (e != cudaSuccess || c.splits == 1) return e;
    const long long total = (long long)out_floats(GRAD, OPS, c.n, c.F);
    fused_posterior_reduce<<<(unsigned)((total + 255) / 256), 256, 0, c.stream>>>(
        c.scratch, total, c.splits, c.out);
    return cudaGetLastError();
}

template <bool GRAD, bool OPS, int NC>
cudaError_t occupancy(int F, int* blocks) {
    const size_t smem = smem_bytes(GRAD, F);
    const cudaError_t e = prepare<GRAD, OPS, NC>(smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, fused_posterior_kernel<GRAD, OPS, NC>, kThreads, smem);
}

// The one dispatch from runtime flags and F to a specialisation.
template <template <bool, bool, int> class Op, typename... Args>
cudaError_t dispatch(bool grad, bool ops, int F, Args&&... args) {
    if (!grad) {
        return ops ? Op<false, true, 0>::run(args...) : Op<false, false, 0>::run(args...);
    }
    switch (column_chunks(F)) {
        case 2: return ops ? Op<true, true, 2>::run(args...) : Op<true, false, 2>::run(args...);
        case 4: return ops ? Op<true, true, 4>::run(args...) : Op<true, false, 4>::run(args...);
        case 8: return ops ? Op<true, true, 8>::run(args...) : Op<true, false, 8>::run(args...);
        default: return ops ? Op<true, true, 16>::run(args...) : Op<true, false, 16>::run(args...);
    }
}

template <bool GRAD, bool OPS, int NC>
struct LaunchOp {
    static cudaError_t run(const Call& c) { return launch<GRAD, OPS, NC>(c); }
};

template <bool GRAD, bool OPS, int NC>
struct OccupancyOp {
    static cudaError_t run(int F, int* blocks) { return occupancy<GRAD, OPS, NC>(F, blocks); }
};

}  // namespace

extern "C" {

const char* scasml_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Blocks of the specialisation for (want_grad, want_ops, F) that fit on one
// SM of the current device at once; returns a cudaError_t.
int scasml_fused_posterior_occupancy(int want_grad, int want_ops, int F, int* blocks) {
    if (F < 2 || F > kMaxFeatures || blocks == nullptr) return (int)cudaErrorInvalidValue;
    return (int)dispatch<OccupancyOp>(want_grad != 0, want_ops != 0, F, F, blocks);
}

// Launches on `stream` of card `device` and returns cudaGetLastError() of the
// launches.  ld is the padded training-row count (a multiple of 64) and
// splits plan()'s S.  out receives [u (n) | grad (n, F) if want_grad | dt,
// div, lap (n each) if want_ops]; scratch holds S such slices and may be
// null when S = 1.
int scasml_fused_posterior(int device, int want_grad, int want_ops, const float* x,
                           const float* cols, int n, int ld, int F, float gs, float gt,
                           float gr, int splits, float* scratch, float* out, void* stream) {
    const int tiles = ld / kBJ;
    if (F < 2 || F > kMaxFeatures || n < 0 || ld < kBJ || ld % kBJ != 0 || splits < 1 ||
        splits > tiles || (splits > 1 && scratch == nullptr) || out == nullptr)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int prev = 0;
    cudaError_t e = cudaGetDevice(&prev);
    if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    const Call c{x, cols, n, ld, F, splits, gs, gt, gr, scratch, out, (cudaStream_t)stream};
    e = dispatch<LaunchOp>(want_grad != 0, want_ops != 0, F, c);
    if (prev != device) cudaSetDevice(prev);
    return (int)e;
}

}  // extern "C"
