// Fused GP posterior (mean, gradient, dt/div/Laplacian) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel scripts/pallas_posterior.py: the tile body
// `_kernel`, its grid `dom_posterior_tiles`, and the boundary-set and
// gradient assembly `_posterior_block_fused` that ran around it.  One launch
// computes PosteriorOut for n evaluation rows against every training row.
//
// Inputs, prepared once per trained state (gp/fused_posterior.py):
//   y  (m, F)  the interior rows followed by the boundary rows, F = d + 1,
//              time in the last column;
//   r  (m, 4)  representer weights [r1, r3, r4, r5] for an interior row and
//              [r2, 0, 0, 0] for a boundary row.  A boundary row contributes
//              exactly what an interior row with those weights contributes,
//              so the boundary set needs no second pass.
//
// Layout: one warp per evaluation row, kWarps rows per block.  The block
// walks the training rows in tiles staged in shared memory (this loop takes
// the place of the TPU grid's sequential j axis and its pl.when(j == 0)
// initialisation).  Lanes stride over the rows of a tile and keep the eight
// row sums in registers.  With WANT_GRAD they also store each row's A_sp and
// A_t coefficient in shared memory, then stride over feature columns to
// accumulate A_sp . Y_sp and A_t . y_t (ceil(F / 32) registers a lane).
// A fixed-order __shfl_xor_sync butterfly finishes each row, so no block
// shares a partial sum, there are no atomics, and every run gives the same
// bits.  The epilogue writes u, grad, dt_u, div_u and lap_u directly.
//
// Pair statistics: q and s come from the differences x - y (not from
// |x|^2 + |y|^2 - 2 x.y as in the JAX package), which needs no clamp and is
// at least as accurate; all arithmetic is IEEE float32.
//
// What bounds it on the H100: about 60 flops and one exp per (x, y) pair
// (up to 4800 x 1200 pairs a call on the main path), plus 2 (d + 1) more per
// pair for the gradient contraction.  The product x.y has depth d + 1 = 21,
// too shallow for tensor cores, so it runs as FFMA on the CUDA cores: the
// kernel is FFMA/SFU bound and its inputs (m * (F + 4) floats) stay in L2.
// The design keeps every intermediate in registers or shared memory and
// reads each training tile from L2 once per block.  Known limit: with 4 rows
// per block, a 1200-row call fills 300 blocks, so the card is under-occupied
// at the main path's sizes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxColChunks = 8;
constexpr int kMaxFeatures = 32 * kMaxColChunks;  // F = d + 1 <= 256
constexpr size_t kSmemBudget = 48 * 1024;         // no opt-in attribute needed

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// Odd row stride: lanes reading the same column of different rows hit
// different shared-memory banks.
__host__ __device__ __forceinline__ int row_stride(int F) { return F | 1; }

__host__ __device__ __forceinline__ size_t smem_floats(int F, int tj, bool grad) {
    const int st = row_stride(F);
    return (size_t)tj * st + (size_t)tj * 4 + (size_t)kWarps * st +
           (grad ? (size_t)kWarps * tj * 2 : 0);
}

template <bool WANT_GRAD, bool WANT_OPS>
__global__ void __launch_bounds__(kThreads)
fused_posterior_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ r, int n, int m, int F, int tj,
                       float gs, float gt, float gr,
                       float* __restrict__ u_out, float* __restrict__ grad_out,
                       float* __restrict__ dt_out, float* __restrict__ div_out,
                       float* __restrict__ lap_out) {
    extern __shared__ float smem[];
    const int st = row_stride(F);
    float* ys = smem;                 // (tj, st) training tile
    float* rs = ys + tj * st;         // (tj, 4) weights of the tile
    float* xs = rs + tj * 4;          // (kWarps, st) this block's eval rows
    float* cs = xs + kWarps * st;     // (kWarps, 2, tj) A_sp, A_t of the tile

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarps + warp;
    const bool active = row < n;
    const int d = F - 1;
    const float df = (float)d;

    const float G = gs + df * gr;
    const float beta = 2.0f * gs * gr + df * gr * gr;
    const float lap0 = df * (gs + gr);
    const float ll0 = 2.0f * df * (gs * gs + beta);
    const float llq = 4.0f * gs * gs * gs;
    const float lls = 4.0f * (gs * gs * gr + beta * G);

    float* xw = xs + warp * st;
    float* cw = cs + warp * 2 * tj;
    if (active) {
        for (int k = lane; k < F; k += 32) xw[k] = x[(size_t)row * F + k];
    }

    float a_u = 0.f, a_dt = 0.f, a_div = 0.f, a_lap = 0.f;
    float a_sp = 0.f, a_t = 0.f, a_c = 0.f, a_e = 0.f;
    float a_y[kMaxColChunks];
#pragma unroll
    for (int c = 0; c < kMaxColChunks; ++c) a_y[c] = 0.f;

    for (int j0 = 0; j0 < m; j0 += tj) {
        const int rows = min(tj, m - j0);
        __syncthreads();  // the previous tile is consumed by every warp
        const float* yg = y + (size_t)j0 * F;
        for (int idx = threadIdx.x; idx < rows * F; idx += kThreads) {
            const int jr = idx / F;
            ys[jr * st + (idx - jr * F)] = yg[idx];
        }
        const float* rg = r + (size_t)j0 * 4;
        for (int idx = threadIdx.x; idx < rows * 4; idx += kThreads) rs[idx] = rg[idx];
        __syncthreads();
        if (!active) continue;

        for (int jj = lane; jj < rows; jj += 32) {
            const float* yr = ys + jj * st;
            float q = 0.f, s = 0.f;
            for (int k = 0; k < d; ++k) {
                const float df_k = xw[k] - yr[k];
                q = fmaf(df_k, df_k, q);
                s += df_k;
            }
            const float dt = xw[d] - yr[d];
            const float r1 = rs[jj * 4 + 0], r3 = rs[jj * 4 + 1];
            const float r4 = rs[jj * 4 + 2], r5 = rs[jj * 4 + 3];
            const float s2 = s * s;
            const float dt2 = dt * dt;
            const float kap = expf(-0.5f * (gs * q + gr * s2 + gt * dt2));
            const float lapf = gs * gs * q + beta * s2 - lap0;
            const float Pu = r1 + lapf * r3 + gt * dt * r4 + G * s * r5;
            const float kPu = kap * Pu;
            a_u += kPu;
            if (WANT_GRAD) {
                const float Asp = -gs * kPu + 2.0f * gs * gs * kap * r3;
                const float Bs = -gr * kPu + 2.0f * beta * kap * r3;
                const float At = -gt * kPu;
                a_sp += Asp;
                a_t += At;
                a_c += G * kap * r5 + Bs * s;
                a_e += gt * kap * r4;
                cw[jj] = Asp;
                cw[tj + jj] = At;
            }
            if (WANT_OPS) {
                const float gdt = gt * dt;
                const float Gs = G * s;
                const float Pdt = -gdt * r1 - gdt * lapf * r3 +
                                  gt * (1.0f - gt * dt2) * r4 - Gs * gdt * r5;
                const float Pdiv = -Gs * r1 + Gs * (2.0f * G - lapf) * r3 -
                                   Gs * gdt * r4 + G * (df - G * s2) * r5;
                const float LL = ll0 - llq * q - lls * s2 + lapf * lapf;
                const float Plap = lapf * r1 + LL * r3 + gdt * lapf * r4 -
                                   Gs * (2.0f * G - lapf) * r5;
                a_dt += kap * Pdt;
                a_div += kap * Pdiv;
                a_lap += kap * Plap;
            }
        }
        if (WANT_GRAD) {
            __syncwarp();
#pragma unroll
            for (int c = 0; c < kMaxColChunks; ++c) {
                const int k = c * 32 + lane;
                if (k < F) {
                    const float* coef = k < d ? cw : cw + tj;
                    float acc = 0.f;
                    for (int jj = 0; jj < rows; ++jj) acc = fmaf(coef[jj], ys[jj * st + k], acc);
                    a_y[c] += acc;
                }
            }
        }
    }
    if (!active) return;

    a_u = warp_sum(a_u);
    if (WANT_OPS) {
        a_dt = warp_sum(a_dt);
        a_div = warp_sum(a_div);
        a_lap = warp_sum(a_lap);
    }
    if (lane == 0) {
        u_out[row] = a_u;
        if (WANT_OPS) {
            dt_out[row] = a_dt;
            div_out[row] = a_div;
            lap_out[row] = a_lap;
        }
    }
    if (WANT_GRAD) {
        a_sp = warp_sum(a_sp);
        a_t = warp_sum(a_t);
        a_c = warp_sum(a_c);
        a_e = warp_sum(a_e);
        float* g = grad_out + (size_t)row * F;
#pragma unroll
        for (int c = 0; c < kMaxColChunks; ++c) {
            const int k = c * 32 + lane;
            if (k < d) {
                g[k] = xw[k] * a_sp - a_y[c] + a_c;        // spatial
            } else if (k == d) {
                g[k] = xw[k] * a_t - a_y[c] + a_e;         // time
            }
        }
    }
}

template <bool WANT_GRAD, bool WANT_OPS>
cudaError_t launch(const float* x, const float* y, const float* r, int n, int m,
                   int F, int tj, float gs, float gt, float gr, float* u,
                   float* grad, float* dt_u, float* div_u, float* lap_u,
                   cudaStream_t stream) {
    const size_t smem = smem_floats(F, tj, WANT_GRAD) * sizeof(float);
    const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
    fused_posterior_kernel<WANT_GRAD, WANT_OPS><<<blocks, kThreads, smem, stream>>>(
        x, y, r, n, m, F, tj, gs, gt, gr, u, grad, dt_u, div_u, lap_u);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

int scasml_fused_posterior_max_features() { return kMaxFeatures; }

const char* scasml_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() of the launch.
// grad may be null unless want_grad; dt_u, div_u, lap_u unless want_ops.
int scasml_fused_posterior(int want_grad, int want_ops, const float* x,
                           const float* y, const float* r, int n, int m, int F,
                           float gs, float gt, float gr, float* u, float* grad,
                           float* dt_u, float* div_u, float* lap_u, void* stream) {
    if (F < 2 || F > kMaxFeatures || n < 0 || m < 1) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    int tj = 128;
    while (tj > 32 && smem_floats(F, tj, want_grad != 0) * sizeof(float) > kSmemBudget) tj /= 2;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err;
    if (want_grad && want_ops) {
        err = launch<true, true>(x, y, r, n, m, F, tj, gs, gt, gr, u, grad, dt_u, div_u, lap_u, s);
    } else if (want_grad) {
        err = launch<true, false>(x, y, r, n, m, F, tj, gs, gt, gr, u, grad, dt_u, div_u, lap_u, s);
    } else if (want_ops) {
        err = launch<false, true>(x, y, r, n, m, F, tj, gs, gt, gr, u, grad, dt_u, div_u, lap_u, s);
    } else {
        err = launch<false, false>(x, y, r, n, m, F, tj, gs, gt, gr, u, grad, dt_u, div_u, lap_u, s);
    }
    return (int)err;
}

}  // extern "C"
