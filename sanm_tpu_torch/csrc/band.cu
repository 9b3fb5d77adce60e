// K5: the skyline band Cholesky, the sparse direct solve on the card.
//
// Replaces sanm_tpu/solver/band.py: assemble_band_scaled_neg (:225) as
// sanm_band_assemble, band_cholesky (:247) as sanm_band_factor, and
// band_tri_solve + band_tri_solve_fn (:321-385) as sanm_band_solve.  The
// JAX package runs them in f32 on the TPU's matrix unit, one lax.scan per
// run of equal-width block columns; here everything is f64 and every
// block column runs at its own skyline reach w_j (host arrays blk_w and
// panel_off of sanm_tpu_torch/solver/band.py BandPlan).
//
// Layouts (see solver/band.py): the working band holds block-row windows
// of width W = (w+1)s, band[i*s + r, c] = A[i*s + r, (i-w)*s + c], with
// only the lower triangle of a diagonal block valid.  Panel j of the
// factor (at panels + panel_off[j], row-major, s columns) stacks
// inv(L[j,j]) over the w_j subdiagonal blocks T[m] = L[j+1+m, j].
//
// Bounds on the H100 at armadillo-small (n = 38,046, s = 128):
// * assembly: writes the ~2.5 GB working band (a memset) and scatters
//   ~0.65 M values: memory bound, ~0.75 ms at 3.35 TB/s;
// * factor: 4.0e11 f64 operations, almost all in the trailing updates:
//   bound by the f64 tensor-core rate (67 TFLOP/s), ~6.0 ms;
// * solve: reads the 0.86 GB of panels twice: memory bound, ~0.5 ms.
//
// Design.  The factor is a host loop over the block columns, three
// launches per column on one stream (the diagonal step and the product
// tile are shared with K6 and K7, chol_blocks.h):
// 1. diag_factor_kernel, one CTA: the s x s diagonal block in shared
//    memory, a right-looking Cholesky and then the triangular inverse,
//    one barrier per column each (step k updates with column k, or row k
//    of the inverse, divided by its pivot on the fly while column k-1, or
//    row k-1, is scaled, so the two touch disjoint entries).  Its time is
//    instruction issue and barriers on one SM, ~0.25 ms at s = 128; a
//    4 x 4 register tile a thread measured twice as slow.  A negative
//    pivot gives sqrt < 0 = NaN, which propagates through the inverse, the
//    panels and every later update: never a clamp.
// 2. panel_kernel: T = P inv^T over the w_j stacked blocks.
// 3. trailing_kernel: block (j+1+m, j+1+p) -= T[m] T[p]^T for p <= m,
//    skipping the upper half of the diagonal blocks (junk).
// Both products run 64 x 64 output tiles per CTA through f64 mma.sync
// (m8n8k4) from shared memory; every output element is written by one
// thread, with no atomics, so the factor repeats its bits from run to run.
// The solve is a host loop too: per block column a one-CTA diagonal step
// and a many-CTA panel step forward, the same backward with the panel's
// column sums split into fixed row groups and summed in order by the
// diagonal step.  Latency, not bandwidth, sets the time of a solve: ~1,190
// small kernels, each a chain of dependent global round trips.  (Fusing the
// two steps of a column, the diagonal recomputed in every CTA and the
// backward groups finished by the last CTA, measured slower on the H100.)
#include <cuda_runtime.h>

#include "chol_blocks.h"
#include "sanm_kernels.h"

namespace {

// ---------------------------------------------------------------------------
// K5a band_assemble
// ---------------------------------------------------------------------------

__global__ void band_scale_kernel(const double* __restrict__ data,
                                  const int32_t* __restrict__ diag_of_row,
                                  double* __restrict__ scale, int64_t n) {
    int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (r >= n) return;
    int32_t p = diag_of_row[r];
    double d = p >= 0 ? fabs(data[p]) : 0.0;
    scale[r] = d > 0.0 ? 1.0 / sqrt(d) : 1.0;
}

__global__ void band_scatter_kernel(const double* __restrict__ data,
                                    const double* __restrict__ scale,
                                    const int32_t* __restrict__ sel,
                                    const int32_t* __restrict__ rows,
                                    const int32_t* __restrict__ cols,
                                    const int64_t* __restrict__ band_idx,
                                    double* __restrict__ band,
                                    int64_t nlow) {
    int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (e >= nlow) return;
    band[band_idx[e]] = -(data[sel[e]] * scale[rows[e]] * scale[cols[e]]);
}

__global__ void band_pad_kernel(const int64_t* __restrict__ pad_idx,
                                double* __restrict__ band, int64_t npad) {
    int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (e < npad) band[pad_idx[e]] = 1.0;
}

// ---------------------------------------------------------------------------
// K5b band_factor
// ---------------------------------------------------------------------------

// T[m] = P[m] inv^T for the w_j stacked subdiagonal blocks of column j;
// P[m] = block (j+1+m, j) at window offset (w-1-m)s.  Grid: (w_j s / 64,
// s / 64) tiles.
__global__ void __launch_bounds__(kGemmThreads)
panel_kernel(const double* __restrict__ band, int64_t W, int64_t w,
             int64_t j, double* __restrict__ panel) {
    constexpr int s = kBlock;
    const int64_t row = (int64_t)blockIdx.x * kTile;
    const int64_t m = row / s, r0 = row - m * s;
    gemm_nt_tile<false>(
        band + ((j + 1 + m) * s + r0) * W + (w - 1 - m) * s, W,
        panel + (int64_t)blockIdx.y * kTile * s, s,
        panel + (s + row) * s + (int64_t)blockIdx.y * kTile, s, s);
}

// Block (j+1+m, j+1+p) -= T[m] T[p]^T, p <= m, at window offset
// (w-m+p)s of block row j+1+m.  Grid: (w_j (w_j+1) / 2 pairs, (s/64)^2
// tiles).
__global__ void __launch_bounds__(kGemmThreads)
trailing_kernel(double* __restrict__ band, int64_t W, int64_t w, int64_t j,
                const double* __restrict__ panel) {
    constexpr int s = kBlock;
    const int64_t q = blockIdx.x;
    int64_t m = (int64_t)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
    while (m * (m + 1) / 2 > q) --m;
    while ((m + 1) * (m + 2) / 2 <= q) ++m;
    const int64_t p = q - m * (m + 1) / 2;
    const int nt = s / kTile;
    const int tr = blockIdx.y / nt, tc = blockIdx.y - tr * nt;
    if (p == m && tc > tr) return;  // upper half of a diagonal block
    gemm_nt_tile<true>(
        panel + (s + m * s + tr * kTile) * (int64_t)s, s,
        panel + (s + p * s + tc * kTile) * (int64_t)s, s,
        band + ((j + 1 + m) * s + tr * kTile) * W + (w - m + p) * s +
            tc * kTile,
        W, s);
}

}  // namespace

extern "C" int sanm_band_assemble(const double* data,
                                  const int32_t* diag_of_row,
                                  const int32_t* sel, const int32_t* rows,
                                  const int32_t* cols,
                                  const int64_t* band_idx,
                                  const int64_t* pad_idx, double* scale,
                                  double* band, int64_t n, int64_t nlow,
                                  int64_t npad, int64_t band_len,
                                  void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(band, 0, band_len * sizeof(double), st);
    if (err != cudaSuccess) return (int)err;
    if (n > 0)
        band_scale_kernel<<<blocks_for(n), kThreads, 0, st>>>(
            data, diag_of_row, scale, n);
    if (nlow > 0)
        band_scatter_kernel<<<blocks_for(nlow), kThreads, 0, st>>>(
            data, scale, sel, rows, cols, band_idx, band, nlow);
    if (npad > 0)
        band_pad_kernel<<<blocks_for(npad), kThreads, 0, st>>>(pad_idx, band,
                                                               npad);
    return (int)cudaGetLastError();
}

extern "C" int sanm_band_factor(double* band, double* panels,
                                const int64_t* panel_off,
                                const int64_t* blk_w, int64_t nb, int64_t w,
                                void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t W = (w + 1) * s;
    const size_t smem = diag_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned nt = (unsigned)(s / kTile);
    for (int64_t j = 0; j < nb; ++j) {
        const int64_t wj = blk_w[j];
        double* panel = panels + panel_off[j];
        diag_factor_kernel<false><<<1, kDiagThreads, smem, st>>>(
            band, W, j * s, w * s, panel);
        if (wj > 0) {
            panel_kernel<<<dim3((unsigned)(wj * s / kTile), nt),
                           kGemmThreads, 0, st>>>(band, W, w, j, panel);
            trailing_kernel<<<dim3((unsigned)(wj * (wj + 1) / 2), nt * nt),
                              kGemmThreads, 0, st>>>(band, W, w, j, panel);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

extern "C" int sanm_band_solve(const double* panels,
                               const int64_t* panel_off,
                               const int64_t* blk_w, const int32_t* perm_ext,
                               const int32_t* invp_ext, const double* rhs,
                               double* work, double* partial, double* out,
                               int64_t n, int64_t nrow, int64_t nb,
                               void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    perm_gather_kernel<<<blocks_for(nrow), kThreads, 0, st>>>(perm_ext, rhs,
                                                              work, n, nrow);
    cudaError_t err;
    for (int64_t j = 0; j < nb; ++j) {
        const int64_t wj = blk_w[j];
        const double* P = panels + panel_off[j];
        double* r = work + j * s;
        fwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(P, r);
        if (wj > 0)
            fwd_panel_kernel<kBlock>
                <<<(unsigned)(wj * s / kSolveRows), kThreads, 0, st>>>(
                    P + (int64_t)s * s, s, r, r + s, wj * s);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = nb - 1; j >= 0; --j) {
        const int64_t wj = blk_w[j];
        const double* P = panels + panel_off[j];
        double* r = work + j * s;
        const int64_t ng = (wj * s + kBwdRows - 1) / kBwdRows;
        if (wj > 0)
            bwd_panel_kernel<kBlock><<<(unsigned)ng, kBwdThreads, 0, st>>>(
                P + (int64_t)s * s, s, r + s, partial, wj * s);
        bwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(P, partial, ng, r);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    perm_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(invp_ext, work,
                                                            out, n);
    return (int)cudaGetLastError();
}
