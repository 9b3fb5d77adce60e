// K6: the dense blocked Cholesky and its substitutions (the dense_chol
// solver).
//
// Replaces sanm_tpu/solver/linear.py: blocked_cholesky (:305) and
// chol_factor (:451) as sanm_dense_factor, blocked_tri_solve_lower,
// blocked_tri_solve_upper_T and blocked_chol_solve (:364-436) as
// sanm_dense_solve.  The JAX package factors in f32 on the TPU's matrix
// unit in blocks of 2048; here everything is f64 in blocks of s = 128.
//
// Layout (see sanm_tpu_torch/solver/linear.py): the matrix is one
// (npad, npad) row-major f64 buffer, npad = nb s, with a unit diagonal in
// the pad; the factor overwrites its lower triangle with L (the upper
// triangle keeps what it held), and the inverses of the diagonal blocks
// L[j,j] go to inv (nb, s, s).
//
// Bounds on the H100 at armadillo-small (npad = 38,144, nb = 298):
// * factor: npad^3 / 3 = 1.85e13 f64 operations, almost all in the
//   trailing updates: bound by the f64 tensor-core rate (67 TFLOP/s),
//   ~276 ms;
// * solve: reads the 5.8 GB lower triangle (twice: forward and backward):
//   memory bound, 1.74 ms for one read at 3.35 TB/s.
//
// Design.  The factor is the band factor's loop (band.cu) with the reach
// of every block column running to the last block row: per column j,
// 1. diag_factor_kernel<true> (chol_blocks.h), one CTA: L[j,j] in place
//    and its inverse;
// 2. dense_panel_kernel: T = A[below, j] inv^T into a scratch panel (the
//    two column tiles of a row read the whole row, so the panel cannot be
//    written in place);
// 3. dense_trailing_kernel: block (a, b) -= T_a T_b^T for j < b <= a,
//    64 x 64 tiles through f64 mma.sync, the upper half of the diagonal
//    blocks skipped;
// 4. the panel copied into column block j (cudaMemcpy2DAsync).
// A negative pivot gives NaN, which propagates through the inverse, the
// panel and every later block: the wrapper's finiteness check sees it.
// The solve is the band solve's chain of one-CTA diagonal steps and
// many-CTA panel steps, the panel being the whole column below the block.
#include <cuda_runtime.h>

#include "chol_blocks.h"
#include "sanm_kernels.h"

namespace {

// T[row, :] = A[(j+1)s + row, js : js+s] inv^T for the rows below block j.
// Grid: (rows / 64, s / 64) tiles.
__global__ void __launch_bounds__(kGemmThreads)
dense_panel_kernel(const double* __restrict__ A, int64_t lda, int64_t j,
                   const double* __restrict__ inv, double* __restrict__ T) {
    constexpr int s = kBlock;
    const int64_t row = (int64_t)blockIdx.x * kTile;
    gemm_nt_tile<false>(A + ((j + 1) * s + row) * lda + j * s, lda,
                        inv + (int64_t)blockIdx.y * kTile * s, s,
                        T + row * s + (int64_t)blockIdx.y * kTile, s, s);
}

// Block (j+1+m, j+1+p) -= T[m] T[p]^T, p <= m.  Grid: (nr (nr+1) / 2
// pairs, (s/64)^2 tiles), nr the block rows below j.
__global__ void __launch_bounds__(kGemmThreads)
dense_trailing_kernel(double* __restrict__ A, int64_t lda, int64_t j,
                      const double* __restrict__ T) {
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
        T + (m * s + tr * kTile) * (int64_t)s, s,
        T + (p * s + tc * kTile) * (int64_t)s, s,
        A + ((j + 1 + m) * s + tr * kTile) * lda + (j + 1 + p) * s +
            tc * kTile,
        lda, s);
}

}  // namespace

extern "C" int sanm_dense_factor(double* A, double* inv, double* T,
                                 int64_t nb, void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t lda = nb * s;
    const size_t smem = diag_smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned nt = (unsigned)(s / kTile);
    for (int64_t j = 0; j < nb; ++j) {
        diag_factor_kernel<true><<<1, kDiagThreads, smem, st>>>(
            A, lda, j * s, j * s, inv + j * s * s);
        const int64_t nr = nb - 1 - j, rows = nr * s;
        if (nr > 0) {
            dense_panel_kernel<<<dim3((unsigned)(rows / kTile), nt),
                                 kGemmThreads, 0, st>>>(A, lda, j,
                                                        inv + j * s * s, T);
            dense_trailing_kernel<<<dim3((unsigned)(nr * (nr + 1) / 2),
                                         nt * nt),
                                    kGemmThreads, 0, st>>>(A, lda, j, T);
            err = cudaMemcpy2DAsync(A + (j + 1) * s * lda + j * s,
                                    lda * sizeof(double), T,
                                    s * sizeof(double), s * sizeof(double),
                                    rows, cudaMemcpyDeviceToDevice, st);
            if (err != cudaSuccess) return (int)err;
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

extern "C" int sanm_dense_solve(const double* L, const double* inv,
                                const double* rhs, double* work,
                                double* partial, double* out, int64_t n,
                                int64_t nb, void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t npad = nb * s;
    cudaError_t err = cudaMemcpyAsync(work, rhs, n * sizeof(double),
                                      cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
    if (npad > n) {
        err = cudaMemsetAsync(work + n, 0, (npad - n) * sizeof(double), st);
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = 0; j < nb; ++j) {
        double* r = work + j * s;
        const int64_t rows = npad - (j + 1) * s;
        fwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(inv + j * s * s, r);
        if (rows > 0)
            fwd_panel_kernel<0>
                <<<(unsigned)(rows / kSolveRows), kThreads, 0, st>>>(
                    L + (j + 1) * s * npad + j * s, npad, r, r + s, rows);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = nb - 1; j >= 0; --j) {
        double* r = work + j * s;
        const int64_t rows = npad - (j + 1) * s;
        const int64_t ng = (rows + kBwdRows - 1) / kBwdRows;
        if (rows > 0)
            bwd_panel_kernel<0><<<(unsigned)ng, kBwdThreads, 0, st>>>(
                L + (j + 1) * s * npad + j * s, npad, r + s, partial, rows);
        bwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(inv + j * s * s, partial,
                                                    ng, r);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaMemcpyAsync(out, work, n * sizeof(double),
                                cudaMemcpyDeviceToDevice, st);
}
