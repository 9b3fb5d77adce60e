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
// the pad; the factor overwrites its lower triangle with L (above the
// diagonal, blocks off the diagonal keep what they held and the diagonal
// blocks hold junk), and the inverses of the diagonal blocks L[j,j] go to
// inv (nb, s, s).
//
// Bounds on the H100 at armadillo-small (npad = 38,144, nb = 298):
// * factor: npad^3 / 3 = 1.85e13 f64 operations, almost all in the
//   trailing updates: bound by the f64 tensor-core rate (67 TFLOP/s),
//   ~276 ms.  A right-looking update of depth d reads and writes the
//   trailing lower triangle once per d columns: sum 8 (npad - i d)^2 ~ 8
//   npad^3 / (3 d) bytes, 1.16e12 B = 345 ms at 3.35 TB/s for d = s = 128,
//   half that (173 ms) at d = 2 s;
// * solve: reads the 5.8 GB lower triangle (twice: forward and backward):
//   memory bound, 1.74 ms for one read at 3.35 TB/s.
//
// Design.  The factor is the band factor's loop (band.cu) with the reach
// of every block column running to the last block row, on the same two
// streams (look_ahead, chol_blocks.h), and its trailing update applied two
// block columns at a time.  Per pair of columns (j, j+1), on crit:
// 1. diag_factor_kernel<true> (chol_blocks.h): L[j,j] in place and its
//    inverse;
// 2. dense_panel_kernel: T_j = A[below, j] inv^T in place, 64 x 128 tiles
//    (tile_nt: a CTA reads its rows whole before it writes them);
// 3. dense_update_kernel, depth s: block column j+1 loses T_j T_j[j+1]^T;
// 4. steps 1-2 for column j+1;
// 5. the narrow update, depth 2s: block columns j+2 and j+3 lose T_j
//    T_j^T, then T_{j+1} T_{j+1}^T, in one pass over the two panels (they
//    lie side by side in A; tile_nt's seg), once the previous pair's rest
//    has landed;
// and on side, beside the next pair's steps 1-5, the rest of the depth-2s
// update: blocks (a, b), b >= j+4, a >= b.  With nb odd the last column
// is a pair of one (its diagonal step alone).  Updates run 128 x 64 tiles
// through f64 mma.sync from a cp.async ring, the upper half of the
// diagonal blocks skipped by warps.  Every block loses its columns'
// products one column at a time in ascending order, as in the plain
// version: summing a pair's two products before the subtraction, the
// rounding of the last blocks' Schur complements (the ill-conditioned
// end of the factor) moved the inverses 1.6e-10 from the plain version's
// at armadillo-small's equilibrium, against 1.9e-11 one column at a time.
// So the factor repeats its bits, and a pair costs one DRAM pass: the
// tile's C values return from L2 between its two columns.  A negative
// pivot gives NaN, which propagates through the inverse, the panel and
// every later block: the wrapper's finiteness check sees it.
// The solve is the band solve's chain of one-CTA diagonal steps and
// many-CTA panel steps, the panel being the whole column below the block.
#include <cuda_runtime.h>

#include "chol_blocks.h"
#include "sanm_kernels.h"

namespace {

// the depth of the factor tiles' cp.async rings (tile_nt, chol_blocks.h):
// two CTAs of 92 KB fit an SM
constexpr int kStages = 3;

// T = A[(j+1)s + row, js : js+s] inv^T in place for the rows below block
// j.  Grid: rows / 64 tiles of 64 x 128.
__global__ void __launch_bounds__(kFactorThreads, 2)
dense_panel_kernel(double* A, int64_t lda, int64_t j,
                   const double* __restrict__ inv) {
    constexpr int s = kBlock;
    double* P = A + ((j + 1) * s + (int64_t)blockIdx.x * 64) * lda + j * s;
    tile_nt<64, 128, 32, kStages, kSet>(P, lda, inv, s, P, lda, s, -1, true);
}

// Block (a, b) -= A[a, c0 s : c0 s + kd] A[b, c0 s : c0 s + kd]^T (block
// rows and columns of s; the panels of kd / s columns from column block
// c0), each panel's product subtracted in turn (as the one-column update
// of the plain version), as two 128 x 64 tiles (blockIdx.x % 2 the column
// half).  kTri: the lower triangle of blocks from (b0, b0), a >= b (grid
// nr (nr + 1)); else the block columns b0 + blockIdx.y, rows a = b0 +
// blockIdx.x / 2 >= b (grid 2 (nb - b0) x columns).
template <bool kTri>
__global__ void __launch_bounds__(kFactorThreads, 2)
dense_update_kernel(double* A, int64_t lda, int64_t c0, int kd, int64_t b0) {
    constexpr int s = kBlock;
    const int half = blockIdx.x & 1;
    const int64_t q = blockIdx.x >> 1;
    int64_t a = b0 + q, b = b0 + blockIdx.y;
    if (kTri) {
        int64_t m = (int64_t)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
        while (m * (m + 1) / 2 > q) --m;
        while ((m + 1) * (m + 2) / 2 <= q) ++m;
        a = b0 + m;
        b = b0 + q - m * (m + 1) / 2;
    } else if (a < b) {
        return;
    }
    const int64_t c = b * s + half * 64;
    tile_nt<128, 64, 32, kStages, kSubtract>(
        A + a * s * lda + c0 * s, lda, A + c * lda + c0 * s, lda,
        A + a * s * lda + c, lda, kd, a == b ? half * 64 : -1, false, s);
}

// The factor kernels' shared-memory attributes (once per device, by
// look_ahead).
cudaError_t dense_factor_setup() {
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)diag_smem_bytes());
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            dense_panel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)tile_smem_bytes<64, 128, kStages>());
    for (const void* k : {(const void*)dense_update_kernel<true>,
                          (const void*)dense_update_kernel<false>})
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(
                k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)tile_smem_bytes<128, 64, kStages>());
    return err;
}

}  // namespace

extern "C" int sanm_dense_factor(double* A, double* inv, int64_t nb,
                                 void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t lda = nb * s;
    const size_t ts = tile_smem_bytes<128, 64, kStages>();
    LookAhead* la = nullptr;
    cudaError_t err = look_ahead(&la, dense_factor_setup);
    if (err == cudaSuccess) err = fork_from(la, st);
    // diagonal step and panel of column c (rows below it) on crit
    auto column = [&](int64_t c) {
        diag_factor_kernel<true><<<1, kFactorThreads, diag_smem_bytes(),
                                   la->crit>>>(A, lda, c * s, c * s,
                                               inv + c * s * s);
        if (c + 1 < nb)
            dense_panel_kernel<<<(unsigned)((nb - 1 - c) * s / 64),
                                 kFactorThreads,
                                 tile_smem_bytes<64, 128, kStages>(),
                                 la->crit>>>(A, lda, c, inv + c * s * s);
    };
    for (int64_t j = 0; j < nb && err == cudaSuccess; j += 2) {
        column(j);
        if (j + 1 == nb) break;
        dense_update_kernel<false><<<dim3((unsigned)(2 * (nb - j - 1)), 1),
                                     kFactorThreads, ts, la->crit>>>(
            A, lda, j, s, j + 1);
        column(j + 1);
        if (j + 2 == nb) break;
        // the previous pair's rest (on side) writes block columns j+2 and
        // j+3 too; this pair's rest waits for both panels
        err = hand_over(la->done, la->side, la->crit);
        if (err == cudaSuccess) err = hand_over(la->ready, la->crit, la->side);
        if (err != cudaSuccess) break;
        const int64_t cols = nb - j - 2 < 2 ? nb - j - 2 : 2;
        dense_update_kernel<false>
            <<<dim3((unsigned)(2 * (nb - j - 2)), (unsigned)cols),
               kFactorThreads, ts, la->crit>>>(A, lda, j, 2 * s, j + 2);
        const int64_t nr = nb - j - 4;
        if (nr > 0)
            dense_update_kernel<true>
                <<<(unsigned)(nr * (nr + 1)), kFactorThreads, ts,
                   la->side>>>(A, lda, j, 2 * s, j + 4);
        err = cudaGetLastError();
    }
    if (err == cudaSuccess) err = join_into(la, st);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int sanm_diag_factor(double* a, double* inv, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)diag_smem_bytes());
    if (err != cudaSuccess) return (int)err;
    diag_factor_kernel<true><<<1, kFactorThreads, diag_smem_bytes(),
                               (cudaStream_t)stream>>>(a, kBlock, 0, 0, inv);
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
            fwd_panel_kernel
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
            bwd_panel_kernel<<<(unsigned)ng, kBwdThreads, 0, st>>>(
                L + (j + 1) * s * npad + j * s, npad, r + s, partial, rows);
        bwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(inv + j * s * s, partial,
                                                    ng, r);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaMemcpyAsync(out, work, n * sizeof(double),
                                cudaMemcpyDeviceToDevice, st);
}
