// K7: the SPIKE partitioned band solve (the spike_band solver).
//
// Replaces sanm_tpu/solver/spike.py: the spike computation of
// _spike_factor_impl (:295-322, uband_tri_solve :237 on b right-hand
// sides) as sanm_spike_rhs_solve, and _spike_tri_solve_impl (:375-428) as
// sanm_spike_solve.  The P local band factors are K5b's (band.cu), one per
// partition at the partition's own skyline reach; the reduced block-Thomas
// precompute (b x b products and LU factors, once per restart) stays with
// the library, as in the JAX package (jsl.lu_factor / lu_solve).  The JAX
// package runs everything in f32 on the TPU's matrix unit; here it is f64.
//
// Layouts (see sanm_tpu_torch/solver/spike.py): partition p's local
// factor is panels at off[p mb + j] (panel j: inv(L[j,j]) over its
// blk_w[p mb + j] subdiagonal blocks); the spikes V and W are (P, m, b)
// row-major; LU (P, b, b) holds each K_p = L U (unit L below, U on and
// above the diagonal) with its row permutation lu_perm (P, b); invL and
// invUt (P, b/s, s, s) the inverses of L's diagonal blocks and the
// transposed inverses of U's; G (P, b, b); Mh (2, P, b, b) = Mht over Mhb.
//
// Bounds on the H100 at armadillo-small (P = 4, m = 9,600, b = 6,784):
// * rhs solve: 2 (2 sum_j w_j s^2 k + 2 mb s^2 k) f64 operations per
//   partition and spike set (k = b columns): bound by the f64 tensor-core
//   rate;
// * solve: reads the 4.2 GB of spikes, the 5.9 GB of LU, G and Mh and the
//   local panels once: memory bound, ~3.3 ms at 3.35 TB/s.
//
// Design.  The rhs solve is the band substitution (band.cu) on k columns
// at once, batched over the partitions as the grid's z dimension; each
// partition reads its own reach.  Per block column j, forward:
//   X_j = inv_j R_j, then R[below] -= T_j X_j;
// backward:
//   Z = X_j - T_j^T X[below], then X_j = inv_j^T Z;
// every product through 64 x 64 f64 mma.sync tiles (gemm_xn_tile,
// chol_blocks.h), with R, X and Z in separate buffers so that no tile
// reads what another writes.  The solve is one chain of small kernels:
// the permutation, the batched local substitution (the band solve's
// steps, the partition as a grid dimension), the reduced forward and
// backward recursions (b x b matrix-vector products, one warp per row,
// and K_p's triangular solves in blocks of s with the inverses of its
// diagonal blocks), the rank-b recombination and the permutation back.
#include <cuda_runtime.h>

#include "chol_blocks.h"
#include "sanm_kernels.h"

namespace {

// ---------------------------------------------------------------------------
// K7b spike_rhs_solve
// ---------------------------------------------------------------------------

// X_j = op(inv_j) B for partition blockIdx.z, op = identity (forward) or
// transpose (backward); B = Bsrc + p bstride, s x k (ld k).  Grid
// (s / 64, k / 64, P).
template <bool kTransA>
__global__ void __launch_bounds__(kGemmThreads)
spike_diag_mm_kernel(const double* __restrict__ panels,
                     const int64_t* __restrict__ off, int64_t mb, int64_t j,
                     const double* Bsrc, int64_t bstride, double* X,
                     int64_t m, int64_t k) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.z;
    const int64_t r0 = (int64_t)blockIdx.x * kTile;
    const int64_t c0 = (int64_t)blockIdx.y * kTile;
    const double* inv = panels + off[p * mb + j];
    gemm_xn_tile<kTransA, kSet>(kTransA ? inv + r0 : inv + r0 * s, s,
                                Bsrc + p * bstride + c0, k,
                                X + p * m * k + (j * s + r0) * k + c0, k, s,
                                nullptr, 0);
}

// R[(j+1)s + row, :] -= T_j[row, :] X_j for the w_j s rows of partition
// blockIdx.z's panel.  Grid (max_p w_j s / 64, k / 64, P).
__global__ void __launch_bounds__(kGemmThreads)
spike_fwd_update_kernel(const double* __restrict__ panels,
                        const int64_t* __restrict__ off,
                        const int64_t* __restrict__ blk_w, int64_t mb,
                        int64_t j, const double* X, double* R, int64_t m,
                        int64_t k) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.z;
    const int64_t row = (int64_t)blockIdx.x * kTile;
    if (row >= blk_w[p * mb + j] * s) return;
    const int64_t c0 = (int64_t)blockIdx.y * kTile;
    const double* T = panels + off[p * mb + j] + (int64_t)s * s;
    gemm_xn_tile<false, kSubtract>(
        T + row * s, s, X + p * m * k + j * s * k + c0, k,
        R + p * m * k + ((j + 1) * s + row) * k + c0, k, s, nullptr, 0);
}

// Z_p = X_j - T_j^T X[(j+1)s : (j+1+w_j)s, :] (Z_p = X_j where w_j = 0).
// Grid (s / 64, k / 64, P).
__global__ void __launch_bounds__(kGemmThreads)
spike_bwd_update_kernel(const double* __restrict__ panels,
                        const int64_t* __restrict__ off,
                        const int64_t* __restrict__ blk_w, int64_t mb,
                        int64_t j, const double* X, double* Z, int64_t m,
                        int64_t k) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.z;
    const int64_t r0 = (int64_t)blockIdx.x * kTile;
    const int64_t c0 = (int64_t)blockIdx.y * kTile;
    const int K = (int)(blk_w[p * mb + j] * s);
    const double* T = panels + off[p * mb + j] + (int64_t)s * s;
    const double* Xp = X + p * m * k;
    gemm_xn_tile<true, kFromD>(T + r0, s, Xp + (j + 1) * s * k + c0, k,
                               Z + p * s * k + r0 * k + c0, k, K,
                               Xp + (j * s + r0) * k + c0, k);
}

// ---------------------------------------------------------------------------
// K7c spike_solve
// ---------------------------------------------------------------------------

// The band solve's steps (chol_blocks.h) for block column j of every
// partition: partition blockIdx.x (diagonal steps) or blockIdx.y (panel
// steps), its vector at work + p m.
__global__ void __launch_bounds__(kDiagThreads)
spike_fwd_diag_kernel(const double* __restrict__ panels,
                      const int64_t* __restrict__ off, int64_t mb, int64_t j,
                      double* __restrict__ work, int64_t m) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.x;
    fwd_diag_step(panels + off[p * mb + j], work + p * m + j * s);
}

__global__ void __launch_bounds__(kThreads)
spike_fwd_panel_kernel(const double* __restrict__ panels,
                       const int64_t* __restrict__ off,
                       const int64_t* __restrict__ blk_w, int64_t mb,
                       int64_t j, double* __restrict__ work, int64_t m) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.y;
    const int64_t rows = blk_w[p * mb + j] * s;
    if ((int64_t)blockIdx.x * kSolveRows >= rows) return;
    double* r = work + p * m + j * s;
    fwd_panel_step(panels + off[p * mb + j] + (int64_t)s * s, s, r, r + s,
                   rows, blockIdx.x);
}

__global__ void __launch_bounds__(kBwdThreads)
spike_bwd_panel_kernel(const double* __restrict__ panels,
                       const int64_t* __restrict__ off,
                       const int64_t* __restrict__ blk_w, int64_t mb,
                       int64_t j, const double* __restrict__ work, int64_t m,
                       double* __restrict__ partial, int64_t ngmax) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.y;
    const int64_t rows = blk_w[p * mb + j] * s;
    if ((int64_t)blockIdx.x * kBwdRows >= rows) return;
    bwd_panel_step(panels + off[p * mb + j] + (int64_t)s * s, s,
                   work + p * m + (j + 1) * s,
                   partial + (p * ngmax + blockIdx.x) * s, rows, blockIdx.x);
}

__global__ void __launch_bounds__(kDiagThreads)
spike_bwd_diag_kernel(const double* __restrict__ panels,
                      const int64_t* __restrict__ off,
                      const int64_t* __restrict__ blk_w, int64_t mb,
                      int64_t j, double* __restrict__ work, int64_t m,
                      const double* __restrict__ partial, int64_t ngmax) {
    constexpr int s = kBlock;
    const int64_t p = blockIdx.x;
    const int64_t ng = (blk_w[p * mb + j] * s + kBwdRows - 1) / kBwdRows;
    bwd_diag_step(panels + off[p * mb + j], partial + p * ngmax * s, ng,
                  work + p * m + j * s);
}

// out[i] = base[i] -+ (sum_c M1[i ld1 + c] v1[c] + sum_c M2[i ld2 + c]
// v2[c]) for i < rows (kAdd: +), a term dropped where its matrix is null;
// batch blockIdx.y offsets every pointer by its stride.  One warp per row
// (kThreads / 32 rows per CTA); a lane sums the columns c = lane mod 32.
// out may be base.
template <bool kAdd>
__global__ void __launch_bounds__(kThreads)
mv_kernel(const double* base, int64_t sb, const double* __restrict__ M1,
          int64_t ld1, int64_t sm1, const double* v1, int64_t sv1,
          const double* __restrict__ M2, int64_t ld2, int64_t sm2,
          const double* v2, int64_t sv2, double* out, int64_t so,
          int64_t rows, int64_t cols) {
    const int lane = threadIdx.x & 31;
    const int64_t q = blockIdx.y;
    const int64_t i = (int64_t)blockIdx.x * (kThreads / 32) +
                      (threadIdx.x >> 5);
    if (i >= rows) return;
    double acc = 0.0;
    if (M1 != nullptr) {
        const double* mr = M1 + q * sm1 + i * ld1;
        const double* v = v1 + q * sv1;
#pragma unroll 4
        for (int64_t c = lane; c < cols; c += 32) acc += mr[c] * v[c];
    }
    if (M2 != nullptr) {
        const double* mr = M2 + q * sm2 + i * ld2;
        const double* v = v2 + q * sv2;
#pragma unroll 4
        for (int64_t c = lane; c < cols; c += 32) acc += mr[c] * v[c];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
        const double b = base[q * sb + i];
        out[q * so + i] = kAdd ? b + acc : b - acc;
    }
}

inline unsigned mv_blocks(int64_t rows) {
    constexpr int per = kThreads / 32;
    return (unsigned)((rows + per - 1) / per);
}

}  // namespace

extern "C" int sanm_spike_rhs_solve(const double* panels, const int64_t* off,
                                    const int64_t* blk_w,
                                    const int64_t* wmax, double* R,
                                    double* X, double* Z, int64_t P,
                                    int64_t mb, int64_t k, void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t m = mb * s;
    const dim3 grid((unsigned)(s / kTile), (unsigned)(k / kTile),
                    (unsigned)P);
    cudaError_t err;
    for (int64_t j = 0; j < mb; ++j) {
        spike_diag_mm_kernel<false><<<grid, kGemmThreads, 0, st>>>(
            panels, off, mb, j, R + j * s * k, m * k, X, m, k);
        if (wmax[j] > 0)
            spike_fwd_update_kernel<<<dim3((unsigned)(wmax[j] * s / kTile),
                                           (unsigned)(k / kTile),
                                           (unsigned)P),
                                      kGemmThreads, 0, st>>>(
                panels, off, blk_w, mb, j, X, R, m, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = mb - 1; j >= 0; --j) {
        spike_bwd_update_kernel<<<grid, kGemmThreads, 0, st>>>(
            panels, off, blk_w, mb, j, X, Z, m, k);
        spike_diag_mm_kernel<true><<<grid, kGemmThreads, 0, st>>>(
            panels, off, mb, j, Z, s * k, X, m, k);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaGetLastError();
}

extern "C" int sanm_spike_solve(
        const double* panels, const int64_t* off, const int64_t* blk_w,
        const int64_t* wmax, const double* V, const double* W,
        const double* LU, const int32_t* lu_perm, const double* invL,
        const double* invUt, const double* G, const double* Mh,
        const int32_t* perm_ext, const int32_t* invp_ext, const double* rhs,
        double* work, double* partial, double* red, double* out, int64_t n,
        int64_t P, int64_t mb, int64_t b, void* stream) {
    constexpr int s = kBlock;
    cudaStream_t st = (cudaStream_t)stream;
    const int64_t m = mb * s, nbb = b / s, bb = b * b;
    int64_t wm = 0;
    for (int64_t j = 0; j < mb; ++j) wm = wmax[j] > wm ? wmax[j] : wm;
    const int64_t ngmax = (wm * s + kBwdRows - 1) / kBwdRows;
    // red (3 + 4P rows of b): ct, yu[P], yt[P], zt[P + 1], zu[P + 1]
    double* ct = red;
    double* yu = red + b;
    double* yt = red + (1 + P) * b;
    double* zt = red + (1 + 2 * P) * b;
    double* zu = red + (2 + 3 * P) * b;
    cudaError_t err = cudaMemsetAsync(zt + P * b, 0, b * sizeof(double), st);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(zu, 0, b * sizeof(double), st);
    if (err != cudaSuccess) return (int)err;

    // g = blkdiag(A_p)^-1 (permuted rhs)
    perm_gather_kernel<<<blocks_for(P * m), kThreads, 0, st>>>(
        perm_ext, rhs, work, n, P * m);
    for (int64_t j = 0; j < mb; ++j) {
        spike_fwd_diag_kernel<<<(unsigned)P, kDiagThreads, 0, st>>>(
            panels, off, mb, j, work, m);
        if (wmax[j] > 0)
            spike_fwd_panel_kernel<<<dim3((unsigned)(wmax[j] * s /
                                                     kSolveRows),
                                          (unsigned)P),
                                     kThreads, 0, st>>>(panels, off, blk_w,
                                                        mb, j, work, m);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = mb - 1; j >= 0; --j) {
        if (wmax[j] > 0)
            spike_bwd_panel_kernel<<<dim3((unsigned)((wmax[j] * s +
                                                      kBwdRows - 1) /
                                                     kBwdRows),
                                          (unsigned)P),
                                     kBwdThreads, 0, st>>>(
                panels, off, blk_w, mb, j, work, m, partial, ngmax);
        spike_bwd_diag_kernel<<<(unsigned)P, kDiagThreads, 0, st>>>(
            panels, off, blk_w, mb, j, work, m, partial, ngmax);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }

    // reduced forward recursion: ct = gt_p - Wt_p yu_{p-1} and
    // yu_p = gu_p - Wb_p yu_{p-1} (one launch, two batches), yt_p =
    // K_p^-1 ct, yu_p += G_p yt_p
    for (int64_t p = 0; p < P; ++p) {
        const double* Wp = W + p * m * b;
        mv_kernel<false><<<dim3(mv_blocks(b), 2), kThreads, 0, st>>>(
            work + p * m, m - b, p > 0 ? Wp : nullptr, b, (m - b) * b,
            yu + (p - 1) * b, 0, nullptr, 0, 0, nullptr, 0, ct,
            (1 + p) * b, b, b);
        double* y = yt + p * b;
        perm_gather_kernel<<<blocks_for(b), kThreads, 0, st>>>(
            lu_perm + p * b, ct, y, b, b);
        const double* LUp = LU + p * bb;
        for (int64_t i = 0; i < nbb; ++i) {
            fwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(
                invL + (p * nbb + i) * s * s, y + i * s);
            if (i + 1 < nbb)
                fwd_panel_kernel<0>
                    <<<(unsigned)((b - (i + 1) * s) / kSolveRows), kThreads,
                       0, st>>>(LUp + (i + 1) * s * b + i * s, b, y + i * s,
                                y + (i + 1) * s, b - (i + 1) * s);
        }
        for (int64_t i = nbb - 1; i >= 0; --i) {
            bwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(
                invUt + (p * nbb + i) * s * s, partial, 0, y + i * s);
            if (i > 0)
                fwd_panel_kernel<0>
                    <<<(unsigned)(i * s / kSolveRows), kThreads, 0, st>>>(
                        LUp + i * s, b, y + i * s, y, i * s);
        }
        mv_kernel<true><<<dim3(mv_blocks(b), 1), kThreads, 0, st>>>(
            yu + p * b, 0, G + p * bb, b, 0, y, 0, nullptr, 0, 0, nullptr,
            0, yu + p * b, 0, b, b);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    // reduced backward recursion: zt_p = yt_p - Mht_p zt_{p+1} and
    // zu_p = yu_p - Mhb_p zt_{p+1} (zu_p stored at zu + (p + 1) b)
    for (int64_t p = P - 1; p >= 0; --p) {
        mv_kernel<false><<<dim3(mv_blocks(b), 2), kThreads, 0, st>>>(
            yt + p * b, -P * b, Mh + p * bb, b, P * bb, zt + (p + 1) * b, 0,
            nullptr, 0, 0, nullptr, 0, zt + p * b, (P + 2) * b, b, b);
    }
    // recombination x_p = g_p - V_p t_{p+1} - W_p u_{p-1}, then the
    // permutation back
    mv_kernel<false><<<dim3(mv_blocks(m), (unsigned)P), kThreads, 0, st>>>(
        work, m, V, b, m * b, zt + b, b, W, b, m * b, zu, b, work, m, m, b);
    perm_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(invp_ext, work,
                                                            out, n);
    return (int)cudaGetLastError();
}
