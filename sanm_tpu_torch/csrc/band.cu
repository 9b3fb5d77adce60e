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
// launches per column on one stream:
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

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // GEMM output tile, rows and columns
constexpr int kTileK = 16;            // GEMM depth per shared-memory stage
constexpr int kTileLd = kTileK + 4;   // padded shared row
constexpr int kGemmThreads = 128;     // 4 warps of 32 x 32 outputs
constexpr int kDiagThreads = 1024;
constexpr int kSolveRows = 32;        // panel rows per forward CTA
constexpr int kBwdThreads = 256;      // backward panel step
constexpr int kBwdRows = 64;          // panel rows per backward CTA
// The block size s of every kernel: one s x s f64 diagonal block (128 KB)
// in one CTA's shared memory.  BandPlan.s must equal it (the wrappers of
// sanm_tpu_torch/solver/band.py check).
constexpr int kBlock = 128;

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

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

// Cholesky of the diagonal block at (row0, col0) of the band and its
// inverse, written to inv (s x s, row-major, zero above the diagonal).
// Both run right-looking with one barrier per column: step k updates with
// column k (row k of the inverse) divided by its pivot on the fly, while
// column k-1 (row k-1) is scaled, so the two touch disjoint entries.
__global__ void __launch_bounds__(kDiagThreads)
diag_factor_kernel(const double* __restrict__ band, int64_t W, int64_t row0,
                   int64_t col0, double* __restrict__ inv) {
    constexpr int s = kBlock;
    extern __shared__ double sm[];
    const int ld = s + 1;
    double* A = sm;                   // s x ld: L below, X = L^-1 above
    double* xd = sm + (size_t)s * ld;  // diagonal of X
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int nwarp = kDiagThreads / 32;

    // load the lower triangle, zero the upper (one warp per row, every
    // load of a lane in flight at once)
#pragma unroll
    for (int q = 0; q < kBlock / nwarp; ++q) {
        const int r = warp + q * nwarp;
#pragma unroll
        for (int t = 0; t < kBlock / 32; ++t) {
            const int c = lane + 32 * t;
            if (r < s && c < s)
                A[r * ld + c] =
                    c <= r ? band[(row0 + r) * W + col0 + c] : 0.0;
        }
    }
    for (int i = tid; i < s; i += kDiagThreads) xd[i] = 1.0;
    __syncthreads();

    // Cholesky: step k subtracts column k over its pivot from the trailing
    // lower triangle and scales column k-1 by the root of its pivot
    // (kept in a register from step k-1)
    double piv_prev = 0.0;
    for (int k = 0; k < s; ++k) {
        const double piv = A[k * ld + k];
        const double rpiv = 1.0 / piv;
        for (int r = k + 1 + warp; r < s; r += nwarp) {
            const double lrk = A[r * ld + k] * rpiv;
            for (int c = k + 1 + lane; c <= r; c += 32)
                A[r * ld + c] -= lrk * A[c * ld + k];
        }
        if (k > 0) {
            const double d = sqrt(piv_prev), rd = 1.0 / d;
            for (int r = k - 1 + tid; r < s; r += kDiagThreads)
                A[r * ld + k - 1] = r == k - 1 ? d : A[r * ld + k - 1] * rd;
        }
        piv_prev = piv;
        __syncthreads();
    }
    if (tid == 0) A[(s - 1) * ld + s - 1] = sqrt(piv_prev);
    __syncthreads();

    // X = L^-1 from X = I: step k subtracts L[i][k] X[k][c] / L[k][k] from
    // the rows i > k (columns c <= k) and scales row k-1 by 1/L[k-1][k-1];
    // X[i][c] (i > c) lives in A[c][i], its diagonal in xd
    for (int k = 0; k < s; ++k) {
        const double rkk = 1.0 / A[k * ld + k];
        for (int c = warp; c <= k; c += nwarp) {
            const double xkc = (c == k ? xd[k] : A[c * ld + k]) * rkk;
            for (int i = k + 1 + lane; i < s; i += 32)
                A[c * ld + i] -= A[i * ld + k] * xkc;
        }
        if (k > 0) {
            const double r1 = 1.0 / A[(k - 1) * ld + k - 1];
            for (int c = tid; c < k; c += kDiagThreads) {
                if (c == k - 1)
                    xd[c] *= r1;
                else
                    A[c * ld + k - 1] *= r1;
            }
        }
        __syncthreads();
    }
    {
        const double r1 = 1.0 / A[(s - 1) * ld + s - 1];
        for (int c = tid; c < s; c += kDiagThreads) {
            if (c == s - 1)
                xd[c] *= r1;
            else
                A[c * ld + s - 1] *= r1;
        }
    }
    __syncthreads();
    for (int idx = tid; idx < s * s; idx += kDiagThreads) {
        const int r = idx / s, c = idx - r * s;
        inv[idx] = c < r ? A[c * ld + r] : (c == r ? xd[r] : 0.0);
    }
}

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a), "d"(b));
}

// One 64 x 64 tile: C = A B^T (kSub: C -= A B^T), with A and B 64 rows of
// K (a multiple of kTileK) values each.  Warp q computes the 32 x 32
// quarter (q / 2, q % 2) as 4 x 4 mma tiles of 8 x 8.
template <bool kSub>
__device__ void gemm_nt_tile(const double* __restrict__ A, int64_t lda,
                             const double* __restrict__ B, int64_t ldb,
                             double* __restrict__ C, int64_t ldc, int K) {
    __shared__ double As[kTile][kTileLd];
    __shared__ double Bs[kTile][kTileLd];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, t = lane & 3;
    double acc[4][4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

    for (int k0 = 0; k0 < K; k0 += kTileK) {
        for (int idx = tid; idx < kTile * kTileK; idx += kGemmThreads) {
            int r = idx / kTileK, c = idx - r * kTileK;
            As[r][c] = A[r * lda + k0 + c];
            Bs[r][c] = B[r * ldb + k0 + c];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTileK; kk += 4) {
            double a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = As[wm + i * 8 + g][kk + t];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Bs[wn + j * 8 + g][kk + t];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i], b[j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            double* p = C + (int64_t)(wm + i * 8 + g) * ldc + wn + j * 8 + 2 * t;
            if (kSub) {
                p[0] -= acc[i][j][0];
                p[1] -= acc[i][j][1];
            } else {
                p[0] = acc[i][j][0];
                p[1] = acc[i][j][1];
            }
        }
}

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

// ---------------------------------------------------------------------------
// K5c band_solve
// ---------------------------------------------------------------------------

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void perm_gather_kernel(const int32_t* __restrict__ perm,
                                   const double* __restrict__ rhs,
                                   double* __restrict__ work, int64_t n,
                                   int64_t nrow) {
    int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i >= nrow) return;
    int32_t p = perm[i];
    work[i] = p < n ? rhs[p] : 0.0;
}

__global__ void perm_scatter_kernel(const int32_t* __restrict__ invp,
                                    const double* __restrict__ work,
                                    double* __restrict__ out, int64_t n) {
    int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i < n) out[i] = work[invp[i]];
}

// The solve's kernels are each one CTA step or one short pass over a
// panel; their time is latency.  Each loads everything that does not
// depend on the right-hand side before its first barrier, so that most of
// its loads share one round trip.

// r[0:s] = inv r[0:s], one warp per row.
__global__ void __launch_bounds__(kDiagThreads)
fwd_diag_kernel(const double* __restrict__ inv, double* __restrict__ r) {
    constexpr int s = kBlock;
    __shared__ double rs[kBlock];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int nwarp = kDiagThreads / 32;
    constexpr int kRows = kBlock / nwarp, kLane = kBlock / 32;
    double iv[kRows][kLane];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int i = warp + q * nwarp;
#pragma unroll
        for (int t = 0; t < kLane; ++t) {
            const int k = lane + 32 * t;
            iv[q][t] = i < s && k <= i ? inv[i * s + k] : 0.0;
        }
    }
    for (int i = tid; i < s; i += kDiagThreads) rs[i] = r[i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int i = warp + q * nwarp;
        double acc = 0.0;
#pragma unroll
        for (int t = 0; t < kLane; ++t) {
            const int k = lane + 32 * t;
            if (k < s) acc += iv[q][t] * rs[k];
        }
        acc = warp_sum(acc);
        if (lane == 0 && i < s) r[i] = acc;
    }
}

// rb[i] -= T[i, :] y for the rows i < rows, one warp per row, kSolveRows
// rows per CTA.
__global__ void __launch_bounds__(kThreads)
fwd_panel_kernel(const double* __restrict__ T, const double* __restrict__ y,
                 double* __restrict__ rb, int64_t rows) {
    constexpr int s = kBlock;
    __shared__ double ys[kBlock];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int nwarp = kThreads / 32;
    constexpr int kRows = kSolveRows / nwarp, kLane = kBlock / 32;
    const int64_t i0 = (int64_t)blockIdx.x * kSolveRows;
    double tv[kRows][kLane], rv[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int64_t i = i0 + warp + q * nwarp;
#pragma unroll
        for (int t = 0; t < kLane; ++t) {
            const int k = lane + 32 * t;
            tv[q][t] = i < rows && k < s ? T[i * s + k] : 0.0;
        }
        rv[q] = lane == 0 && i < rows ? rb[i] : 0.0;
    }
    for (int i = tid; i < s; i += kThreads) ys[i] = y[i];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int64_t i = i0 + warp + q * nwarp;
        double acc = 0.0;
#pragma unroll
        for (int t = 0; t < kLane; ++t) {
            const int k = lane + 32 * t;
            if (k < s) acc += tv[q][t] * ys[k];
        }
        acc = warp_sum(acc);
        if (lane == 0 && i < rows) rb[i] = rv[q] - acc;
    }
}

// partial[g][c] = sum over the kBwdRows rows i of group g of T[i][c] xb[i];
// thread (q, c) of the kBwdThreads / s slices takes the rows q modulo the
// slice count, and the slices are added in order.
__global__ void __launch_bounds__(kBwdThreads)
bwd_panel_kernel(const double* __restrict__ T, const double* __restrict__ xb,
                 double* __restrict__ partial, int64_t rows) {
    constexpr int s = kBlock;
    __shared__ double red[kBwdThreads];
    const int tid = threadIdx.x, nq = kBwdThreads / s;
    const int q = tid / s, c = tid - q * s;
    const int64_t i0 = (int64_t)blockIdx.x * kBwdRows;
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t < kBwdRows * kBlock / kBwdThreads; ++t) {
        const int64_t i = i0 + q + (int64_t)t * nq;
        if (i < i0 + kBwdRows && i < rows) acc += T[i * s + c] * xb[i];
    }
    red[tid] = acc;
    __syncthreads();
    if (q == 0) {
        double v = 0.0;
        for (int h = 0; h < nq; ++h) v += red[h * s + c];
        partial[(int64_t)blockIdx.x * s + c] = v;
    }
}

// y[0:s] = inv^T (y[0:s] - sum_g partial[g]).  Thread (q, c) of the
// kDiagThreads / s slices sums the groups g = q mod slices, then the terms
// k = c + q mod slices of column c; the slices' sums are added in order.
__global__ void __launch_bounds__(kDiagThreads)
bwd_diag_kernel(const double* __restrict__ inv,
                const double* __restrict__ partial, int64_t ng,
                double* __restrict__ y) {
    constexpr int s = kBlock;
    __shared__ double red[kDiagThreads];
    __shared__ double ts[kBlock];
    constexpr int kTerms = kBlock * kBlock / kDiagThreads;
    const int tid = threadIdx.x, nq = kDiagThreads / s;
    const int q = tid / s, c = tid - q * s;
    double iv[kTerms];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
        const int k = c + q + t * nq;
        iv[t] = k < s ? inv[k * s + c] : 0.0;
    }
    const double yc = q == 0 ? y[c] : 0.0;
    double acc = 0.0;
#pragma unroll 8
    for (int64_t g = q; g < ng; g += nq) acc += partial[g * s + c];
    red[tid] = acc;
    __syncthreads();
    if (q == 0) {
        double t = yc;
        for (int i = 0; i < nq; ++i) t -= red[i * s + c];
        ts[c] = t;
    }
    __syncthreads();
    acc = 0.0;
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
        const int k = c + q + t * nq;
        if (k < s) acc += iv[t] * ts[k];
    }
    red[tid] = acc;
    __syncthreads();
    if (q == 0) {
        double x = 0.0;
        for (int i = 0; i < nq; ++i) x += red[i * s + c];
        y[c] = x;
    }
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
    const size_t smem = ((size_t)s * (s + 1) + s) * sizeof(double);
    cudaError_t err = cudaFuncSetAttribute(
        diag_factor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned nt = (unsigned)(s / kTile);
    for (int64_t j = 0; j < nb; ++j) {
        const int64_t wj = blk_w[j];
        double* panel = panels + panel_off[j];
        diag_factor_kernel<<<1, kDiagThreads, smem, st>>>(band, W, j * s,
                                                         w * s, panel);
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
            fwd_panel_kernel<<<(unsigned)(wj * s / kSolveRows), kThreads, 0,
                               st>>>(P + (int64_t)s * s, r, r + s, wj * s);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    for (int64_t j = nb - 1; j >= 0; --j) {
        const int64_t wj = blk_w[j];
        const double* P = panels + panel_off[j];
        double* r = work + j * s;
        const int64_t ng = (wj * s + kBwdRows - 1) / kBwdRows;
        if (wj > 0)
            bwd_panel_kernel<<<(unsigned)ng, kBwdThreads, 0, st>>>(
                P + (int64_t)s * s, r + s, partial, wj * s);
        bwd_diag_kernel<<<1, kDiagThreads, 0, st>>>(P, partial, ng, r);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    perm_scatter_kernel<<<blocks_for(n), kThreads, 0, st>>>(invp_ext, work,
                                                            out, n);
    return (int)cudaGetLastError();
}
