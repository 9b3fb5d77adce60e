// What the three Cholesky solvers share: K5 (band.cu, the skyline band),
// K6 (dense_chol.cu, the dense blocked factor) and K7 (spike.cu, the SPIKE
// partitioned band).  Every one of them factors and substitutes in s x s
// blocks, s = kBlock = 128: one s x s f64 block (128 KB) fits one CTA's
// shared memory.
//
// * diag_factor_kernel: one CTA, the Cholesky of a diagonal block and its
//   triangular inverse (optionally writing L back in place);
// * gemm_nt_tile / gemm_xn_tile: one 64 x 64 output tile of a product
//   through f64 mma.sync (m8n8k4) from shared memory;
// * the substitution steps: a one-CTA step with an s x s inverse
//   (forward: r = inv r; backward: y = inv^T (y - sum of partials)) and
//   the many-CTA panel steps (forward rb -= T y; backward partial column
//   sums of T^T xb in fixed row groups, added in order by the diagonal
//   step), each with the panel's row stride as an argument;
// * the permutation gather and scatter of the right-hand side.
//
// Everything is in an anonymous namespace: each .cu file that includes
// this header compiles its own copy.
#pragma once
#include <cstdint>

#include <cuda_runtime.h>

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
// The block size s of every kernel.  BandPlan.s, DensePlan.s and
// SpikePlan.s must equal it (the wrappers in sanm_tpu_torch/solver check).
constexpr int kBlock = 128;

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// dynamic shared memory of diag_factor_kernel
inline size_t diag_smem_bytes() {
    return ((size_t)kBlock * (kBlock + 1) + kBlock) * sizeof(double);
}

// ---------------------------------------------------------------------------
// the diagonal block
// ---------------------------------------------------------------------------

// Cholesky of the s x s block at (row0, col0) of a (lower triangle read)
// and its inverse, written to inv (s x s, row-major, zero above the
// diagonal); with kWriteL also L's lower triangle back into a (the upper
// half of the block is left as it was).  Both run right-looking with one
// barrier per column: step k updates with column k (row k of the inverse)
// divided by its pivot on the fly, while column k-1 (row k-1) is scaled,
// so the two touch disjoint entries.  A negative pivot gives sqrt < 0 =
// NaN, which propagates: never a clamp.
template <bool kWriteL>
__global__ void __launch_bounds__(kDiagThreads)
diag_factor_kernel(double* a, int64_t lda, int64_t row0, int64_t col0,
                   double* __restrict__ inv) {
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
                A[r * ld + c] = c <= r ? a[(row0 + r) * lda + col0 + c] : 0.0;
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
        if (kWriteL && c <= r) a[(row0 + r) * lda + col0 + c] = A[r * ld + c];
    }
}

// ---------------------------------------------------------------------------
// 64 x 64 product tiles through f64 mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a), "d"(b));
}

// The 32 x 32 quarter (warp / 2, warp % 2) of a tile from one staged
// k-slice: As[r][k] = A(r, k), Bs[c][k] = B(k, c).
__device__ __forceinline__ void mma_stage(const double (&As)[kTile][kTileLd],
                                          const double (&Bs)[kTile][kTileLd],
                                          double (&acc)[4][4][2], int wm,
                                          int wn, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kTileK; kk += 4) {
        double av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[wm + i * 8 + g][kk + t];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[wn + j * 8 + g][kk + t];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) dmma(acc[i][j], av[i], bv[j]);
    }
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
        mma_stage(As, Bs, acc, wm, wn, g, t);
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

// The output modes of gemm_xn_tile.
enum TileMode { kSet = 0, kSubtract = 1, kFromD = 2 };

// One 64 x 64 tile of C (ldc) from op(A) (64 x K) times B (K x 64,
// row-major: B(k, c) = B[k ldb + c]), K a multiple of kTileK (0 allowed):
// kSet C = op(A) B, kSubtract C -= op(A) B, kFromD C = D - op(A) B (D, ldd
// may be C itself).  op(A)(r, k) = A[r lda + k], or with kTransA
// A[k lda + r].  The stages are loaded with neighbouring threads on
// neighbouring addresses of each operand.
template <bool kTransA, int kMode>
__device__ void gemm_xn_tile(const double* A, int64_t lda, const double* B,
                             int64_t ldb, double* C, int64_t ldc, int K,
                             const double* D, int64_t ldd) {
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
            if (kTransA) {
                const int kk = idx / kTile, r = idx - kk * kTile;
                As[r][kk] = A[(int64_t)(k0 + kk) * lda + r];
            } else {
                const int r = idx / kTileK, kk = idx - r * kTileK;
                As[r][kk] = A[(int64_t)r * lda + k0 + kk];
            }
            const int kk = idx / kTile, c = idx - kk * kTile;
            Bs[c][kk] = B[(int64_t)(k0 + kk) * ldb + c];
        }
        __syncthreads();
        mma_stage(As, Bs, acc, wm, wn, g, t);
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int64_t r = wm + i * 8 + g, c = wn + j * 8 + 2 * t;
            double* p = C + r * ldc + c;
            if (kMode == kFromD) {
                const double* q = D + r * ldd + c;
                const double d0 = q[0], d1 = q[1];
                p[0] = d0 - acc[i][j][0];
                p[1] = d1 - acc[i][j][1];
            } else if (kMode == kSubtract) {
                p[0] -= acc[i][j][0];
                p[1] -= acc[i][j][1];
            } else {
                p[0] = acc[i][j][0];
                p[1] = acc[i][j][1];
            }
        }
}

// ---------------------------------------------------------------------------
// substitution steps
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

// The substitution steps are each one CTA step or one short pass over a
// panel; their time is latency.  Each loads everything that does not
// depend on the right-hand side before its first barrier, so that most of
// its loads share one round trip.  Each is a device function that a
// kernel calls with its own pointers (K7 batches the partitions of SPIKE
// over a grid dimension); the CTA's index in the panel is an argument.

// r[0:s] = inv r[0:s] (inv lower triangular), one warp per row
// (kDiagThreads threads).
__device__ __forceinline__ void fwd_diag_step(const double* __restrict__ inv,
                                              double* __restrict__ r) {
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

// rb[i] -= T[i, :] y for the rows i < rows (T's rows ldt apart), one warp
// per row, kSolveRows rows for CTA cta (kThreads threads).
__device__ __forceinline__ void fwd_panel_step(const double* __restrict__ T,
                                               int64_t ldt,
                                               const double* __restrict__ y,
                                               double* __restrict__ rb,
                                               int64_t rows, int64_t cta) {
    constexpr int s = kBlock;
    __shared__ double ys[kBlock];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    constexpr int nwarp = kThreads / 32;
    constexpr int kRows = kSolveRows / nwarp, kLane = kBlock / 32;
    const int64_t i0 = cta * kSolveRows;
    double tv[kRows][kLane], rv[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
        const int64_t i = i0 + warp + q * nwarp;
#pragma unroll
        for (int t = 0; t < kLane; ++t) {
            const int k = lane + 32 * t;
            tv[q][t] = i < rows && k < s ? T[i * ldt + k] : 0.0;
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

// partial[c] = sum over the kBwdRows rows i of group cta of T[i][c] xb[i]
// (T's rows ldt apart); thread (q, c) of the kBwdThreads / s slices takes
// the rows q modulo the slice count, and the slices are added in order.
__device__ __forceinline__ void bwd_panel_step(const double* __restrict__ T,
                                               int64_t ldt,
                                               const double* __restrict__ xb,
                                               double* __restrict__ partial,
                                               int64_t rows, int64_t cta) {
    constexpr int s = kBlock;
    __shared__ double red[kBwdThreads];
    const int tid = threadIdx.x, nq = kBwdThreads / s;
    const int q = tid / s, c = tid - q * s;
    const int64_t i0 = cta * kBwdRows;
    double acc = 0.0;
#pragma unroll
    for (int t = 0; t < kBwdRows * kBlock / kBwdThreads; ++t) {
        const int64_t i = i0 + q + (int64_t)t * nq;
        if (i < i0 + kBwdRows && i < rows) acc += T[i * ldt + c] * xb[i];
    }
    red[tid] = acc;
    __syncthreads();
    if (q == 0) {
        double v = 0.0;
        for (int h = 0; h < nq; ++h) v += red[h * s + c];
        partial[c] = v;
    }
}

// y[0:s] = inv^T (y[0:s] - sum_g partial[g]) (inv lower triangular, ng
// groups of s, none with ng = 0).  Thread (q, c) of the kDiagThreads / s
// slices sums the groups g = q mod slices, then the terms k = c + q mod
// slices of column c; the slices' sums are added in order.
__device__ __forceinline__ void bwd_diag_step(
        const double* __restrict__ inv, const double* __restrict__ partial,
        int64_t ng, double* __restrict__ y) {
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

// The steps as kernels of one panel (the band's, the dense factor's and
// SPIKE's reduced LU).  kLd > 0 fixes the panel's row stride at compile
// time (the band's panels: kLd = kBlock keeps the band solve's index
// arithmetic constant); kLd = 0 takes the run-time ldt.
__global__ void __launch_bounds__(kDiagThreads)
fwd_diag_kernel(const double* __restrict__ inv, double* __restrict__ r) {
    fwd_diag_step(inv, r);
}

template <int64_t kLd>
__global__ void __launch_bounds__(kThreads)
fwd_panel_kernel(const double* __restrict__ T, int64_t ldt,
                 const double* __restrict__ y, double* __restrict__ rb,
                 int64_t rows) {
    fwd_panel_step(T, kLd > 0 ? kLd : ldt, y, rb, rows, blockIdx.x);
}

template <int64_t kLd>
__global__ void __launch_bounds__(kBwdThreads)
bwd_panel_kernel(const double* __restrict__ T, int64_t ldt,
                 const double* __restrict__ xb, double* __restrict__ partial,
                 int64_t rows) {
    bwd_panel_step(T, kLd > 0 ? kLd : ldt, xb,
                   partial + (int64_t)blockIdx.x * kBlock, rows, blockIdx.x);
}

__global__ void __launch_bounds__(kDiagThreads)
bwd_diag_kernel(const double* __restrict__ inv,
                const double* __restrict__ partial, int64_t ng,
                double* __restrict__ y) {
    bwd_diag_step(inv, partial, ng, y);
}

}  // namespace
