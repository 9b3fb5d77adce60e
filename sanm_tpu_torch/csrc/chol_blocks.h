// What the three Cholesky solvers share: K5 (band.cu, the skyline band),
// K6 (dense_chol.cu, the dense blocked factor) and K7 (spike.cu, the SPIKE
// partitioned band).  Every one of them factors and substitutes in s x s
// blocks, s = kBlock = 128: one s x s f64 block (128 KB) fits one CTA's
// shared memory.
//
// * diag_factor_kernel: one CTA of 8 warps, the Cholesky of a diagonal
//   block and its triangular inverse (optionally writing L back in place),
//   blocked in 32 x 32 sub-blocks: one warp factors a diagonal sub-block in
//   registers and inverts it, and the sub-panels, the trailing updates and
//   the blocks of the inverse go through f64 mma.sync from shared memory
//   (23 barriers a block; the former rank-1 schedule took 256);
// * tile_nt: a 128 x 64 (updates) or 64 x 128 (panels) output tile of
//   C = A B^T or C -= A B^T per CTA of 8 warps, A and B staged through a
//   three-deep cp.async ring in dynamic shared memory, the sums in
//   registers, through the f64 mma.sync shape kTileShape; warps wholly
//   above a diagonal block's diagonal skip their work, and a deep product
//   can be subtracted one slice at a time (seg);
// * look_ahead: the two streams of the factors' look-ahead, created once
//   per device: crit runs the chain of diagonal steps, panels and narrow
//   updates, side the bulk of each trailing update beside it;
// * gemm_xn_tile: K7's 64 x 64 output tile through f64 mma.sync (m8n8k4),
//   stages loaded synchronously;
// * the substitution steps of K6c and K7c (K5c has its own persistent
//   kernels, band.cu, with the same forward arithmetic): a one-CTA step
//   with an s x s inverse (forward: r = inv r; backward: y = inv^T (y -
//   sum of partials)) and the many-CTA panel steps (forward rb -= T y;
//   backward partial column sums of T^T xb in fixed row groups, added in
//   order by the diagonal step), each with the panel's row stride as an
//   argument;
// * the permutation gather and scatter of the right-hand side.
//
// Hopper has no f64 wgmma, so every f64 product runs on mma.sync; its
// m16n8k* shapes reach the card's 67 TFLOP/s, m8n8k4 half of it
// (mma_probe.cu).  Each output element is written by one thread after
// sums in a fixed order, with no atomics, so every kernel here repeats its
// bits from run to run.
//
// Everything is in an anonymous namespace: each .cu file that includes
// this header compiles its own copy (and keeps its own streams).
#pragma once
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // gemm_xn_tile: output rows and columns
constexpr int kTileK = 16;            // gemm_xn_tile: depth per stage
constexpr int kTileLd = kTileK + 4;   // padded shared row
constexpr int kGemmThreads = 128;     // gemm_xn_tile: 4 warps of 32 x 32
constexpr int kDiagThreads = 1024;    // the substitutions' diagonal steps
constexpr int kSolveRows = 32;        // panel rows per forward CTA
constexpr int kBwdThreads = 256;      // backward panel step
constexpr int kBwdRows = 64;          // panel rows per backward CTA
// The block size s of every kernel.  BandPlan.s, DensePlan.s and
// SpikePlan.s must equal it (the wrappers in sanm_tpu_torch/solver check).
constexpr int kBlock = 128;
// the diagonal step and the product tiles: 8 warps
constexpr int kFactorThreads = 256;
constexpr int kFactorWarps = kFactorThreads / 32;
constexpr int kSub = 32;              // sub-block of the diagonal step
constexpr int kNSub = kBlock / kSub;
// A shared row of kBlock + 4 doubles: a fragment load of mma.sync (row g
// + column t, g < 8, t < 4) then hits 16 distinct 8-byte banks in each
// half-warp (ld = 4 mod 16), also for the transposed operand (t ld + g).
constexpr int kDiagLd = kBlock + 4;
constexpr int kTK = 16;               // tile_nt: depth of one stage
constexpr int kMaxDevices = 16;

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

// dynamic shared memory of diag_factor_kernel: the block and the
// reciprocals of L's diagonal
inline size_t diag_smem_bytes() {
    return ((size_t)kBlock * kDiagLd + kBlock) * sizeof(double);
}

// dynamic shared memory of tile_nt<BM, BN, WM, kStages, ..., KT>
template <int BM, int BN, int kStages, int KT = kTK>
constexpr size_t tile_smem_bytes() {
    return (size_t)kStages * (BM + BN) * (KT + 4) * sizeof(double);
}

__device__ __forceinline__ void cp_async16(double* smem, const double* g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// f64 mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(d[0]), "+d"(d[1])
        : "d"(a), "d"(b));
}

// The f64 shapes of mma.sync on sm_90: m8n8k4 (also sm_80) and m16n8k4,
// k8, k16.  NA, NB, NC: a thread's values of A, B and C.
enum MmaShape { kM8N8K4 = 0, kM16N8K4 = 1, kM16N8K8 = 2, kM16N8K16 = 3 };
template <int S> struct Mma;
template <> struct Mma<kM8N8K4> {
    static constexpr int M = 8, N = 8, K = 4, NA = 1, NB = 1, NC = 2;
};
template <> struct Mma<kM16N8K4> {
    static constexpr int M = 16, N = 8, K = 4, NA = 2, NB = 1, NC = 4;
};
template <> struct Mma<kM16N8K8> {
    static constexpr int M = 16, N = 8, K = 8, NA = 4, NB = 2, NC = 4;
};
template <> struct Mma<kM16N8K16> {
    static constexpr int M = 16, N = 8, K = 16, NA = 8, NB = 4, NC = 4;
};

// The shape of tile_nt's products (measured against the others on the
// card by sanm_mma_rate and sanm_tile_probe, csrc/mma_probe.cu).
constexpr int kTileShape = kM16N8K8;

// Where value q of a thread's fragment sits (g = lane / 4, t = lane % 4;
// the PTX ISA's fragment layouts): A (M x K) at row frag_a_row, column
// frag_a_col; B (K x N) at row frag_b_k, column g; C (M x N) at row
// frag_c_row, column frag_c_col.
template <int S>
__device__ __forceinline__ int frag_a_row(int q, int g) {
    return g + (Mma<S>::M == 16 ? 8 * (q & 1) : 0);
}
__device__ __forceinline__ int frag_a_col(int q, int t) {
    return t + 4 * (q >> 1);
}
__device__ __forceinline__ int frag_b_k(int q, int t) { return t + 4 * q; }
__device__ __forceinline__ int frag_c_row(int q, int g) {
    return g + 8 * (q >> 1);
}
__device__ __forceinline__ int frag_c_col(int q, int t) {
    return 2 * t + (q & 1);
}

template <int S>
__device__ __forceinline__ void mma_f64(double (&d)[Mma<S>::NC],
                                        const double (&a)[Mma<S>::NA],
                                        const double (&b)[Mma<S>::NB]);

template <>
__device__ __forceinline__ void mma_f64<kM8N8K4>(double (&d)[2],
                                                 const double (&a)[1],
                                                 const double (&b)[1]) {
    dmma(d, a[0], b[0]);
}

template <>
__device__ __forceinline__ void mma_f64<kM16N8K4>(double (&d)[4],
                                                  const double (&a)[2],
                                                  const double (&b)[1]) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(b[0]));
}

template <>
__device__ __forceinline__ void mma_f64<kM16N8K8>(double (&d)[4],
                                                  const double (&a)[4],
                                                  const double (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]),
          "d"(b[1]));
}

template <>
__device__ __forceinline__ void mma_f64<kM16N8K16>(double (&d)[4],
                                                   const double (&a)[8],
                                                   const double (&b)[4]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]),
          "d"(b[3]));
}

// ---------------------------------------------------------------------------
// the diagonal block
// ---------------------------------------------------------------------------

// acc (MI x NJ tiles of 16 x 8, a warp) += P op(Q) over K = kSub through
// mma.sync m16n8k8: P is MI 16 rows of kSub values; op(Q) (kSub x NJ 8) is
// Q^T with Q NJ 8 rows of kSub values (kTransQ), or Q itself, kSub rows of
// NJ 8 values.  All row-major in shared memory with row stride kDiagLd.
constexpr int kDiagShape = kM16N8K8;
template <int MI, int NJ, bool kTransQ>
__device__ __forceinline__ void warp_mma(const double* P, const double* Q,
                                         double (&acc)[MI][NJ][4]) {
    using T = Mma<kDiagShape>;
    constexpr int ld = kDiagLd;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < kSub; k += T::K) {
        double af[MI][T::NA], bf[NJ][T::NB];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < T::NA; ++q)
                af[i][q] = P[(i * 16 + frag_a_row<kDiagShape>(q, g)) * ld + k +
                             frag_a_col(q, t)];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < T::NB; ++q)
                bf[j][q] = kTransQ ? Q[(j * 8 + g) * ld + k + frag_b_k(q, t)]
                                   : Q[(k + frag_b_k(q, t)) * ld + j * 8 + g];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                mma_f64<kDiagShape>(acc[i][j], af[i], bf[j]);
    }
}

// The output modes of warp_put and tile_nt.
enum TileMode { kSet = 0, kSubtract = 1, kFromD = 2, kNegate = 3 };

template <int MI, int NJ>
__device__ __forceinline__ void warp_zero(double (&acc)[MI][NJ][4]) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0;
}

// C (row stride ld) = acc (kSet), -= acc (kSubtract) or = -acc (kNegate).
template <int kMode, int MI, int NJ>
__device__ __forceinline__ void warp_put(double* C, int64_t ld,
                                         const double (&acc)[MI][NJ][4]) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                double* p = C + (i * 16 + frag_c_row(q, g)) * ld + j * 8 +
                            frag_c_col(q, t);
                if (kMode == kSubtract)
                    *p -= acc[i][j][q];
                else if (kMode == kNegate)
                    *p = -acc[i][j][q];
                else
                    *p = acc[i][j][q];
            }
}

// Cholesky of the kSub x kSub sub-block at S (lower triangle read) by one
// warp, lane r holding row r in registers, right-looking: step c takes the
// pivot from lane c, scales column c by its reciprocal root and subtracts
// l_rc l_jc from every later column j (l_jc shuffled from lane j).  Lane
// c+1 forms the next pivot from its own l value before the shuffles (the
// update's fma, so the same bits).  Lanes above the diagonal zero their
// column c before it is used, so nothing read above the diagonal reaches
// L.  L's lower triangle goes back to S (and with kWriteL to gS, row
// stride ldg), 1 / L[c][c] to rd[c].  A negative pivot gives rsqrt < 0 =
// NaN (a zero one 0 inf = NaN), which propagates: never a clamp.
template <bool kWriteL>
__device__ __forceinline__ void warp_chol(double* S, double* rd, double* gS,
                                          int64_t ldg) {
    const int r = threadIdx.x & 31;
    double a[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) a[j] = S[r * kDiagLd + j];
    double pn = a[0];
#pragma unroll
    for (int c = 0; c < kSub; ++c) {
        const double piv = __shfl_sync(0xffffffffu, pn, c);
        const double rp = rsqrt(piv);
        a[c] = r > c ? a[c] * rp : (r == c ? piv * rp : 0.0);
        if (r == c) rd[c] = rp;
        if (c + 1 < kSub) pn = fma(-a[c], a[c], a[c + 1]);
#pragma unroll
        for (int j = c + 1; j < kSub; ++j)
            a[j] = fma(-a[c], __shfl_sync(0xffffffffu, a[c], j), a[j]);
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
        if (j <= r) {
            S[r * kDiagLd + j] = a[j];
            if (kWriteL) gS[r * ldg + j] = a[j];
        }
    }
}

// X = L^-1 of the kSub x kSub lower triangle at S by one warp, lane k
// forming column k right-looking (x_i = (e_k - sum_{j<i} L_ij x_j) / L_ii,
// each x_i then added into the later rows' sums); X (exact zeros above
// the diagonal, also when a reciprocal is NaN) is written over S.
__device__ __forceinline__ void warp_trinv(double* S, const double* rd) {
    const int k = threadIdx.x & 31;
    double x[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) x[i] = 0.0;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
        x[i] = ((i == k ? 1.0 : 0.0) - x[i]) * rd[i];
#pragma unroll
        for (int m = i + 1; m < kSub; ++m)
            x[m] = fma(S[m * kDiagLd + i], x[i], x[m]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kSub; ++i) S[i * kDiagLd + k] = i >= k ? x[i] : 0.0;
}

// Cholesky of the s x s block at (row0, col0) of a (lower triangle read)
// and its inverse, written to inv (s x s, row-major, zero above the
// diagonal); with kWriteL also L's lower triangle back into a (the upper
// half of the block is left as it was).  One CTA of kFactorThreads, the
// block in shared memory (row stride kDiagLd), in kSub x kSub sub-blocks
// (i, k), i >= k:
// 1. for k = 0 .. kNSub-1: warp 0 factors sub-block (k, k) in registers
//    (warp_chol) and writes X_kk = L_kk^-1 over it (warp_trinv); the
//    sub-panel below becomes L_ik = A_ik X_kk^T (a warp per 16 rows, in
//    place); the trailing sub-blocks (i, j), k < j <= i, lose L_ik L_jk^T
//    (a warp per 16 x 16 quarter, the quarter above a diagonal
//    sub-block's diagonal skipped);
// 2. X = L^-1 by block rows, in place of L: row i's T_ik = sum_{j=k}^{i-1}
//    L_ij X_jk (k < i) replaces L_ik once every L_ij of the row is read,
//    then X_ik = -X_ii T_ik;
// 3. inv from X's lower triangle.
// Every product is f64 mma.sync m16n8k8 (kDiagShape) from shared memory.
// The chain that bounds it is the 128 pivots (a shuffle, a reciprocal
// root and an fma each) on one warp; the 2 s^3 / 3 = 1.4 MFLOP of the
// block take ~3 us of one SM's tensor cores.  warp_chol and warp_trinv
// are unrolled (~3,500 instructions) and inlined at one call site: a
// pass from cold instruction caches takes a few times a warm one (clock
// stamps on the card), so a second call site cost more than it saved;
// rolled loops, which do every update of a full row each step, measured
// slower.  A negative pivot gives NaN (warp_chol),
// which reaches the rest of the block through the products and, through
// the panels, every later block of the factor.
template <bool kWriteL>
__global__ void __launch_bounds__(kFactorThreads, 1)
diag_factor_kernel(double* a, int64_t lda, int64_t row0, int64_t col0,
                   double* __restrict__ inv) {
    constexpr int s = kBlock, ld = kDiagLd, b = kSub;
    extern __shared__ __align__(16) double diag_sm[];
    double* A = diag_sm;
    double* rd = diag_sm + s * ld;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    double* gA = a + row0 * lda + col0;
    auto blk = [&](int i, int k) { return A + i * b * ld + k * b; };

    // the lower triangle, in 16-byte pieces, all in flight at once
    for (int idx = tid; idx < s * (s / 2); idx += kFactorThreads) {
        const int r = idx / (s / 2), c = 2 * (idx % (s / 2));
        if (c <= r) cp_async16(A + r * ld + c, gA + (int64_t)r * lda + c);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    for (int k = 0; k < kNSub; ++k) {
        double* Akk = blk(k, k);
        if (warp == 0) {
            warp_chol<kWriteL>(Akk, rd + k * b,
                               gA + (int64_t)k * b * (lda + 1), lda);
            __syncwarp();
            warp_trinv(Akk, rd + k * b);
        }
        __syncthreads();
        const int m = kNSub - 1 - k;  // sub-blocks below
        if (m == 0) break;
        // L_ik = A_ik X_kk^T: a warp per 16 rows, which it reads whole
        // before it writes them
        for (int u = warp; u < 2 * m; u += kFactorWarps) {
            double* P = A + ((k + 1) * b + u * 16) * ld + k * b;
            double acc[1][4][4];
            warp_zero(acc);
            warp_mma<1, 4, true>(P, Akk, acc);
            __syncwarp();
            warp_put<kSet>(P, ld, acc);
        }
        __syncthreads();
        // A_ij -= L_ik L_jk^T, k < j <= i, by 16 x 16 quarters
        for (int u = warp; u < 2 * m * (m + 1); u += kFactorWarps) {
            const int pr = u >> 2, q = u & 3;
            const int ii = pr >= 3 ? 2 : (pr >= 1 ? 1 : 0);
            const int jj = pr - ii * (ii + 1) / 2;
            const int qr = q >> 1, qc = q & 1;
            if (ii == jj && qc > qr) continue;
            const int i = k + 1 + ii, j = k + 1 + jj;
            double acc[1][2][4];
            warp_zero(acc);
            warp_mma<1, 2, true>(blk(i, k) + qr * 16 * ld,
                                 blk(j, k) + qc * 16 * ld, acc);
            warp_put<kSubtract>(blk(i, j) + qr * 16 * ld + qc * 16, ld, acc);
        }
        __syncthreads();
    }

    // L's subdiagonal sub-blocks out before X replaces them: a warp per
    // row, in pairs
    if (kWriteL) {
        for (int r = b + warp; r < s; r += kFactorWarps)
            for (int c = 2 * lane; c < (r / b) * b; c += 64)
                *reinterpret_cast<double2*>(gA + (int64_t)r * lda + c) =
                    *reinterpret_cast<const double2*>(A + r * ld + c);
    }
    // X by block rows; a warp holds at most two 16 x 16 quarters of a row
    for (int i = 1; i < kNSub; ++i) {
        double acc[2][1][2][4];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            warp_zero(acc[v]);
            const int u = warp + v * kFactorWarps;
            if (u < 4 * i) {
                const int k = u >> 2, qr = (u >> 1) & 1, qc = u & 1;
                for (int j = k; j < i; ++j)
                    warp_mma<1, 2, false>(blk(i, j) + qr * 16 * ld,
                                          blk(j, k) + qc * 16, acc[v]);
            }
        }
        __syncthreads();  // every L_ij of row i read
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            const int u = warp + v * kFactorWarps;
            if (u < 4 * i)
                warp_put<kSet>(blk(i, u >> 2) + ((u >> 1) & 1) * 16 * ld +
                                   (u & 1) * 16, ld, acc[v]);
        }
        __syncthreads();
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            warp_zero(acc[v]);
            const int u = warp + v * kFactorWarps;
            if (u < 4 * i) {
                const int k = u >> 2, qr = (u >> 1) & 1, qc = u & 1;
                warp_mma<1, 2, false>(blk(i, i) + qr * 16 * ld,
                                      blk(i, k) + qc * 16, acc[v]);
            }
        }
        __syncthreads();  // every T_ik read
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            const int u = warp + v * kFactorWarps;
            if (u < 4 * i)
                warp_put<kNegate>(blk(i, u >> 2) + ((u >> 1) & 1) * 16 * ld +
                                      (u & 1) * 16, ld, acc[v]);
        }
        __syncthreads();
    }
    for (int idx = tid; idx < s * (s / 2); idx += kFactorThreads) {
        const int r = idx / (s / 2), c = 2 * (idx % (s / 2));
        double2 v;
        v.x = c <= r ? A[r * ld + c] : 0.0;
        v.y = c + 1 <= r ? A[r * ld + c + 1] : 0.0;
        *reinterpret_cast<double2*>(inv + r * s + c) = v;
    }
}

// ---------------------------------------------------------------------------
// the product tile of the factors' panels and trailing updates
// ---------------------------------------------------------------------------

// One stage (KT deep) of a warp's WM x 32 part of the tile through
// mma.sync shape S: as holds the warp's A rows (row stride KT + 4: ld = 4
// mod 16 for KT = 16 or 32), bs its B rows, both k-contiguous.
template <int S, int WM, int KT>
__device__ __forceinline__ void tile_stage(
        const double* as, const double* bs,
        double (&acc)[WM / Mma<S>::M][4][Mma<S>::NC]) {
    using T = Mma<S>;
    constexpr int MI = WM / T::M, kTLd = KT + 4;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < KT; kk += T::K) {
        double af[MI][T::NA], bf[4][T::NB];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < T::NA; ++q)
                af[i][q] = as[(i * T::M + frag_a_row<S>(q, g)) * kTLd + kk +
                              frag_a_col(q, t)];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int q = 0; q < T::NB; ++q)
                bf[j][q] = bs[(j * 8 + g) * kTLd + kk + frag_b_k(q, t)];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_f64<S>(acc[i][j], af[i], bf[j]);
    }
}

// One BM x BN tile per CTA of kT threads: C = A B^T (kSet) or C -= A
// B^T (kSubtract), A BM rows and B BN rows of K values each (K a multiple
// of the stage depth KT; rows lda, ldb apart, 16-byte aligned), C's rows
// ldc apart; C may
// be A itself (every stage is read before the first store).  The kT / 32
// warps each own a WM x 32 part.  A and B pass through a kStages-deep ring of
// cp.async stages in dynamic shared memory (tile_smem_bytes): stage kt +
// kStages - 1 is in flight while stage kt is multiplied.  The epilogue
// reads a warp's C values of kEpi m-slabs at once before it stores them.
// diag_col >= 0 says the tile lies in a diagonal block of the factor at
// that column offset: a warp whose part lies wholly above the block's
// diagonal skips its products and its stores.  b_lower says B is lower
// triangular (an inverse diagonal block): a warp skips the stages past
// its last column.  seg > 0 (a multiple of KT dividing K, kSubtract)
// subtracts the product of each seg-deep slice of the depth from C in
// turn, C = (C - A_1 B_1^T) - A_2 B_2^T ...: the rounding of one pass per
// slice, from one pass over the stages (C's round trip between the slices
// stays in L2).  Every output element is written by one thread, after a
// fixed sequence of products.
template <int BM, int BN, int WM, int kStages, int kMode,
          int S = kTileShape, int kT = kFactorThreads, int KT = kTK>
__device__ __forceinline__ void tile_nt(const double* A, int64_t lda,
                                        const double* B, int64_t ldb,
                                        double* C, int64_t ldc, int K,
                                        int diag_col, bool b_lower,
                                        int seg = 0) {
    using T = Mma<S>;
    constexpr int kTLd = KT + 4;
    constexpr int MI = WM / T::M, kWN = BN / 32;
    constexpr int kEpi = MI >= 4 ? 2 : 1;
    static_assert((BM / WM) * kWN == kT / 32, "kT / 32 warps of WM x 32");
    extern __shared__ __align__(16) double tile_sm[];
    double* As = tile_sm;
    double* Bs = tile_sm + kStages * BM * kTLd;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm0 = (warp / kWN) * WM, wn0 = (warp % kWN) * 32;
    const bool idle = diag_col >= 0 && wn0 + diag_col > wm0 + WM - 1;
    const int nk = K / KT;

    auto load = [&](int kt) {
        if (kt < nk) {
            double* as = As + (kt % kStages) * BM * kTLd;
            double* bs = Bs + (kt % kStages) * BN * kTLd;
            const int k0 = kt * KT;
#pragma unroll
            for (int c = tid; c < (BM + BN) * (KT / 2); c += kT) {
                const int r = c / (KT / 2), q = 2 * (c % (KT / 2));
                if (r < BM)
                    cp_async16(as + r * kTLd + q, A + r * lda + k0 + q);
                else
                    cp_async16(bs + (r - BM) * kTLd + q,
                               B + (r - BM) * ldb + k0 + q);
            }
        }
        cp_async_commit();  // an empty group past the end keeps the count
    };

    double acc[MI][4][T::NC];
    auto zero = [&]() {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int q = 0; q < T::NC; ++q) acc[i][j][q] = 0.0;
    };
    const int g = lane >> 2, t = lane & 3;
    // C (op)= acc, the C values of kEpi m-slabs read before any is stored
    auto put = [&]() {
#pragma unroll
        for (int i0 = 0; i0 < MI; i0 += kEpi) {
            double2 v[kEpi][4][T::NC / 2];
#pragma unroll
            for (int i = 0; i < kEpi; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int h = 0; h < T::NC / 2; ++h) {
                        const int64_t r =
                            wm0 + (i0 + i) * T::M + frag_c_row(2 * h, g);
                        const int64_t c = wn0 + j * 8 + frag_c_col(2 * h, t);
                        if (kMode == kSubtract)
                            v[i][j][h] = *reinterpret_cast<const double2*>(
                                C + r * ldc + c);
                    }
#pragma unroll
            for (int i = 0; i < kEpi; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int h = 0; h < T::NC / 2; ++h) {
                        const int64_t r =
                            wm0 + (i0 + i) * T::M + frag_c_row(2 * h, g);
                        const int64_t c = wn0 + j * 8 + frag_c_col(2 * h, t);
                        const double* a2 = acc[i0 + i][j] + 2 * h;
                        double2 w;
                        if (kMode == kSubtract) {
                            w.x = v[i][j][h].x - a2[0];
                            w.y = v[i][j][h].y - a2[1];
                        } else {
                            w.x = a2[0];
                            w.y = a2[1];
                        }
                        *reinterpret_cast<double2*>(C + r * ldc + c) = w;
                    }
        }
    };

    zero();
    const int seg_k = seg > 0 ? seg / KT : nk;
#pragma unroll
    for (int kt = 0; kt < kStages - 1; ++kt) load(kt);
    for (int kt = 0; kt < nk; ++kt) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // stage kt landed; stage kt - 1 is free
        load(kt + kStages - 1);
        if (!idle && !(b_lower && kt * KT > wn0 + 31))
            tile_stage<S, WM, KT>(As + (kt % kStages) * BM * kTLd + wm0 * kTLd,
                                  Bs + (kt % kStages) * BN * kTLd + wn0 * kTLd,
                                  acc);
        if (!idle && (kt + 1) % seg_k == 0 && kt + 1 < nk) {
            put();
            zero();
        }
    }
    if (!idle) put();
}

// ---------------------------------------------------------------------------
// the look-ahead of the factors
// ---------------------------------------------------------------------------

// The factors fork from the caller's stream into two of their own and join
// it again at the end, so that a call stays ordered on that stream (and
// can be captured in a CUDA graph): crit, at the card's greatest stream
// priority, runs the chain of diagonal steps, panels and narrow updates;
// side, at the least, the bulk of each trailing update beside it.  ready
// passes a finished panel from crit to side, done a finished bulk update
// from side to crit.  Created once per device (under a lock), with the
// caller's set-up (the kernels' shared-memory attributes).
struct LookAhead {
    cudaStream_t crit, side;
    cudaEvent_t fork, ready, done;
};

inline cudaError_t look_ahead(LookAhead** out, cudaError_t (*setup)()) {
    static std::mutex mu;
    static LookAhead la[kMaxDevices];
    static bool made[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu);
    if (!made[dev]) {
        LookAhead& l = la[dev];
        int least = 0, greatest = 0;
        if ((err = setup()) != cudaSuccess ||
            (err = cudaDeviceGetStreamPriorityRange(&least, &greatest)) !=
                cudaSuccess ||
            (err = cudaStreamCreateWithPriority(
                 &l.crit, cudaStreamNonBlocking, greatest)) != cudaSuccess ||
            (err = cudaStreamCreateWithPriority(
                 &l.side, cudaStreamNonBlocking, least)) != cudaSuccess)
            return err;
        for (cudaEvent_t* e : {&l.fork, &l.ready, &l.done})
            if ((err = cudaEventCreateWithFlags(
                     e, cudaEventDisableTiming)) != cudaSuccess)
                return err;
        made[dev] = true;
    }
    *out = &la[dev];
    return cudaSuccess;
}

// `to` waits for what `from` has been given so far.
inline cudaError_t hand_over(cudaEvent_t e, cudaStream_t from,
                             cudaStream_t to) {
    cudaError_t err = cudaEventRecord(e, from);
    return err != cudaSuccess ? err : cudaStreamWaitEvent(to, e, 0);
}

inline cudaError_t fork_from(const LookAhead* l, cudaStream_t st) {
    cudaError_t err = hand_over(l->fork, st, l->crit);
    return err != cudaSuccess ? err : cudaStreamWaitEvent(l->side, l->fork, 0);
}

inline cudaError_t join_into(const LookAhead* l, cudaStream_t st) {
    cudaError_t err = hand_over(l->ready, l->crit, st);
    return err != cudaSuccess ? err : hand_over(l->done, l->side, st);
}

// ---------------------------------------------------------------------------
// K7's 64 x 64 product tile
// ---------------------------------------------------------------------------

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

// The steps as kernels of one panel (the dense factor's and SPIKE's
// reduced LU), with the panel's row stride ldt.
__global__ void __launch_bounds__(kDiagThreads)
fwd_diag_kernel(const double* __restrict__ inv, double* __restrict__ r) {
    fwd_diag_step(inv, r);
}

__global__ void __launch_bounds__(kThreads)
fwd_panel_kernel(const double* __restrict__ T, int64_t ldt,
                 const double* __restrict__ y, double* __restrict__ rb,
                 int64_t rows) {
    fwd_panel_step(T, ldt, y, rb, rows, blockIdx.x);
}

__global__ void __launch_bounds__(kBwdThreads)
bwd_panel_kernel(const double* __restrict__ T, int64_t ldt,
                 const double* __restrict__ xb, double* __restrict__ partial,
                 int64_t rows) {
    bwd_panel_step(T, ldt, xb, partial + (int64_t)blockIdx.x * kBlock, rows,
                   blockIdx.x);
}

__global__ void __launch_bounds__(kDiagThreads)
bwd_diag_kernel(const double* __restrict__ inv,
                const double* __restrict__ partial, int64_t ng,
                double* __restrict__ y) {
    bwd_diag_step(inv, partial, ng, y);
}

}  // namespace
