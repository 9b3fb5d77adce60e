// K5: the skyline band Cholesky, the sparse direct solve on the card.
//
// Replaces sanm_tpu/solver/band.py: assemble_band_scaled_neg (:225) as
// sanm_band_assemble, band_cholesky (:247) as sanm_band_factor, and
// band_tri_solve + band_tri_solve_fn (:321-385) as sanm_band_solve.  The
// JAX package runs them in f32 on the TPU's matrix unit, one lax.scan per
// run of equal-width block columns; here everything is f64 and every
// block column runs at its own skyline reach w_j (arrays blk_w and
// panel_off of sanm_tpu_torch/solver/band.py BandPlan: host arrays for the
// factor, device arrays for the solve).
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
// The solve is two persistent kernels, the forward and the backward
// substitution, one launch each, whose CTAs (one per SM: the 128 KB
// inverse fills most of its shared memory) take block rows (forward,
// ascending) or block columns (backward, descending) by ticket from an
// atomic counter.  A CTA waits only on items of smaller tickets, held by
// CTAs already running, so any grid completes.  Results pass between CTAs
// through device memory, each value published as two 64-bit words that
// carry half of it and a ready mark (the LL protocol of NCCL): an aligned
// 64-bit store is seen whole or not at all, so the consumer's warp 0
// polls the 128 values it needs and has them when the last arrives, and
// the producer stores without a fence.  Every wait gives up after 1 s
// (globaltimer) and sets an error word that stops every CTA, of this call
// and of any later one on the same word; the wrapper raises (band_solve
// when it owns the word, DeviceBandCholSolver once a solve).  One memset
// on the stream zeroes the tickets and the published words, so the launch
// can be captured in a CUDA graph.
// Everything that does not depend on the right-hand side is loaded before
// a wait: the item's inverse (cp.async into shared memory) at its start,
// and each block of the factor into registers before the wait on the
// result it multiplies.
// * Forward, block row i: r_i -= L[i,j] y_j for j = row_lo[i] .. i-1 in
//   ascending order with fwd_panel_step's lane split (a warp's 8 rows
//   reduced together, warp_sum's pairings), then y_i = inv(L_ii) r_i as
//   fwd_diag_step forms it: the same operations in the same order as the
//   former kernels per column, so y has their bits.
// * Backward, block column j: thread (q, c) sums L[j+1+m, j][k][c] x[k]
//   over the rows k = q mod 4 of the blocks m = w_j-1 .. 0 as each
//   x_{j+1+m} is published, so only block j+1's is left when x_{j+1}
//   arrives; x_j = inv^T (y_j - the four slices' sums in slice order).
// The critical path per block column and direction is the poll that sees
// the last value, the product of one block already in registers, the 128
// x 128 diagonal product from shared memory and the stores; the panels'
// reads, 0.86 GB each way at armadillo-small, run beside that chain on the
// other CTAs.  The former design, a host loop of one-CTA diagonal and
// many-CTA panel kernels per column (~1,190 launches a solve), took 4.76
// ms in a CUDA graph there: each of those kernels was a chain of global
// round trips of its own.
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

// ---------------------------------------------------------------------------
// K5c band_solve: one persistent kernel per substitution
// ---------------------------------------------------------------------------

constexpr int kSubThreads = 512;
constexpr int kSubWarps = kSubThreads / 32;
constexpr int kSubRows = kBlock / kSubWarps;      // forward: rows of a warp
constexpr int kSubLane = kBlock / 32;             // values of a lane
constexpr int kSubSlices = kSubThreads / kBlock;  // backward: row slices
constexpr int kSubTerms = kBlock / kSubSlices;    // backward: rows of a slice
// The words of one call, all zeroed by the entry point: int32 ticket
// counters of the two kernels, then from byte kSubHeader the published
// results, forward (y) then backward (x), two 64-bit words per value:
// (1 << 32) | its low half, (1 << 32) | its high half.  An aligned 64-bit
// store is seen whole or not at all, so a word whose upper half reads 1
// carries its half of the value: a consumer polls the results
// themselves, and a producer needs no fence.
constexpr int kSubTicketFwd = 0, kSubTicketBwd = 1;
constexpr int kSubHeader = 16;
// a wait longer than this is a fault: the error word (the caller's, not
// zeroed here, so that it outlives the call) is set to 1 and every CTA of
// this and any later call on it returns
constexpr unsigned long long kSpinNs = 1000000000ull;

inline size_t sub_smem_bytes() {
    return ((size_t)kBlock * kBlock + 2 * kBlock + kSubThreads) *
           sizeof(double);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                 : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
                 :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void cp_async16(double* smem, const double* g) {
    const unsigned a = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// The block's inverse (s x s, 128 KB) into shared memory, asynchronously:
// it lands while the CTA waits on its dependencies.
__device__ __forceinline__ void load_inv_async(double* inv,
                                               const double* P) {
    for (int c = threadIdx.x; c < kBlock * kBlock / 2; c += kSubThreads)
        cp_async16(inv + 2 * c, P + 2 * c);
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// Publish value v of row g (no fence: each word is whole).
__device__ __forceinline__ void publish(unsigned long long* res, int64_t g,
                                        double v) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(v);
    st_relaxed(res + 2 * g, (1ull << 32) | (b & 0xffffffffull));
    st_relaxed(res + 2 * g + 1, (1ull << 32) | (b >> 32));
}

// Warp 0 polls the s published values from row g0 until all are there,
// into vals (shared); then the CTA passes a barrier.  false for every
// thread when the wait failed: another CTA set the error word, or this
// one waited kSpinNs and set it.
__device__ bool wait_block(const unsigned long long* res, int64_t g0,
                           double* vals, int* err, int* ok_s) {
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        const unsigned long long* w = res + 2 * (g0 + lane);
        double v[kSubLane];
        unsigned pending = (1u << kSubLane) - 1;
        int ok = 1;
        unsigned long long t0 = 0;
        for (int it = 0;; ++it) {
#pragma unroll
            for (int t = 0; t < kSubLane; ++t) {
                if (pending >> t & 1u) {
                    const unsigned long long lo = ld_relaxed(w + 64 * t);
                    const unsigned long long hi = ld_relaxed(w + 64 * t + 1);
                    if ((lo >> 32) == 1ull && (hi >> 32) == 1ull) {
                        v[t] = __longlong_as_double((long long)(
                            (hi << 32) | (lo & 0xffffffffull)));
                        pending &= ~(1u << t);
                    }
                }
            }
            if (__all_sync(0xffffffffu, pending == 0)) break;
            if (lane == 0) {
                if (it == 0) {
                    t0 = global_ns();
                } else if (ld_acquire(err) != 0) {
                    ok = 0;
                } else if (global_ns() - t0 > kSpinNs) {
                    atomicExch(err, 1);
                    ok = 0;
                }
            }
            if (!__shfl_sync(0xffffffffu, ok, 0)) {
                ok = 0;
                break;
            }
        }
        if (ok) {
#pragma unroll
            for (int t = 0; t < kSubLane; ++t) vals[lane + 32 * t] = v[t];
        }
        if (lane == 0) *ok_s = ok;
    }
    __syncthreads();
    return *ok_s != 0;
}

// The sums over a warp of the partials a[q] of its kSubRows = 8 rows,
// row q's sum returned in the lanes l with (l >> 2) & 7 == q.  Each
// pairing is warp_sum's (the butterfly of xor 16, 8, 4, 2, 1, own value
// plus partner's), so every sum has warp_sum's bits; the first three
// levels pass on only the half of the remaining rows that the partner
// keeps, 9 shuffles for the 8 rows instead of 40.
__device__ __forceinline__ double warp_sum8(const double (&a)[kSubRows],
                                            int lane) {
    static_assert(kSubRows == 8, "warp_sum8 reduces 8 rows");
    const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
    double b[4], c[2];
#pragma unroll
    for (int q = 0; q < 4; ++q)
        b[q] = (h4 ? a[q + 4] : a[q]) +
               __shfl_xor_sync(0xffffffffu, h4 ? a[q] : a[q + 4], 16);
#pragma unroll
    for (int q = 0; q < 2; ++q)
        c[q] = (h3 ? b[q + 2] : b[q]) +
               __shfl_xor_sync(0xffffffffu, h3 ? b[q] : b[q + 2], 8);
    double v = (h2 ? c[1] : c[0]) +
               __shfl_xor_sync(0xffffffffu, h2 ? c[0] : c[1], 4);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v;
}

// The next work item from a ticket counter (nb once there is none, or
// after an error), the same for every thread of the CTA.
__device__ int64_t next_item(int* sync, int ticket, const int* err,
                             int64_t nb, int* item_s) {
    if (threadIdx.x == 0)
        *item_s = ld_acquire(err) != 0 ? (int)nb
                                       : atomicAdd(sync + ticket, 1);
    __syncthreads();
    return *item_s;
}

// Forward substitution, one work item per block row i, taken by ticket in
// ascending order: a CTA waits only on rows of smaller tickets, which
// running CTAs hold, so any grid size completes.  Row i starts from the
// permuted right-hand side (pad rows zero), subtracts block (i, j) of the
// factor times y_j for its columns j = row_lo[i] .. i-1 in ascending order
// (the same lane split and sums as fwd_panel_step), then
// forms y_i = inv(L_ii) r_i from shared memory as fwd_diag_step does, and
// publishes it.  The warp's 8 rows are reduced together (warp_sum8).
// Each block is loaded into registers before the wait on its y_j.
__global__ void __launch_bounds__(kSubThreads, 1)
band_fwd_kernel(const double* __restrict__ panels,
                const int64_t* __restrict__ panel_off,
                const int32_t* __restrict__ row_lo,
                const int32_t* __restrict__ perm,
                const double* __restrict__ rhs, double* __restrict__ work,
                int* sync, int* err, int64_t n, int64_t nb) {
    constexpr int s = kBlock;
    extern __shared__ __align__(16) double sub_sm[];
    double* inv = sub_sm;
    double* ys = sub_sm + s * s;
    double* rs = ys + s;
    __shared__ int item_s, ok_s;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // this lane's row of the warp's kSubRows (warp_sum8's), and whether
    // it is the one of the row's four lanes that stores
    const int row = warp * kSubRows + ((lane >> 2) & 7);
    const bool owner = (lane & 3) == 0;
    unsigned long long* res = reinterpret_cast<unsigned long long*>(
        reinterpret_cast<char*>(sync) + kSubHeader);
    for (;;) {
        const int64_t i = next_item(sync, kSubTicketFwd, err, nb, &item_s);
        if (i >= nb) return;
        load_inv_async(inv, panels + panel_off[i]);
        const int32_t p = perm[i * s + row];
        double rv = p < n ? rhs[p] : 0.0;
        for (int64_t j = row_lo[i]; j < i; ++j) {
            // block (i, j): panel j's subdiagonal block i - j - 1
            const double* T = panels + panel_off[j] + (i - j) * (s * s);
            double tv[kSubRows][kSubLane];
#pragma unroll
            for (int q = 0; q < kSubRows; ++q)
#pragma unroll
                for (int t = 0; t < kSubLane; ++t)
                    tv[q][t] = T[(warp * kSubRows + q) * s + lane + 32 * t];
            if (!wait_block(res, j * s, ys, err, &ok_s)) return;
            double acc[kSubRows];
#pragma unroll
            for (int q = 0; q < kSubRows; ++q) {
                acc[q] = 0.0;
#pragma unroll
                for (int t = 0; t < kSubLane; ++t)
                    acc[q] += tv[q][t] * ys[lane + 32 * t];
            }
            rv = rv - warp_sum8(acc, lane);
            __syncthreads();
        }
        if (owner) rs[row] = rv;
        cp_async_wait_all();
        __syncthreads();
        double acc[kSubRows];
#pragma unroll
        for (int q = 0; q < kSubRows; ++q) {
            const int r = warp * kSubRows + q;
            acc[q] = 0.0;
#pragma unroll
            for (int t = 0; t < kSubLane; ++t) {
                const int k = lane + 32 * t;
                acc[q] += (k <= r ? inv[r * s + k] : 0.0) * rs[k];
            }
        }
        const double y = warp_sum8(acc, lane);
        if (owner) {
            work[i * s + row] = y;
            publish(res, i * s + row, y);
        }
    }
}

// Backward substitution, one work item per block column j, taken by
// ticket from the last column down.  Thread (q, c) sums T[k][c] x[k] over
// the rows k = q mod kSubSlices of panel j's blocks m = w_j-1 .. 0 as
// their x_{j+1+m} are published (block j+1's, m = 0, last: the only one
// on the critical path), each block loaded into registers before its
// wait, into two partial sums (even and odd rows of the slice); then y_j
// minus the slices' sums in slice order, x_j = inv^T of that (four
// partial sums a thread, then the slices' sums of each column in order),
// published, written to work and, permuted back, to out.  Every sum runs
// in a fixed order, so x repeats its bits.
__global__ void __launch_bounds__(kSubThreads, 1)
band_bwd_kernel(const double* __restrict__ panels,
                const int64_t* __restrict__ panel_off,
                const int64_t* __restrict__ blk_w,
                const int32_t* __restrict__ perm, double* __restrict__ work,
                double* __restrict__ out, int* sync, int* err, int64_t n,
                int64_t nb) {
    constexpr int s = kBlock;
    extern __shared__ __align__(16) double sub_sm[];
    double* inv = sub_sm;
    double* xs = sub_sm + s * s;
    double* ts = xs + s;
    double* red = ts + s;
    __shared__ int item_s, ok_s;
    const int tid = threadIdx.x, q = tid / s, c = tid - q * s;
    unsigned long long* res = reinterpret_cast<unsigned long long*>(
        reinterpret_cast<char*>(sync) + kSubHeader) + 2 * nb * s;
    for (;;) {
        const int64_t t0 = next_item(sync, kSubTicketBwd, err, nb, &item_s);
        if (t0 >= nb) return;
        const int64_t j = nb - 1 - t0;
        const double* P = panels + panel_off[j];
        load_inv_async(inv, P);
        const double yc = work[j * s + c];
        const int32_t p = perm[j * s + c];
        // two partial sums (even and odd t) shorten the dependent chain
        double acc[2] = {0.0, 0.0};
        for (int64_t m = blk_w[j] - 1; m >= 0; --m) {
            const double* T = P + (m + 1) * (s * s);
            double tv[kSubTerms];
#pragma unroll
            for (int t = 0; t < kSubTerms; ++t)
                tv[t] = T[(q + kSubSlices * t) * s + c];
            if (!wait_block(res, (j + 1 + m) * s, xs, err, &ok_s)) return;
#pragma unroll
            for (int t = 0; t < kSubTerms; ++t)
                acc[t & 1] += tv[t] * xs[q + kSubSlices * t];
            __syncthreads();
        }
        red[tid] = acc[0] + acc[1];
        cp_async_wait_all();
        __syncthreads();
        if (q == 0) {
            double v = yc;
#pragma unroll
            for (int h = 0; h < kSubSlices; ++h) v -= red[h * s + c];
            ts[c] = v;
        }
        __syncthreads();
        double x[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int t = 0; t < kSubTerms; ++t) {
            const int k = c + q + kSubSlices * t;
            if (k < s) x[t & 3] += inv[k * s + c] * ts[k];
        }
        red[tid] = (x[0] + x[1]) + (x[2] + x[3]);
        __syncthreads();
        if (q == 0) {
            double v = 0.0;
#pragma unroll
            for (int h = 0; h < kSubSlices; ++h) v += red[h * s + c];
            publish(res, j * s + c, v);
            work[j * s + c] = v;
            if (p < n) out[p] = v;
        }
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


// Grid of each substitution: as many CTAs as fit on the card at once (one
// per SM: the inverse fills most of its shared memory), at most nb.  The
// kernels' shared-memory attribute and the count per card are set up once
// per device (the launch sits on the refinement's critical path).
static cudaError_t sub_grid(const void* kernel, int64_t nb, unsigned* grid) {
    static int done_dev[2] = {-1, -1};
    static int per_card[2] = {0, 0};
    const int which = kernel == (const void*)band_fwd_kernel ? 0 : 1;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (done_dev[which] != dev) {
        const size_t smem = sub_smem_bytes();
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kSubThreads, smem);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        per_card[which] = per_sm * sms;
        done_dev[which] = dev;
    }
    *grid = (unsigned)(per_card[which] < nb ? per_card[which] : nb);
    return cudaSuccess;
}

extern "C" int sanm_band_solve(const double* panels,
                               const int64_t* panel_off,
                               const int64_t* blk_w, const int32_t* row_lo,
                               const int32_t* perm_ext, const double* rhs,
                               double* work, int* sync, int* err_word,
                               double* out, int64_t n, int64_t nb,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const size_t smem = sub_smem_bytes();
    unsigned gf = 0, gb = 0;
    cudaError_t err = sub_grid((const void*)band_fwd_kernel, nb, &gf);
    if (err != cudaSuccess) return (int)err;
    err = sub_grid((const void*)band_bwd_kernel, nb, &gb);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(sync, 0, kSubHeader + 4 * nb * kBlock * 8, st);
    if (err != cudaSuccess) return (int)err;
    band_fwd_kernel<<<gf, kSubThreads, smem, st>>>(
        panels, panel_off, row_lo, perm_ext, rhs, work, sync, err_word, n,
        nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    band_bwd_kernel<<<gb, kSubThreads, smem, st>>>(
        panels, panel_off, blk_w, perm_ext, work, out, sync, err_word, n,
        nb);
    return (int)cudaGetLastError();
}
