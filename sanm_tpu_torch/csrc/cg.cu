// K4 COO: the products of the CSR values (A x, A^T y) and the diagonal
// blocks, and K9: the iterations of the block-Jacobi PCG solver.
//
// K4 COO replaces sanm_tpu/solver/remap.py SparseAssembler.matvec /
// matvec_t (:439-451), COO gathers and scatter-adds, and diag_blocks
// (:423-437).  K9 replaces sanm_tpu/solver/linear.py
// SparseCG._chunk_kernel (:671-724), a fixed-trip lax.fori_loop of PCG
// iterations with converged iterations frozen, which the host runs in
// chunks of 64 with one scalar read between them (:726-746).
//
// Bound on the H100: memory, and at the sizes of the cg path the launches.
// One iteration at armadillo-small (n = 38,046, nnz = 1,258,308) streams
// the CSR values and columns (15.1 MB) and about ten n-vectors (3 MB):
// ~5.5 us at 3.35 TB/s, against ~3 MFLOP.  The values fit in the 50 MB L2,
// so a chunk could run far below that; at test_cuboid (nnz = 166,122) an
// iteration is launch-bound.
//
// Design, simple first: one warp per output value of a product (a row of
// A, or through the host's gather map a row of A^T), its values in one
// contiguous range (A) or in ascending position (A^T), lanes strided and
// a butterfly sum, so that every run gives the same bits; no atomics.
// One PCG iteration is three launches over a fixed grid of G CTAs:
//   1. Ap = A p (in Tikhonov mode A^T (A p) + pen p, A p first by a launch
//      of the same product without partials) and per-CTA partial sums of
//      p.Ap;
//   2. every CTA sums the G partials in the same order (same bits in every
//      CTA), takes alpha, updates x and r (not at all once frozen), forms
//      z = M^-1 r per 3-block and the partials of r.z and r.r;
//   3. every CTA sums those, takes beta, p = z + beta p; CTA 0 writes the
//      new scalars.
// The scalars (rz, r.r, the count of live iterations) live in two slots
// on the card, read from slot it & 1 and written to the other, so that no
// kernel writes a slot that its own CTAs read; b.b sits beside them.  The
// host loops over the iterations of a chunk without synchronising.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_allsum(double v) {
    // butterfly: every lane ends with the same bits (a + b == b + a)
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The CTA's sum of v in a fixed order, the same value in every thread.
__device__ double block_sum(double v, double* sh) {
    v = warp_allsum(v);
    __syncthreads();  // sh may still be read by a previous call
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += sh[w];
    return s;
}

// The sum of G partials in a fixed order, the same value in every thread of
// every CTA.
__device__ double partials_sum(const double* __restrict__ part, int64_t G,
                               double* sh) {
    double s = 0.0;
    for (int64_t g = threadIdx.x; g < G; g += kThreads) s += part[g];
    return block_sum(s, sh);
}

// out[i] = sum_{q in ptr[i] .. ptr[i+1]} data[pos ? pos[q] : q] * v[idx[q]]
// (+ pen * w[i] when w), one warp per output, grid-stride; with partial,
// partial[cta] = sum over the CTA's outputs of w[i] * out[i].
__global__ void gather_matvec_kernel(
    const int32_t* __restrict__ ptr, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ idx, const double* __restrict__ data,
    const double* __restrict__ v, const double* __restrict__ w, double pen,
    double* __restrict__ out, int64_t n_out, double* __restrict__ partial) {
    __shared__ double sh[kWarps];
    const int lane = threadIdx.x & 31;
    const int64_t nw = (int64_t)gridDim.x * kWarps;
    double dot = 0.0;
    for (int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
         i < n_out; i += nw) {
        const int32_t q1 = ptr[i + 1];
        double acc = 0.0;
        for (int32_t q = ptr[i] + lane; q < q1; q += 32)
            acc += data[pos ? pos[q] : q] * v[idx[q]];
        acc = warp_allsum(acc);
        if (w != nullptr) {
            const double wi = w[i];
            acc += pen * wi;
            dot += wi * acc;
        }
        if (lane == 0) out[i] = acc;
    }
    if (partial != nullptr) {
        // every lane of a warp holds the same dot: one lane per warp counts
        dot = block_sum(lane == 0 ? dot : 0.0, sh);
        if (threadIdx.x == 0) partial[blockIdx.x] = dot;
    }
}

__global__ void diag_blocks_kernel(const int32_t* __restrict__ dmap,
                                   const double* __restrict__ data,
                                   double* __restrict__ out, int64_t count,
                                   int64_t nnz) {
    int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (t >= count) return;
    const int32_t z = dmap[t];
    out[t] = z < nnz ? data[z] : 0.0;
}

// K9 step 2: alpha, x += alpha p, r -= alpha Ap (live only), z = M^-1 r per
// 3-block, partials of r.z and r.r.
__global__ void pcg_update_kernel(
    const double* __restrict__ binv, const double* __restrict__ p,
    const double* __restrict__ Ap, double* __restrict__ x,
    double* __restrict__ r, double* __restrict__ z,
    const double* __restrict__ part_pap, const double* __restrict__ S,
    int cur, double tol2, double* __restrict__ part_rz,
    double* __restrict__ part_rr, int64_t nb, int64_t G) {
    __shared__ double sh[kWarps];
    const double pap = partials_sum(part_pap, G, sh);
    const double rz = S[3 * cur], rr = S[3 * cur + 1], bb = S[6];
    const bool live = rr > tol2 * bb;
    const double alpha = live ? rz / (pap != 0.0 ? pap : 1.0) : 0.0;
    double acc_rz = 0.0, acc_rr = 0.0;
    for (int64_t k = blockIdx.x * (int64_t)kThreads + threadIdx.x; k < nb;
         k += (int64_t)gridDim.x * kThreads) {
        double rv[3];
        for (int a = 0; a < 3; ++a) {
            const int64_t i = 3 * k + a;
            double ri = r[i];
            if (live) {
                x[i] = x[i] + alpha * p[i];
                ri = ri - alpha * Ap[i];
                r[i] = ri;
            }
            rv[a] = ri;
        }
        const double* B = binv + 9 * k;
        for (int a = 0; a < 3; ++a) {
            const double zi = B[3 * a] * rv[0] + B[3 * a + 1] * rv[1] +
                              B[3 * a + 2] * rv[2];
            z[3 * k + a] = zi;
            acc_rz += rv[a] * zi;
            acc_rr += rv[a] * rv[a];
        }
    }
    acc_rz = block_sum(acc_rz, sh);
    acc_rr = block_sum(acc_rr, sh);
    if (threadIdx.x == 0) {
        part_rz[blockIdx.x] = acc_rz;
        part_rr[blockIdx.x] = acc_rr;
    }
}

// K9 step 3: beta, p = z + beta p; CTA 0 writes slot 1 - cur.
__global__ void pcg_direction_kernel(
    const double* __restrict__ z, double* __restrict__ p,
    const double* __restrict__ part_rz, const double* __restrict__ part_rr,
    double* __restrict__ S, int cur, double tol2, int64_t n, int64_t G) {
    __shared__ double sh[kWarps];
    const double rz2 = partials_sum(part_rz, G, sh);
    const double rr2 = partials_sum(part_rr, G, sh);
    const double rz = S[3 * cur], rr = S[3 * cur + 1], bb = S[6];
    const bool live = rr > tol2 * bb;
    const double beta = live ? rz2 / (rz != 0.0 ? rz : 1.0) : 0.0;
    for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads)
        p[i] = z[i] + beta * p[i];
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        double* Sn = S + 3 * (1 - cur);
        Sn[0] = rz2;
        Sn[1] = rr2;
        Sn[2] = S[3 * cur + 2] + (live ? 1.0 : 0.0);
    }
}

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int sanm_csr_matvec(const int32_t* ptr, const int32_t* pos,
                               const int32_t* idx, const double* data,
                               const double* v, double* out, int64_t n_out,
                               void* stream) {
    if (n_out > 0)
        gather_matvec_kernel<<<(unsigned)((n_out + kWarps - 1) / kWarps),
                               kThreads, 0, (cudaStream_t)stream>>>(
            ptr, pos, idx, data, v, nullptr, 0.0, out, n_out, nullptr);
    return (int)cudaGetLastError();
}

extern "C" int sanm_diag_blocks(const int32_t* dmap, const double* data,
                                double* out, int64_t count, int64_t nnz,
                                void* stream) {
    if (count > 0)
        diag_blocks_kernel<<<blocks_for(count), kThreads, 0,
                             (cudaStream_t)stream>>>(dmap, data, out, count,
                                                     nnz);
    return (int)cudaGetLastError();
}

extern "C" int sanm_pcg_step(
    const int32_t* row_ptr, const int32_t* cols, const int32_t* t_ptr,
    const int32_t* t_src, const int32_t* t_rows, const double* data,
    const double* binv, double* x, double* r, double* z, double* p,
    double* Ap, double* y, double* S, double* part, int64_t n,
    int64_t n_steps, int64_t it0, int64_t G, double tol2, double pen,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = (unsigned)G;
    double* part_pap = part;
    double* part_rz = part + G;
    double* part_rr = part + 2 * G;
    for (int64_t step = 0; step < n_steps; ++step) {
        const int cur = (int)((it0 + step) & 1);
        if (pen == 0.0) {
            gather_matvec_kernel<<<grid, kThreads, 0, s>>>(
                row_ptr, nullptr, cols, data, p, p, 0.0, Ap, n, part_pap);
        } else {
            // the normal equations' operator A^T (A p) + pen p
            gather_matvec_kernel<<<(unsigned)((n + kWarps - 1) / kWarps),
                                   kThreads, 0, s>>>(
                row_ptr, nullptr, cols, data, p, nullptr, 0.0, y, n,
                nullptr);
            cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
            gather_matvec_kernel<<<grid, kThreads, 0, s>>>(
                t_ptr, t_src, t_rows, data, y, p, pen, Ap, n, part_pap);
        }
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        pcg_update_kernel<<<grid, kThreads, 0, s>>>(
            binv, p, Ap, x, r, z, part_pap, S, cur, tol2, part_rz, part_rr,
            n / 3, G);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        pcg_direction_kernel<<<grid, kThreads, 0, s>>>(
            z, p, part_rz, part_rr, S, cur, tol2, n, G);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
