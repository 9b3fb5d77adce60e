// K2: the element-condensed remaps, in gather form, and K4: the element
// matvec A x from the condensed stiffness, in the same gather form.
//
// K2 replaces sanm_tpu/solver/remap.py SparseAssembler.apply_in /
// apply_out (:308-339), which the JAX package runs once per Taylor order
// inside the fused step of sanm_tpu/solver/anm.py _hybrid_fns (:293-316).
// K4 replaces SparseAssembler.element_matvec (:453-478), which the band
// path runs per refinement trip and per sanity residual
// (sanm_tpu/solver/anm.py:497-537).  K4 reads E (B x 12 x 12 f64, ~49 MB
// at armadillo-small) once: memory bound, ~16 us at 3.35 TB/s.
//
// Bound on the H100: memory.  At armadillo-small (B = 42,288, idim = odim
// = 9, Din = Dout = 12) remap_in reads Lin (~37 MB) and remap_out Lout
// (~37 MB); each moves ~40-45 MB, about 12-14 us at 3.35 TB/s, against a
// few tens of MFLOP.
//
// Design: one thread per output value of a contraction, each reading its
// coefficients as a contiguous run so that a warp reads one contiguous
// stretch.  The scatter-add of apply_out is inverted on the host (row ->
// its (b, i) entries, ascending): a first pass writes each entry's
// contraction, a second sums every row's entries in that fixed order with
// no atomics.  Results are the same bits on every run, which keeps the
// Pade accept/reject decisions reproducible.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void remap_in_kernel(const double* __restrict__ Lin,
                                const int32_t* __restrict__ loc_cols,
                                const double* __restrict__ xp,
                                double* __restrict__ gin, int64_t B,
                                int idim, int Din) {
    int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (t >= B * idim) return;
    int64_t b = t / idim;
    const double* L = Lin + t * Din;
    const int32_t* cols = loc_cols + b * Din;
    double acc = 0.0;
    for (int d = 0; d < Din; ++d) acc += L[d] * xp[cols[d]];
    gin[t] = acc;
}

// Pass 1: contrib[e] = sum_p Lout[e, p] * bb[e / Dout, p], one thread per
// (b, i) entry; a warp reads one contiguous stretch of Lout.
__global__ void remap_out_contrib_kernel(const double* __restrict__ Lout,
                                         const double* __restrict__ bb,
                                         double* __restrict__ contrib,
                                         int64_t nent, int Dout, int odim) {
    int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (e >= nent) return;
    const double* L = Lout + e * odim;
    const double* x = bb + (e / Dout) * odim;
    double c = 0.0;
    for (int q = 0; q < odim; ++q) c += L[q] * x[q];
    contrib[e] = c;
}

// Pass 2: out[r] = sum of contrib over row r's entries, ascending.
__global__ void remap_out_gather_kernel(const double* __restrict__ contrib,
                                        const int32_t* __restrict__ row_ptr,
                                        const int32_t* __restrict__ row_ent,
                                        double* __restrict__ out,
                                        int64_t n_rows) {
    int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (r >= n_rows) return;
    double acc = 0.0;
    for (int32_t p = row_ptr[r]; p < row_ptr[r + 1]; ++p)
        acc += contrib[row_ent[p]];
    out[r] = acc;
}

// K4 pass 1: contrib[e] = sum_j E[e, j] * x[loc_cols[b, j]], b = e / Dout,
// one thread per (b, i) entry; columns >= n (the t column and the dead
// padding) read as zero.
__global__ void element_matvec_contrib_kernel(
    const double* __restrict__ E, const int32_t* __restrict__ loc_cols,
    const double* __restrict__ x, double* __restrict__ contrib, int64_t n,
    int64_t nent, int Dout, int Din) {
    int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (e >= nent) return;
    const double* Er = E + e * Din;
    const int32_t* cols = loc_cols + (e / Dout) * Din;
    double c = 0.0;
    for (int j = 0; j < Din; ++j) {
        int32_t col = cols[j];
        c += Er[j] * (col < n ? x[col] : 0.0);
    }
    contrib[e] = c;
}

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int sanm_remap_in(const double* Lin, const int32_t* loc_cols,
                             const double* xp, double* gin, int64_t B,
                             int idim, int Din, void* stream) {
    int64_t n = B * idim;
    if (n > 0)
        remap_in_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
            Lin, loc_cols, xp, gin, B, idim, Din);
    return (int)cudaGetLastError();
}

extern "C" int sanm_remap_out(const double* Lout, const double* bb,
                              const int32_t* row_ptr, const int32_t* row_ent,
                              double* contrib, double* out, int64_t n_rows,
                              int64_t nent, int Dout, int odim,
                              void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nent > 0)
        remap_out_contrib_kernel<<<blocks_for(nent), kThreads, 0, s>>>(
            Lout, bb, contrib, nent, Dout, odim);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_rows > 0)
        remap_out_gather_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
            contrib, row_ptr, row_ent, out, n_rows);
    return (int)cudaGetLastError();
}

extern "C" int sanm_element_matvec(const double* E,
                                   const int32_t* loc_cols, const double* x,
                                   const int32_t* row_ptr,
                                   const int32_t* row_ent, double* contrib,
                                   double* out, int64_t n, int64_t n_rows,
                                   int64_t nent, int Dout, int Din,
                                   void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (nent > 0)
        element_matvec_contrib_kernel<<<blocks_for(nent), kThreads, 0, s>>>(
            E, loc_cols, x, contrib, n, nent, Dout, Din);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (n_rows > 0)
        remap_out_gather_kernel<<<blocks_for(n_rows), kThreads, 0, s>>>(
            contrib, row_ptr, row_ent, out, n_rows);
    return (int)cudaGetLastError();
}

extern "C" const char* sanm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
