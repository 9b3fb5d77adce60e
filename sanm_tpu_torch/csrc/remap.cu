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
// Design of K2: one thread per output value of a contraction, each reading
// its coefficients as a contiguous run so that a warp reads one contiguous
// stretch.  The scatter-add of apply_out is inverted on the host (row ->
// its (b, i) entries, ascending): a first pass writes each entry's
// contraction, a second sums every row's entries in that fixed order with
// no atomics.  Results are the same bits on every run, which keeps the
// Pade accept/reject decisions reproducible.
//
// Design of K4: element-major, then row-major.  A CTA takes a tile of 16
// elements (small tiles keep more CTAs, and so more loads, in flight on
// each SM): their E, one contiguous stretch, is read in 16-byte vectors
// into shared memory; each element's Din unknowns are gathered once; one
// thread per (b, i) entry forms its contraction in ascending j and stores
// it at the entry's place in row order (host map ent_pos, the inverse of
// the row gather map), so a second kernel sums each row's contiguous
// stretch of that 4 MB, L2-resident buffer in ascending order.  The
// operations and their order are those of the former one-thread-per-entry
// kernel, so the result repeats its bits; what changed is that E is read
// coalesced and loc_cols and x once per element instead of once per entry,
// and the row sums read contiguous memory instead of an index each.
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

// K4 pass 1, one tile of kMvElems elements per CTA: the tile's E
// (contiguous) into shared memory in 16-byte vectors, each element's Din
// x values gathered once (columns >= n read as zero), then one thread per
// (b, i) entry forms sum_j E[e, j] x_j in ascending j (the row stride
// Din | 1 is odd, so a warp's reads of its rows hit distinct banks) and
// stores it at the entry's place in row order, crow[ent_pos[e]].  Every
// load that does not depend on another is issued first (columns, places,
// E), then the gather.  The shapes are template arguments: Dout = 12 and
// Din = 12, or 13 with the implicit solver's t column.
constexpr int kMvElems = 16;
constexpr int kMvThreads = 64;

template <int kDout, int kDin>
__global__ void __launch_bounds__(kMvThreads)
element_matvec_entries_kernel(const double* __restrict__ E,
                              const int32_t* __restrict__ loc_cols,
                              const double* __restrict__ x,
                              const int32_t* __restrict__ ent_pos,
                              double* __restrict__ crow, int64_t n,
                              int64_t B) {
    constexpr int Dout = kDout, Din = kDin, ld = kDin | 1;
    constexpr int kCol = (kMvElems * Din + kMvThreads - 1) / kMvThreads;
    constexpr int kEnt = (kMvElems * Dout + kMvThreads - 1) / kMvThreads;
    constexpr int kVec = (kMvElems * Dout * Din / 2 + kMvThreads - 1) /
                         kMvThreads;
    __shared__ double Es[kMvElems * Dout * ld];
    __shared__ double xs[kMvElems * Din];
    const int tid = threadIdx.x;
    const int64_t b0 = (int64_t)blockIdx.x * kMvElems;
    const int nel = (int)(B - b0 < kMvElems ? B - b0 : kMvElems);
    const int64_t e0 = b0 * Dout;
    // b0 is a multiple of kMvElems (even), so the tile starts 16-byte
    // aligned; a tile of odd length leaves one double for thread 0
    const int tot = nel * Dout * Din;
    const double2* src = reinterpret_cast<const double2*>(E + e0 * Din);
    int32_t col[kCol], pos[kEnt];
#pragma unroll
    for (int u = 0; u < kCol; ++u) {
        const int c = tid + u * kMvThreads;
        col[u] = c < nel * Din ? loc_cols[b0 * Din + c] : 0;
    }
#pragma unroll
    for (int u = 0; u < kEnt; ++u) {
        const int c = tid + u * kMvThreads;
        pos[u] = c < nel * Dout ? ent_pos[e0 + c] : -1;
    }
    double2 v[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
        const int c = tid + u * kMvThreads;
        if (c < tot / 2) v[u] = __ldg(src + c);
    }
    double xv[kCol];
#pragma unroll
    for (int u = 0; u < kCol; ++u) xv[u] = col[u] < n ? x[col[u]] : 0.0;
#pragma unroll
    for (int u = 0; u < kCol; ++u) {
        const int c = tid + u * kMvThreads;
        if (c < nel * Din) xs[c] = xv[u];
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
        const int c = tid + u * kMvThreads;
        if (c < tot / 2) {
            const int a = 2 * c, a1 = a + 1;
            Es[(a / Din) * ld + a % Din] = v[u].x;
            Es[(a1 / Din) * ld + a1 % Din] = v[u].y;
        }
    }
    if ((tot & 1) && tid == 0)
        Es[((tot - 1) / Din) * ld + (tot - 1) % Din] = E[e0 * Din + tot - 1];
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kEnt; ++u) {
        const int le = tid + u * kMvThreads;
        if (pos[u] < 0) continue;
        const double* Er = Es + le * ld;
        const double* xe = xs + (le / Dout) * Din;
        double c = 0.0;
#pragma unroll
        for (int j = 0; j < Din; ++j) c += Er[j] * xe[j];
        crow[pos[u]] = c;
    }
}

// K4 pass 2: out[r] = sum of crow[row_ptr[r] : row_ptr[r+1]] in ascending
// order, a warp per 32 rows: the warp reads its rows' contiguous stretch
// of crow in coalesced chunks of kRowChunk into shared memory (all of a
// chunk's loads in flight at once), and each lane adds its row's entries
// from there, chunk after chunk.
constexpr int kRowThreads = 256;
constexpr int kRowChunk = 512;

__global__ void __launch_bounds__(kRowThreads)
element_matvec_rows_kernel(const double* __restrict__ crow,
                           const int32_t* __restrict__ row_ptr,
                           double* __restrict__ out, int64_t n_rows) {
    __shared__ double buf[kRowThreads / 32][kRowChunk];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int64_t r0 = ((int64_t)blockIdx.x * (kRowThreads / 32) + w) * 32;
    if (r0 >= n_rows) return;
    const int64_t r = r0 + lane;
    const int32_t lo = r < n_rows ? row_ptr[r] : 0;
    const int32_t hi = r < n_rows ? row_ptr[r + 1] : 0;
    const int last = (int)((r0 + 32 < n_rows ? r0 + 32 : n_rows) - 1 - r0);
    const int32_t base = __shfl_sync(0xffffffffu, lo, 0);
    const int32_t end = __shfl_sync(0xffffffffu, hi, last);
    double acc = 0.0;
    for (int32_t c0 = base; c0 < end; c0 += kRowChunk) {
        const int32_t cn = end - c0 < kRowChunk ? end - c0 : kRowChunk;
        double v[kRowChunk / 32];
#pragma unroll
        for (int u = 0; u < kRowChunk / 32; ++u) {
            const int i = lane + 32 * u;
            v[u] = i < cn ? crow[c0 + i] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kRowChunk / 32; ++u) buf[w][lane + 32 * u] = v[u];
        __syncwarp();
        const int32_t a = lo > c0 ? lo : c0;
        const int32_t b = hi < c0 + cn ? hi : c0 + cn;
        for (int32_t p = a; p < b; ++p) acc += buf[w][p - c0];
        __syncwarp();
    }
    if (r < n_rows) out[r] = acc;
}

template <int kDin>
void launch_entries(const double* E, const int32_t* loc_cols, const double* x,
                    const int32_t* ent_pos, double* crow, int64_t n,
                    int64_t B, cudaStream_t s) {
    element_matvec_entries_kernel<12, kDin>
        <<<(unsigned)((B + kMvElems - 1) / kMvElems), kMvThreads, 0, s>>>(
            E, loc_cols, x, ent_pos, crow, n, B);
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
                                   const int32_t* ent_pos,
                                   const int32_t* row_ptr, double* crow,
                                   double* out, int64_t n, int64_t n_rows,
                                   int64_t B, int Dout, int Din,
                                   void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (Dout != 12 || (Din != 12 && Din != 13))
        return (int)cudaErrorInvalidValue;
    if (B > 0) {
        if (Din == 12)
            launch_entries<12>(E, loc_cols, x, ent_pos, crow, n, B, s);
        else
            launch_entries<13>(E, loc_cols, x, ent_pos, crow, n, B, s);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (n_rows > 0)
        element_matvec_rows_kernel<<<(unsigned)((n_rows + kRowThreads - 1) /
                                                kRowThreads),
                                     kRowThreads, 0, s>>>(crow, row_ptr, out,
                                                          n_rows);
    return (int)cudaGetLastError();
}

extern "C" const char* sanm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
