// K3: element Jacobian of the NHC stress and the condensed CSR assembly.
//
// Replaces jac_asm of sanm_tpu/solver/anm.py _hybrid_fns (:278-291):
// batched_jacobian (sanm_tpu/taylor.py:611, forward-mode 9x9 Jacobian of
// the pk1 graph per element) followed by SparseAssembler.assemble_csr_elem
// (sanm_tpu/solver/remap.py:356-372: E[b] = Lout[b] J[b] Lin[b] and a
// scatter-add of E into the CSR values).  Runs once per ANM restart.
//
// Bound on the H100: memory.  At armadillo-small it reads Lout and Lin
// (~37 MB each), the gather map (~40 MB) and writes E (~47 MB) and the
// ~3 M CSR values (~25 MB): ~200 MB, about 60 us at 3.35 TB/s, against
// ~0.25 GFLOP of f64 work (~7 us at 34 TFLOP/s without tensor cores).
//
// Design: the Jacobian is closed form, not forward-mode:
//   P = mu F - mu F^-T + lam log(J) F^-T,  G = F^-1,
//   dP_ij/dF_ml = mu d_im d_jl + (mu - lam log J) G_jm G_li + lam G_ji G_lm,
// chained through F = (g + bias) Dm^-1.  One warp per element: each lane
// rebuilds F and G (a few dozen flops), then the warp fills the 9x9
// Jacobian, the Dout x 9 product Lout J and the Dout x Din E through
// shared memory.  The scatter-add into CSR is inverted on the host
// (nnz -> its slots, ascending), so a second kernel sums each value in a
// fixed order without atomics: the assembled matrix has the same bits on
// every run.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kWarps = 4;    // elements per block
constexpr int kMaxD = 16;    // max Dout and Din taken (tets: 12)
constexpr int kThreads = 256;

__global__ void elem_stiffness_kernel(
    const double* __restrict__ gin0, const double* __restrict__ bias,
    const double* __restrict__ dminv, const double* __restrict__ Lout,
    const double* __restrict__ Lin, double* __restrict__ E, int64_t B,
    int Dout, int Din, double mu, double lam) {
    __shared__ double sJ[kWarps][81];
    __shared__ double sT[kWarps][kMaxD * 9];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
    if (b >= B) return;  // whole warp leaves; only __syncwarp below

    double M[9], F[9], G[9], H[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) M[i * 3 + j] = dminv[b * 9 + i * 3 + j];
    for (int i = 0; i < 3; ++i) {
        double ds[3];
        for (int l = 0; l < 3; ++l)
            ds[l] = gin0[b * 9 + i * 3 + l] + bias[b * 9 + i * 3 + l];
        for (int j = 0; j < 3; ++j) {
            double acc = 0.0;
            for (int l = 0; l < 3; ++l) acc += ds[l] * M[l * 3 + j];
            F[i * 3 + j] = acc;
        }
    }
    // cofactor C, J = det F, G = F^-1 = C^T / J
    double C[9];
    for (int i = 0; i < 3; ++i) {
        const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
        for (int j = 0; j < 3; ++j) {
            const int c0 = j == 0 ? 1 : 0, c1 = j == 2 ? 1 : 2;
            double mnr = F[r0 * 3 + c0] * F[r1 * 3 + c1] -
                         F[r0 * 3 + c1] * F[r1 * 3 + c0];
            C[i * 3 + j] = ((i + j) & 1) ? -mnr : mnr;
        }
    }
    const double J = F[0] * C[0] + F[1] * C[1] + F[2] * C[2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) G[i * 3 + j] = C[j * 3 + i] / J;
    // H = Dm^-1 G
    for (int n = 0; n < 3; ++n)
        for (int i = 0; i < 3; ++i) {
            double acc = 0.0;
            for (int l = 0; l < 3; ++l) acc += M[n * 3 + l] * G[l * 3 + i];
            H[n * 3 + i] = acc;
        }
    const double c1 = mu - lam * log(J);

    // Jacobian in g: Jg[(i,j), (m,n)] = sum_l dP_ij/dF_ml Dm^-1_nl
    for (int idx = lane; idx < 81; idx += 32) {
        const int p = idx / 9, q = idx % 9;
        const int i = p / 3, j = p % 3, m = q / 3, n = q % 3;
        double v = c1 * G[j * 3 + m] * H[n * 3 + i] +
                   lam * G[j * 3 + i] * H[n * 3 + m];
        if (i == m) v += mu * M[n * 3 + j];
        sJ[warp][idx] = v;
    }
    __syncwarp();
    // T = Lout[b] Jg  (Dout x 9)
    const double* Lo = Lout + b * Dout * 9;
    for (int idx = lane; idx < Dout * 9; idx += 32) {
        const int d = idx / 9, q = idx % 9;
        double acc = 0.0;
        for (int p = 0; p < 9; ++p) acc += Lo[d * 9 + p] * sJ[warp][p * 9 + q];
        sT[warp][idx] = acc;
    }
    __syncwarp();
    // E[b] = T Lin[b]  (Dout x Din)
    const double* Li = Lin + b * 9 * Din;
    double* Eb = E + b * Dout * Din;
    for (int idx = lane; idx < Dout * Din; idx += 32) {
        const int d = idx / Din, e = idx % Din;
        double acc = 0.0;
        for (int q = 0; q < 9; ++q) acc += sT[warp][d * 9 + q] * Li[q * Din + e];
        Eb[idx] = acc;
    }
}

__global__ void csr_gather_kernel(const double* __restrict__ E,
                                  const int32_t* __restrict__ nz_ptr,
                                  const int32_t* __restrict__ nz_slot,
                                  double* __restrict__ data, int64_t nnz) {
    int64_t z = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (z >= nnz) return;
    double acc = 0.0;
    for (int32_t p = nz_ptr[z]; p < nz_ptr[z + 1]; ++p) acc += E[nz_slot[p]];
    data[z] = acc;
}

}  // namespace

extern "C" int sanm_jac_asm(const double* gin0, const double* bias,
                            const double* dminv, const double* Lout,
                            const double* Lin, const int32_t* nz_ptr,
                            const int32_t* nz_slot, double* E, double* data,
                            int64_t B, int Dout, int Din, int64_t nnz,
                            double mu, double lam, void* stream) {
    if (Dout > kMaxD || Din > kMaxD) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (B > 0)
        elem_stiffness_kernel<<<(unsigned)((B + kWarps - 1) / kWarps),
                                kWarps * 32, 0, s>>>(
            gin0, bias, dminv, Lout, Lin, E, B, Dout, Din, mu, lam);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (nnz > 0)
        csr_gather_kernel<<<(unsigned)((nnz + kThreads - 1) / kThreads),
                            kThreads, 0, s>>>(E, nz_ptr, nz_slot, data, nnz);
    return (int)cudaGetLastError();
}
