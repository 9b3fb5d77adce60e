// K1s: one order of the StVK stretch Taylor series per element: commit
// order k, then the order-(k+1) bias of the stress.
//
// Replaces the fused commit(k) + bias(k+1) step_fn of
// sanm_tpu/solver/anm.py _hybrid_fns (:293-316) on the StVK_STRETCH pk1
// graph (sanm_tpu/fea/material.py:95-100), which the JAX package
// interprets with ScanEngine.push / order_bias (sanm_tpu/taylor_scan.py:
// 335-346) and the rules _dot_general_rule, _add_rule and _mul_rule
// (:495-657).  Specialised to this graph:
//   F = (g + bias) Dm^-1,  b = F F^T,  P = mu (b F - F).
// Per element and order m:
//   F_m = g_m Dm^-1 (plus the bias at m = 0)                 (nh_series.h)
//   b_m = sum_{t=0..m} F_t F_{m-t}^T        (six entries, b is symmetric)
//   P_m = mu (sum_{t=0..m} b_t F_{m-t} - F_m)
// The bias of order m is P_m with g_m held at zero: F_m enters through
// b_0 F_m, through F_0 F_m^T + F_m F_0^T inside b_m, and through -F_m,
// and the pass with F_m = 0 drops all three.  At m = 1 every term holds a
// factor of order 1 and the bias is exactly zero.
//
// The bias pass adds only the terms free of F_m: t = 1..m-1 in b_m and
// t = 1..m in P_m.
//
// Histories: hist (order+1, 15, B) float64, element index fastest (a
// warp's loads of one component are one contiguous run): F 0-8 and b 9-14
// (b00, b01, b02, b11, b12, b22), both read by later orders.
//
// Bound on the H100: memory.  The launch at k reads F_0..F_{k-1} and
// b_1..b_{k-1} and writes F_k and b_k (~5.1 MB per order at B = 42,288,
// armadillo-small) and does ~(126 k + 153) f64 operations per element; at bias
// order 20 that is ~108 MB (~32 us at 3.35 TB/s) against ~0.12 GFLOP
// (~3.5 us at 34 TFLOP/s f64 without tensor cores).  Design: K1's and
// K1n's: one thread per element, the sums over t in ascending order, no
// shared memory; the commit and the bias are one launch so the histories
// are read in one pass while still in L2.
#include <cuda_runtime.h>

#include "nh_series.h"
#include "sanm_kernels.h"

namespace {

using namespace nh_series;

constexpr int kThreads = 128;
constexpr int NC = 15;
constexpr int cB = 9;  // b00, b01, b02, b11, b12, b22
using Hist15 = Hist<NC>;

__device__ __forceinline__ int sym(int i, int j) {
    // the stored entry of b[i][j]: (0,0) 0, (0,1) 1, (0,2) 2, (1,1) 3,
    // (1,2) 4, (2,2) 5
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    return lo == 0 ? hi : lo + hi + 1;
}

// Order-m pass.  COMMIT: store b_m (F_m stored by the caller).  Otherwise
// (bias, Fm == 0): write P_m to P, skipping the terms that hold F_m (t = 0
// and t = m in b_m, t = 0 in P_m), so b_0 is never loaded.
template <bool COMMIT>
__device__ void order_pass(const Hist15& H, int m, const double* Fm,
                           double mu, double* P) {
    constexpr int lo = COMMIT ? 0 : 1;
    // ---- b_m = sum_t F_t F_{m-t}^T ----
    double bm[6];
    for (int p = 0; p < 6; ++p) bm[p] = 0.0;
    for (int t = lo; t <= m - lo; ++t) {
        double A[9], Bv[9];
        load_F(H, t, m, Fm, A);
        load_F(H, m - t, m, Fm, Bv);
        for (int i = 0; i < 3; ++i)
            for (int j = i; j < 3; ++j)
                bm[sym(i, j)] += A[i * 3] * Bv[j * 3] +
                                 A[i * 3 + 1] * Bv[j * 3 + 1] +
                                 A[i * 3 + 2] * Bv[j * 3 + 2];
    }
    if (COMMIT) {
        for (int p = 0; p < 6; ++p) H.set(m, cB + p, bm[p]);
        return;
    }
    // ---- P_m = mu (sum_t b_t F_{m-t} - F_m) ----
    double acc[9];
    for (int i = 0; i < 9; ++i) acc[i] = 0.0;
    for (int t = 1; t <= m; ++t) {
        double bt[6], Ft[9];
        for (int p = 0; p < 6; ++p) bt[p] = t == m ? bm[p] : H.get(t, cB + p);
        load_F(H, m - t, m, Fm, Ft);
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                acc[i * 3 + j] += bt[sym(i, 0)] * Ft[j] +
                                  bt[sym(i, 1)] * Ft[3 + j] +
                                  bt[sym(i, 2)] * Ft[6 + j];
    }
    for (int i = 0; i < 9; ++i) P[i] = mu * (acc[i] - Fm[i]);
}

__global__ void stvk_step_kernel(double* __restrict__ hist,
                                 const double* __restrict__ gin,
                                 const double* __restrict__ bias,
                                 const double* __restrict__ dminv,
                                 double* __restrict__ bias_out, int64_t B,
                                 int k, double mu, int want_bias) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    Hist15 H{hist, B, b};
    double Fk[9];
    order_f(gin, bias, dminv, b, k, Fk);
    for (int i = 0; i < 9; ++i) H.set(k, cF + i, Fk[i]);
    order_pass<true>(H, k, Fk, mu, nullptr);
    if (want_bias) {
        double zero[9], P[9];
        for (int i = 0; i < 9; ++i) zero[i] = 0.0;
        order_pass<false>(H, k + 1, zero, mu, P);
        for (int i = 0; i < 9; ++i) bias_out[b * 9 + i] = P[i];
    }
}

}  // namespace

extern "C" int sanm_stvk_step(double* hist, const double* gin,
                              const double* bias, const double* dminv,
                              double* bias_out, int64_t B, int k, int order,
                              double mu, int want_bias, void* stream) {
    if (k < 0 || k > order || (want_bias && k + 1 > order))
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        stvk_step_kernel<<<(unsigned)((B + kThreads - 1) / kThreads),
                           kThreads, 0, (cudaStream_t)stream>>>(
            hist, gin, bias, dminv, bias_out, B, k, mu, want_bias);
    return (int)cudaGetLastError();
}
