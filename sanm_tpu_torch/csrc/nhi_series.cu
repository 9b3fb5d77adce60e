// K1n: one order of the NHI Taylor series per element: commit order k,
// then the order-(k+1) bias of the stress.
//
// Replaces the fused commit(k) + bias(k+1) step_fn of
// sanm_tpu/solver/anm.py _hybrid_fns (:293-316) on the NHI pk1 graph
// (sanm_tpu/fea/material.py:80-89), which the JAX package interprets with
// ScanEngine.push / order_bias (sanm_tpu/taylor_scan.py:335-346) and the
// rules _mul_rule, _div_rule, _pow_like_rule (:543-567, here with
// p = -2/3), _add_rule and _dot_general_rule.  Specialised to this graph:
//   F = (g + bias) Dm^-1, J = det F, Q = F^-T, Ic = |F|^2, A = J^(-2/3),
//   s = (-mu/3) A Ic + kap J J - kap J,   P = mu A F + s Q.
// Per element and order m, besides F_m, C_m, J_m and Q_m (nh_series.h):
//   Ic_m = sum_{t=0..m} F_t . F_{m-t}
//   A_m  = (p A_0 / J_0) J_m
//          + (1/J_0) sum_{i=1..m-1} ((i/m)(p+1) - 1) J_i A_{m-i}  (pow rule)
//   s_m  = (-mu/3) sum_t A_t Ic_{m-t} + kap sum_t J_t J_{m-t} - kap J_m
//   P_m  = sum_{t=0..m} mu A_t F_{m-t} + s_t Q_{m-t}
// (A_0 = J_0^p.)  The bias of order m is P_m with g_m held at zero; at
// m = 1 every term holds a factor of order 1 and the bias is exactly zero.
//
// Histories: hist (order+1, 25, B) float64 in the layout of nh_series.h
// (F, C row 0, Q, J), with A 22, Ic 23 and s 24: each is read by a later
// order (A by its own recurrence, A F and A Ic; Ic by A Ic; s by s Q).
//
// Bound on the H100: memory.  The launch at k reads the 25 history
// components of orders <= k (~15.6 MB per order at B = 78,067, the human
// mesh) and does ~170 (k+1) f64 operations per element; at bias order 20
// that is ~330 MB (~98 us at 3.35 TB/s) against ~0.28 GFLOP (~8 us at 34
// TFLOP/s f64 without tensor cores).  Design: K1's: one thread per
// element, histories laid out for coalesced reads, no shared memory; the
// commit and the bias are one launch so the histories are read in one
// pass while still in L2.
#include <cuda_runtime.h>

#include "nh_series.h"
#include "sanm_kernels.h"

namespace {

using namespace nh_series;

constexpr int kThreads = 128;
constexpr int NC = 25;
constexpr int cA = 22, cIc = 23, cS = 24;
constexpr double kP = -2.0 / 3.0;  // A = J^kP
using Hist25 = Hist<NC>;

// Order-m pass.  COMMIT: store C_m row 0, Q_m, J_m, A_m, Ic_m, s_m (F_m
// stored by the caller).  Otherwise (bias, Fm == 0): write P_m to P.
template <bool COMMIT>
__device__ void order_pass(const Hist25& H, int m, const double* Fm,
                           double mu, double kap, double* P) {
    double Cm[9], Jm, Qm[9];
    cofactor_terms(H, m, Fm, Cm, Jm, Qm);
    // ---- Ic_m: self-convolution of F ----
    double Icm = 0.0;
    for (int t = 0; t <= m; ++t) {
        double A[9], Bv[9];
        load_F(H, t, m, Fm, A);
        load_F(H, m - t, m, Fm, Bv);
        double dot = 0.0;
        for (int i = 0; i < 9; ++i) dot += A[i] * Bv[i];
        Icm += dot;
    }
    // ---- A_m: the power recurrence ----
    const double Am = m == 0 ? pow(Jm, kP) : pow_rec(H, m, Jm, cJ, cA, kP);
    // ---- s_m ----
    double a_ic = 0.0, jj = 0.0;
    for (int t = 0; t <= m; ++t) {
        const double at = t == m ? Am : H.get(t, cA);
        const double ic = t == 0 ? Icm : H.get(m - t, cIc);
        const double jt = t == m ? Jm : H.get(t, cJ);
        const double jr = t == 0 ? Jm : H.get(m - t, cJ);
        a_ic += at * ic;
        jj += jt * jr;
    }
    const double Sm = (-mu / 3.0) * a_ic + kap * jj - kap * Jm;
    if (COMMIT) {
        for (int i = 0; i < 3; ++i) H.set(m, cC + i, Cm[i]);
        for (int i = 0; i < 9; ++i) H.set(m, cQ + i, Qm[i]);
        H.set(m, cJ, Jm);
        H.set(m, cA, Am);
        H.set(m, cIc, Icm);
        H.set(m, cS, Sm);
        return;
    }
    // ---- P_m = sum_t mu A_t F_{m-t} + s_t Q_{m-t} ----
    for (int i = 0; i < 9; ++i) {
        double acc = 0.0;
        for (int t = 0; t <= m; ++t) {
            const double at = t == m ? Am : H.get(t, cA);
            const double st = t == m ? Sm : H.get(t, cS);
            const double f = t == 0 ? Fm[i] : H.get(m - t, cF + i);
            const double q = t == 0 ? Qm[i] : H.get(m - t, cQ + i);
            acc = acc + mu * at * f + st * q;
        }
        P[i] = acc;
    }
}

__global__ void nhi_step_kernel(double* __restrict__ hist,
                                const double* __restrict__ gin,
                                const double* __restrict__ bias,
                                const double* __restrict__ dminv,
                                double* __restrict__ bias_out, int64_t B,
                                int k, double mu, double kap, int want_bias) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    Hist25 H{hist, B, b};
    double Fk[9];
    order_f(gin, bias, dminv, b, k, Fk);
    for (int i = 0; i < 9; ++i) H.set(k, cF + i, Fk[i]);
    order_pass<true>(H, k, Fk, mu, kap, nullptr);
    if (want_bias) {
        double zero[9], P[9];
        for (int i = 0; i < 9; ++i) zero[i] = 0.0;
        order_pass<false>(H, k + 1, zero, mu, kap, P);
        for (int i = 0; i < 9; ++i) bias_out[b * 9 + i] = P[i];
    }
}

}  // namespace

extern "C" int sanm_nhi_step(double* hist, const double* gin,
                             const double* bias, const double* dminv,
                             double* bias_out, int64_t B, int k, int order,
                             double mu, double kappa, int want_bias,
                             void* stream) {
    if (k < 0 || k > order || (want_bias && k + 1 > order))
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        nhi_step_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads,
                          0, (cudaStream_t)stream>>>(
            hist, gin, bias, dminv, bias_out, B, k, mu, kappa, want_bias);
    return (int)cudaGetLastError();
}
