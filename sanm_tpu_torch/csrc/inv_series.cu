// K1i: one order of the inverse (rest-shape design) model's Taylor series
// per element, for the compressible (NHC) and the incompressible (NHI)
// Neo-Hookean Cauchy stress: commit order k, then the order-(k+1) bias.
//
// Replaces the fused commit(k) + bias(k+1) step_fn of
// sanm_tpu/solver/anm.py _hybrid_fns (:293-316) on the graph of
// DeformableBody.make_inverse (sanm_tpu/fea/model.py:139-158):
//   Dm = g + bias (the unknown rest shape matrix), F = Ds Dm^-1 with Ds the
//   constant shape matrix of the given (deformed) mesh, and the Cauchy
//   stress of sanm_tpu/fea/material.py:103-125,
//     NHC: sigma = mu J^-1 b - (mu J^-1 + lam J^-1 log J^-1) I,
//     NHI: sigma = mu J^(-5/3) b + ((-mu/3) J^(-5/3) Ic + kap J - kap) I,
//   b = F F^T, Ic = tr b, J = det F,
// which the JAX package interprets with ScanEngine.push / order_bias
// (sanm_tpu/taylor_scan.py:335-346) and the rules _mul_rule, _div_rule
// (batched_inv as adj / det, sanm_tpu/ops/linalg.py:89-102), _log_rule,
// _pow_like_rule and _dot_general_rule (:495-657).  It takes its own
// route to the same series:
//   C_m, d_m = (det Dm)_m           nh_series.h's cofactor_det run on Dm
//   F_m = (N / d)_m, N = Ds C^T     nh_series.h's quotient (div rule), F
//                                   in Q's history slot (F = Ds adj(Dm) /
//                                   det Dm = Ds Dm^-1)
//   b_m  = sum_{t=0..m} F_t F_{m-t}^T, 6 entries
//   J    = det Ds / d,  so  J^-1 = d / det Ds (linear in d)
//   NHC: L = log J^-1:  L_0 = log(d_0 / det Ds), L_m = log_rec of d
//        sigma_m = (mu/det Ds) sum_t d_t b_{m-t}
//                  - (mu d_m + lam sum_t d_t L_{m-t}) / det Ds  I
//   NHI: J_0 = det Ds / d_0, J_m = -(sum_{t=1..m} d_t J_{m-t}) / d_0
//        A = J^(-5/3): A_0 = J_0^p, A_m = pow_rec of J
//        X_m = sum_t A_t b_{m-t}    (the series of A b; its trace is that
//                                    of A Ic)
//        sigma_m = mu X_m + ((-mu/3) tr X_m + kap J_m - kap [m = 0]) I
// Forming b from F, as the JAX graph does, keeps the rounding at about
// cond(Ds) eps; forming it from Dm^-1 (b = Ds Dm^-1 Dm^-T Ds^T) cancels
// terms of cond(Ds)^2 |b|, and on armadillo-small (worst cond 452) that
// cost two digits.  The bias of order m is sigma_m with g_m held at zero;
// at m = 1 every term holds a factor of order 1 and the bias is exactly
// zero.  Every order divides by d_0 (the quotient and log rules; NHI's J
// and pow rules by d_0 and J_0), as K1n divides by J_0.
//
// Histories: hist (order+1, NC, B) float64 in the layout of nh_series.h
// with Dm in F's place and F in Q's (Dm 0-8, C row 0 9-11, F 12-20, d 21),
// then b's upper triangle 22-27 (00 01 02 11 12 22) and the material's
// own: NHC L 28 (NC 29); NHI J 28, A 29 (NC 30).  Each is read by a later
// order.
//
// Bound on the H100: memory.  The launch at k reads the NC history
// components of orders <= k (~9.8 MB per order at B = 42,288, armadillo
// NHC) and does ~(36 + 6 + 18 + 36 + 14) (k+1) + ~150 f64 operations per
// element and pass: the O(k) Cauchy products of the cofactor, det Dm, the
// quotient F, b and the stress's sums, two passes a launch.  At bias
// order 20 that is ~206 MB (~62 us at 3.35 TB/s) against ~0.2 GFLOP (~6
// us at 34 TFLOP/s f64 without tensor cores).  Design: K1's and K1n's:
// one thread per element, histories laid out for coalesced reads, no
// shared memory; the commit and the bias are one launch so the histories
// are read in one pass while still in L2; the material is a template
// parameter.
#include <cuda_runtime.h>

#include "nh_series.h"
#include "sanm_kernels.h"

namespace {

using namespace nh_series;

constexpr int kThreads = 128;
constexpr int cB = 22;           // b's 6 upper entries 22-27
constexpr int cL = 28;           // NHC: L = log J^-1
constexpr int cJJ = 28, cA = 29;  // NHI: J and A = J^(-5/3)
constexpr double kP = -5.0 / 3.0;

enum Material { kNHC = 0, kNHI = 1 };

template <int MAT>
struct Layout {
    static constexpr int NC = MAT == kNHC ? 29 : 30;
};

// the s-th upper-triangle entry (i, j) of a symmetric 3x3, s in 00 01 02
// 11 12 22 order
__device__ __forceinline__ void sym_ij(int s, int& i, int& j) {
    i = s < 3 ? 0 : (s < 5 ? 1 : 2);
    j = s < 3 ? s : (s < 5 ? s - 2 : 2);
}

// F_t (9 values, Q's slot): the order-m coefficient comes from registers.
template <int NC>
__device__ __forceinline__ void load_F9(const Hist<NC>& H, int t, int m,
                                        const double* Fm, double* out) {
    if (t == m) {
        for (int i = 0; i < 9; ++i) out[i] = Fm[i];
    } else {
        for (int i = 0; i < 9; ++i) out[i] = H.get(t, cQ + i);
    }
}

// Order-m pass over histories 0..m-1 with Dm_m = Dmm.  COMMIT: store C_m
// row 0, F_m, d_m, b_m and the material's components (Dm_m stored by the
// caller).  Otherwise (bias, Dmm == 0): write sigma_m to S.
template <int MAT, bool COMMIT>
__device__ void order_pass(const Hist<Layout<MAT>::NC>& H, int m,
                           const double* Dmm, const double* Ds, double detDs,
                           double mu, double c2, double* S) {
    double Cm[9], dm, Nm[9], Fm[9];
    cofactor_det(H, m, Dmm, Cm, dm);
    // ---- F_m = (N / d)_m with N_m = Ds C_m^T ----
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            Nm[i * 3 + j] = Ds[i * 3] * Cm[j * 3] +
                            Ds[i * 3 + 1] * Cm[j * 3 + 1] +
                            Ds[i * 3 + 2] * Cm[j * 3 + 2];
    quotient(H, m, Nm, dm, Fm);
    // ---- b_m = sum_t F_t F_{m-t}^T, upper triangle ----
    double bm[6];
    for (int s = 0; s < 6; ++s) bm[s] = 0.0;
    for (int t = 0; t <= m; ++t) {
        double Fa[9], Fb[9];
        load_F9(H, t, m, Fm, Fa);
        load_F9(H, m - t, m, Fm, Fb);
        for (int s = 0; s < 6; ++s) {
            int i, j;
            sym_ij(s, i, j);
            bm[s] += Fa[i * 3] * Fb[j * 3] + Fa[i * 3 + 1] * Fb[j * 3 + 1] +
                     Fa[i * 3 + 2] * Fb[j * 3 + 2];
        }
    }
    // ---- the material's scalars ----
    double Lm = 0.0, Jm = 0.0, Am = 0.0;
    if (MAT == kNHC) {
        Lm = m == 0 ? log(dm / detDs) : log_rec(H, m, dm, cJ, cL);
    } else {
        if (m == 0) {
            Jm = detDs / dm;
            Am = pow(Jm, kP);
        } else {
            double conv = 0.0;
            for (int t = 1; t <= m; ++t)
                conv += (t == m ? dm : H.get(t, cJ)) * H.get(m - t, cJJ);
            Jm = -conv / H.get(0, cJ);
            Am = pow_rec(H, m, Jm, cJJ, cA, kP);
        }
    }
    if (COMMIT) {
        for (int i = 0; i < 3; ++i) H.set(m, cC + i, Cm[i]);
        for (int i = 0; i < 9; ++i) H.set(m, cQ + i, Fm[i]);
        H.set(m, cJ, dm);
        for (int s = 0; s < 6; ++s) H.set(m, cB + s, bm[s]);
        if (MAT == kNHC) {
            H.set(m, cL, Lm);
        } else {
            H.set(m, cJJ, Jm);
            H.set(m, cA, Am);
        }
        return;
    }
    // ---- sigma_m ----
    // X = sum_t a_t b_{m-t}, a = d (NHC) or A (NHI); NHC also
    // sum_t d_t L_{m-t}
    double X[6], ls = 0.0;
    for (int s = 0; s < 6; ++s) X[s] = 0.0;
    for (int t = 0; t <= m; ++t) {
        double at;
        if (MAT == kNHC)
            at = t == m ? dm : H.get(t, cJ);
        else
            at = t == m ? Am : H.get(t, cA);
        for (int s = 0; s < 6; ++s)
            X[s] += at * (t == 0 ? bm[s] : H.get(m - t, cB + s));
        if (MAT == kNHC) ls += at * (t == 0 ? Lm : H.get(m - t, cL));
    }
    for (int s = 0; s < 6; ++s) {
        int i, j;
        sym_ij(s, i, j);
        S[i * 3 + j] = S[j * 3 + i] = X[s];
    }
    if (MAT == kNHC) {
        const double lam = c2, diag = (mu * dm + lam * ls) / detDs;
        for (int i = 0; i < 9; ++i) S[i] *= mu / detDs;
        S[0] -= diag;
        S[4] -= diag;
        S[8] -= diag;
    } else {
        const double kap = c2;
        const double diag = (-mu / 3.0) * (X[0] + X[3] + X[5]) + kap * Jm -
                            (m == 0 ? kap : 0.0);
        for (int i = 0; i < 9; ++i) S[i] *= mu;
        S[0] += diag;
        S[4] += diag;
        S[8] += diag;
    }
}

template <int MAT>
__global__ void inv_step_kernel(double* __restrict__ hist,
                                const double* __restrict__ gin,
                                const double* __restrict__ bias,
                                const double* __restrict__ ds,
                                double* __restrict__ bias_out, int64_t B,
                                int k, double mu, double c2, int want_bias) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    Hist<Layout<MAT>::NC> H{hist, B, b};
    double Ds[9], Dk[9];
    for (int i = 0; i < 9; ++i) {
        Ds[i] = ds[b * 9 + i];
        Dk[i] = k == 0 ? gin[b * 9 + i] + bias[b * 9 + i] : gin[b * 9 + i];
    }
    const double detDs = Ds[0] * (Ds[4] * Ds[8] - Ds[5] * Ds[7]) -
                         Ds[1] * (Ds[3] * Ds[8] - Ds[5] * Ds[6]) +
                         Ds[2] * (Ds[3] * Ds[7] - Ds[4] * Ds[6]);
    for (int i = 0; i < 9; ++i) H.set(k, cF + i, Dk[i]);
    order_pass<MAT, true>(H, k, Dk, Ds, detDs, mu, c2, nullptr);
    if (want_bias) {
        double zero[9], S[9];
        for (int i = 0; i < 9; ++i) zero[i] = 0.0;
        order_pass<MAT, false>(H, k + 1, zero, Ds, detDs, mu, c2, S);
        for (int i = 0; i < 9; ++i) bias_out[b * 9 + i] = S[i];
    }
}

template <int MAT>
int inv_step(double* hist, const double* gin, const double* bias,
             const double* ds, double* bias_out, int64_t B, int k, int order,
             double mu, double c2, int want_bias, cudaStream_t s) {
    if (k < 0 || k > order || (want_bias && k + 1 > order))
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        inv_step_kernel<MAT><<<(unsigned)((B + kThreads - 1) / kThreads),
                               kThreads, 0, s>>>(hist, gin, bias, ds,
                                                 bias_out, B, k, mu, c2,
                                                 want_bias);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sanm_inv_nhc_step(double* hist, const double* gin,
                                 const double* bias, const double* ds,
                                 double* bias_out, int64_t B, int k,
                                 int order, double mu, double lam,
                                 int want_bias, void* stream) {
    return inv_step<kNHC>(hist, gin, bias, ds, bias_out, B, k, order, mu,
                          lam, want_bias, (cudaStream_t)stream);
}

extern "C" int sanm_inv_nhi_step(double* hist, const double* gin,
                                 const double* bias, const double* ds,
                                 double* bias_out, int64_t B, int k,
                                 int order, double mu, double kappa,
                                 int want_bias, void* stream) {
    return inv_step<kNHI>(hist, gin, bias, ds, bias_out, B, k, order, mu,
                          kappa, want_bias, (cudaStream_t)stream);
}
