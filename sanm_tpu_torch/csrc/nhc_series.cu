// K1: one order of the NHC Taylor series per element: commit order k,
// then the order-(k+1) bias of the stress.
//
// Replaces the fused commit(k) + bias(k+1) step_fn of
// sanm_tpu/solver/anm.py _hybrid_fns (:293-316), which interprets the NHC
// pk1 jaxpr with ScanEngine.push / order_bias (sanm_tpu/taylor_scan.py
// :335-346) and the rules _mul_rule, _div_rule, _log_rule and
// _dot_general_rule (:495-657).  Specialised to this graph:
//   F = (g + bias) Dm^-1, C = cof(F), J = det F = F[0,:] . C[0,:],
//   Q = F^-T = C / J, L = log J,  P = mu F - mu Q + lam L Q.
// Per element and order m (Cauchy products over the histories):
//   C_m  = sum_{t=0..m} minor products of F_t and F_{m-t}
//   J_m  = sum_{t=0..m} F_t[0,:] . C_{m-t}[0,:]
//   Q_m  = (C_m - Q_0 J_m - sum_{0<t<m} Q_t J_{m-t}) / J_0       (div rule)
//   L_m  = J_m / J_0 - (sum_{0<t<m} (t/m) L_t J_{m-t}) / J_0     (log rule)
//   P_m  = mu F_m - mu Q_m + lam sum_{t=0..m} L_t Q_{m-t}
// The bias of order m is P_m with the input coefficient g_m held at zero;
// at m = 1 every sum is empty and the bias is exactly zero.
//
// Histories: hist (order+1, 23, B) float64: components F 0-8, C row 0
// 9-11 (J is the only later reader of C, and it reads row 0), Q 12-20,
// J 21, L 22; element index fastest, so a warp's loads of one component
// are one contiguous run.
//
// Bound on the H100: memory.  The launch at k reads the 23 history
// components of orders < k+1 (~7.8 MB per order at B = 42,288) and does
// ~160 (k+1) f64 flops per element; at bias order 20 that is ~165 MB
// (~49 us at 3.35 TB/s) against ~0.14 GFLOP (~4 us at 34 TFLOP/s f64
// without tensor cores).  Design: one thread per element, histories laid out for
// coalesced reads, no shared memory; the commit and the bias are one
// launch so the histories are read in one pass while still in L2.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int NC = 23;
constexpr int cF = 0, cC = 9, cQ = 12, cJ = 21, cL = 22;

struct Hist {
    double* h;
    int64_t B, b;
    __device__ double get(int t, int c) const {
        return h[((int64_t)t * NC + c) * B + b];
    }
    __device__ void set(int t, int c, double v) const {
        h[((int64_t)t * NC + c) * B + b] = v;
    }
};

// F_t as 9 values: the order-m coefficient comes from registers.
__device__ inline void load_F(const Hist& H, int t, int m,
                              const double* Fm, double* out) {
    if (t == m) {
        for (int i = 0; i < 9; ++i) out[i] = Fm[i];
    } else {
        for (int i = 0; i < 9; ++i) out[i] = H.get(t, cF + i);
    }
}

// Order-m pass.  COMMIT: store C_m row 0, Q_m, J_m, L_m (F_m stored by
// the caller).
// Otherwise (bias, Fm == 0): write P_m to P.
template <bool COMMIT>
__device__ void order_pass(const Hist& H, int m, const double* Fm,
                           double mu, double lam, double* P) {
    // ---- C_m: two Cauchy sums per minor, then the sign ----
    double s1[9], s2[9];
    for (int i = 0; i < 9; ++i) s1[i] = s2[i] = 0.0;
    for (int t = 0; t <= m; ++t) {
        double A[9], Bv[9];
        load_F(H, t, m, Fm, A);
        load_F(H, m - t, m, Fm, Bv);
        for (int i = 0; i < 3; ++i) {
            const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
            for (int j = 0; j < 3; ++j) {
                const int c0 = j == 0 ? 1 : 0, c1 = j == 2 ? 1 : 2;
                s1[i * 3 + j] += A[r0 * 3 + c0] * Bv[r1 * 3 + c1];
                s2[i * 3 + j] += A[r0 * 3 + c1] * Bv[r1 * 3 + c0];
            }
        }
    }
    double Cm[9];
    for (int i = 0; i < 9; ++i) {
        double mnr = s1[i] - s2[i];
        Cm[i] = (((i / 3) + (i % 3)) & 1) ? -mnr : mnr;
    }
    // ---- J_m = sum_t F_t[0,:] . C_{m-t}[0,:] ----
    double Jm = 0.0;
    for (int t = 0; t <= m; ++t) {
        for (int j = 0; j < 3; ++j) {
            double f = t == m ? Fm[j] : H.get(t, cF + j);
            double c = t == 0 ? Cm[j] : H.get(m - t, cC + j);
            Jm += f * c;
        }
    }
    double Qm[9], Lm;
    if (m == 0) {
        for (int i = 0; i < 9; ++i) Qm[i] = Cm[i] / Jm;
        Lm = log(Jm);
    } else {
        const double J0 = H.get(0, cJ);
        for (int i = 0; i < 9; ++i) {
            double conv = 0.0;
            for (int t = 1; t < m; ++t)
                conv += H.get(t, cQ + i) * H.get(m - t, cJ);
            Qm[i] = (Cm[i] - H.get(0, cQ + i) * Jm - conv) / J0;
        }
        double conv = 0.0;
        for (int t = 1; t < m; ++t)
            conv += H.get(t, cL) * H.get(m - t, cJ) * ((double)t / m);
        Lm = Jm / J0 + (-conv / J0);
    }
    if (COMMIT) {
        for (int i = 0; i < 3; ++i) H.set(m, cC + i, Cm[i]);
        for (int i = 0; i < 9; ++i) H.set(m, cQ + i, Qm[i]);
        H.set(m, cJ, Jm);
        H.set(m, cL, Lm);
        return;
    }
    // ---- P_m = mu F_m - mu Q_m + lam sum_t L_t Q_{m-t} ----
    for (int i = 0; i < 9; ++i) {
        double conv = 0.0;
        for (int t = 0; t <= m; ++t) {
            double l = t == m ? Lm : H.get(t, cL);
            double q = t == 0 ? Qm[i] : H.get(m - t, cQ + i);
            conv += (lam * l) * q;
        }
        P[i] = (mu * Fm[i] - mu * Qm[i]) + conv;
    }
}

__global__ void nhc_step_kernel(double* __restrict__ hist,
                                const double* __restrict__ gin,
                                const double* __restrict__ bias,
                                const double* __restrict__ dminv,
                                double* __restrict__ bias_out, int64_t B,
                                int k, double mu, double lam, int want_bias) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    Hist H{hist, B, b};
    double g[9], Fk[9];
    for (int i = 0; i < 9; ++i)
        g[i] = k == 0 ? gin[b * 9 + i] + bias[b * 9 + i] : gin[b * 9 + i];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double acc = 0.0;
            for (int l = 0; l < 3; ++l)
                acc += g[i * 3 + l] * dminv[b * 9 + l * 3 + j];
            Fk[i * 3 + j] = acc;
        }
    for (int i = 0; i < 9; ++i) H.set(k, cF + i, Fk[i]);
    order_pass<true>(H, k, Fk, mu, lam, nullptr);
    if (want_bias) {
        double zero[9], P[9];
        for (int i = 0; i < 9; ++i) zero[i] = 0.0;
        order_pass<false>(H, k + 1, zero, mu, lam, P);
        for (int i = 0; i < 9; ++i) bias_out[b * 9 + i] = P[i];
    }
}

}  // namespace

extern "C" int sanm_nhc_step(double* hist, const double* gin,
                             const double* bias, const double* dminv,
                             double* bias_out, int64_t B, int k, int order,
                             double mu, double lam, int want_bias,
                             void* stream) {
    if (k < 0 || k > order || (want_bias && k + 1 > order))
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        nhc_step_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads,
                          0, (cudaStream_t)stream>>>(
            hist, gin, bias, dminv, bias_out, B, k, mu, lam, want_bias);
    return (int)cudaGetLastError();
}
