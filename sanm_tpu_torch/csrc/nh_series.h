// What the Neo-Hookean series steps share: K1 (nhc_series.cu), K1n
// (nhi_series.cu) and the inverse model's K1i (inv_series.cu); the StVK
// step K1s (stvk_series.cu) reads its F_k and histories through Hist,
// load_F and order_f.  Both Neo-Hookean forward stresses read F, J = det F
// and Q = F^-T, so both keep the same first 22 history components and the
// same order-m recurrences for them:
//   F_m  = g_m Dm^-1 (plus the bias at m = 0)
//   C_m  = sum_{t=0..m} minor products of F_t and F_{m-t}     (cofactor)
//   J_m  = sum_{t=0..m} F_t[0,:] . C_{m-t}[0,:]
//   Q_m  = (C_m - Q_0 J_m - sum_{0<t<m} Q_t J_{m-t}) / J_0    (div rule)
// K1i runs the cofactor and det recurrences (cofactor_det) on the rest
// shape matrix Dm in F's place, and the div rule (quotient) on
// F = Ds C^T / det Dm in Q's place.  The log rule (log_rec: K1's log J,
// K1i's log J^-1) and the power rule (pow_rec: K1n's J^(-2/3), K1i's
// J^(-5/3)) are shared too.
//
// Histories: hist (order+1, NC, B) float64, element index fastest, so a
// warp's loads of one component are one contiguous run; components F 0-8,
// C row 0 9-11 (J is the only later reader of C, and it reads row 0),
// Q 12-20, J 21, then the material's own from 22.
#pragma once
#include <cstdint>

namespace nh_series {

constexpr int cF = 0, cC = 9, cQ = 12, cJ = 21;

template <int NC>
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
template <int NC>
__device__ __forceinline__ void load_F(const Hist<NC>& H, int t, int m,
                                       const double* Fm, double* out) {
    if (t == m) {
        for (int i = 0; i < 9; ++i) out[i] = Fm[i];
    } else {
        for (int i = 0; i < 9; ++i) out[i] = H.get(t, cF + i);
    }
}

// F_k = g_k Dm^-1 of element b (the bias added at k = 0).
__device__ __forceinline__ void order_f(const double* __restrict__ gin,
                                        const double* __restrict__ bias,
                                        const double* __restrict__ dminv,
                                        int64_t b, int k, double* Fk) {
    double g[9];
    for (int i = 0; i < 9; ++i)
        g[i] = k == 0 ? gin[b * 9 + i] + bias[b * 9 + i] : gin[b * 9 + i];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double acc = 0.0;
            for (int l = 0; l < 3; ++l)
                acc += g[i * 3 + l] * dminv[b * 9 + l * 3 + j];
            Fk[i * 3 + j] = acc;
        }
}

// C_m and J_m of order m from the histories of orders < m and F_m = Fm.
template <int NC>
__device__ __forceinline__ void cofactor_det(const Hist<NC>& H, int m,
                                             const double* Fm, double* Cm,
                                             double& Jm) {
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
    for (int i = 0; i < 9; ++i) {
        double mnr = s1[i] - s2[i];
        Cm[i] = (((i / 3) + (i % 3)) & 1) ? -mnr : mnr;
    }
    // ---- J_m = sum_t F_t[0,:] . C_{m-t}[0,:] ----
    Jm = 0.0;
    for (int t = 0; t <= m; ++t) {
        for (int j = 0; j < 3; ++j) {
            double f = t == m ? Fm[j] : H.get(t, cF + j);
            double c = t == 0 ? Cm[j] : H.get(m - t, cC + j);
            Jm += f * c;
        }
    }
}

// Q_m of Q = N / J (the div rule) from the histories of Q (cQ) and J (cJ)
// of orders < m, N_m = Nm and J_m = Jm.
template <int NC>
__device__ __forceinline__ void quotient(const Hist<NC>& H, int m,
                                         const double* Nm, double Jm,
                                         double* Qm) {
    if (m == 0) {
        for (int i = 0; i < 9; ++i) Qm[i] = Nm[i] / Jm;
        return;
    }
    const double J0 = H.get(0, cJ);
    for (int i = 0; i < 9; ++i) {
        double conv = 0.0;
        for (int t = 1; t < m; ++t)
            conv += H.get(t, cQ + i) * H.get(m - t, cJ);
        Qm[i] = (Nm[i] - H.get(0, cQ + i) * Jm - conv) / J0;
    }
}

// C_m, J_m and Q_m = (F^-T)_m of order m from the histories of orders < m
// and F_m = Fm.
template <int NC>
__device__ __forceinline__ void cofactor_terms(const Hist<NC>& H, int m,
                                               const double* Fm, double* Cm,
                                               double& Jm, double* Qm) {
    cofactor_det(H, m, Fm, Cm, Jm);
    quotient(H, m, Cm, Jm, Qm);
}

// L_m (m >= 1) of L = log x, from the histories of x (component cx) and
// of L (cl) and x_m = xm:
//   L_m = x_m / x_0 - (sum_{0<t<m} (t/m) L_t x_{m-t}) / x_0      (log rule)
template <int NC>
__device__ __forceinline__ double log_rec(const Hist<NC>& H, int m,
                                          double xm, int cx, int cl) {
    const double x0 = H.get(0, cx);
    double conv = 0.0;
    for (int t = 1; t < m; ++t)
        conv += H.get(t, cl) * H.get(m - t, cx) * ((double)t / m);
    return xm / x0 + (-conv / x0);
}

// A_m (m >= 1) of A = x^p, from the histories of x (cx) and of A (ca) and
// x_m = xm:
//   A_m = (p A_0 / x_0) x_m
//         + (1/x_0) sum_{i=1..m-1} ((i/m)(p+1) - 1) x_i A_{m-i}   (pow rule)
template <int NC>
__device__ __forceinline__ double pow_rec(const Hist<NC>& H, int m,
                                          double xm, int cx, int ca,
                                          double p) {
    const double x0 = H.get(0, cx), a0 = H.get(0, ca);
    double conv = 0.0;
    for (int i = 1; i < m; ++i)
        conv += ((double)i / m * (p + 1.0) - 1.0) *
                (H.get(i, cx) * H.get(m - i, ca));
    return (p * a0 / x0) * xm + conv / x0;
}

}  // namespace nh_series
