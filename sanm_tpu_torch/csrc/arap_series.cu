// K8b: one order of the ARAP Taylor series per element: commit order k,
// then the order-(k+1) bias of the stress.
//
// Replaces the JAX package's per-order step for the ARAP graph
// P = mu (F - W), W = polar_w(F), F = (g + bias) Dm^-1: the svd_w Taylor
// rule in polar mode (_svd_taylor_pw, sanm_tpu/ops/svd_w.py:295, and the
// pw branch of _svd_scan_rule, :469-508) with the symmetric-paired
// convolutions of ScanEngine.buf_conv_sym (sanm_tpu/taylor_scan.py:250),
// run by step_fn of sanm_tpu/solver/anm.py:293.  Per element and order m,
// with S = U S U^T the symmetric stretch (the rule's "P"):
//   Bm  = sum_{0<i<m} M_i M_{m-i}^T   (i < m/2 summed, mirrored, + middle)
//   Bp  = sum_{0<i<m} S_i S_{m-i}     (the same pairing; every S_i is
//                                      symmetric)
//   Bpw = sum_{0<i<m} S_i W_{m-i}
//   e   = U0^T (Bm - Bp) U0 + (U0^T M_m V0) diag(s0)
//         + diag(s0) (U0^T M_m V0)^T
//   S_m = U0 z U0^T,  z_ij = clip_div(e_ij, s0_i + s0_j)
//   W_m = U0 diag(clip_div(1, s0)) U0^T (M_m - S_m W0 - Bpw)
//   P_m = mu (M_m - W_m)
// with clip_div(x, y) = x y / (y^2 + 1e-12).  The bias of order m is P_m
// with M_m = 0 (g_m held at zero).  Order 0 (F0 and its SVD-W, K8a) is
// committed by the caller.
//
// Histories: hist (order+2, 24, B) float64: per order row M 0-8, S as its
// 6 unique entries (00, 01, 02, 11, 12, 22) 9-14, W 15-23; row order+1
// holds U0 0-8, s0 9-11, V0 = W0^T U0 12-20.  Element index fastest, so
// a warp's loads of one component are one contiguous run.
//
// Bound on the H100: memory.  The launch at k must read the 24 components
// of orders 1..k-1, W0 (9), the constants row (21), g_k and Dm^-1 (18),
// and write order k (24) and the bias (9); order k itself is computed
// here, so its second use in the bias pass costs no traffic at the bound:
// 24 k + 57 doubles an element, at k ~ 10 and B = 42,288 ~2.4 kB, ~100 MB,
// ~30 us at 3.35 TB/s, against ~100 k f64 operations an element (~1.3 us
// at 34 TFLOP/s).  Design: one thread per element, no shared memory, the
// commit and the bias in one launch.  The commit recomputes the order-k
// sums that the previous launch's bias pass formed (the JAX rule caches
// them); the second read of the histories is partly served by the L2.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int NC = 24;
constexpr int cM = 0, cS = 9, cW = 15;  // per-order row
constexpr int cU = 0, cs = 9, cV = 12;  // constants row (order + 1)
constexpr double kClipEps = 1e-12;      // ops/svd_w.py CLIP_EPS

struct Hist {
    double* h;
    int64_t B, b;
    __device__ double get(int t, int c) const {
        return h[((int64_t)t * NC + c) * B + b];
    }
    __device__ void set(int t, int c, double v) const {
        h[((int64_t)t * NC + c) * B + b] = v;
    }
    __device__ void load9(int t, int c0, double* x) const {
        for (int i = 0; i < 9; ++i) x[i] = get(t, c0 + i);
    }
    __device__ void load_sym(int t, double* x) const {
        const double a00 = get(t, cS), a01 = get(t, cS + 1),
                     a02 = get(t, cS + 2), a11 = get(t, cS + 3),
                     a12 = get(t, cS + 4), a22 = get(t, cS + 5);
        x[0] = a00; x[1] = a01; x[2] = a02;
        x[3] = a01; x[4] = a11; x[5] = a12;
        x[6] = a02; x[7] = a12; x[8] = a22;
    }
};

__device__ inline double clip_div(double x, double y) {
    return x * y / (y * y + kClipEps);
}

// c = Bm - Bp and bpw = Bpw of order m from the committed orders 1..m-1.
__device__ void conv_sums(const Hist& H, int m, double* c, double* bpw) {
    double am[9], ap[9];
    for (int i = 0; i < 9; ++i) am[i] = ap[i] = bpw[i] = 0.0;
    for (int i = 1; 2 * i < m; ++i) {
        double X[9], Y[9];
        H.load9(i, cM, X);
        H.load9(m - i, cM, Y);
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                am[r * 3 + q] += X[r * 3] * Y[q * 3] + X[r * 3 + 1] * Y[q * 3 + 1] +
                                 X[r * 3 + 2] * Y[q * 3 + 2];
        H.load_sym(i, X);
        H.load_sym(m - i, Y);
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                ap[r * 3 + q] += X[r * 3] * Y[q] + X[r * 3 + 1] * Y[3 + q] +
                                 X[r * 3 + 2] * Y[6 + q];
    }
    double bm[9], bp[9];
    for (int r = 0; r < 3; ++r)
        for (int q = 0; q < 3; ++q) {
            bm[r * 3 + q] = am[r * 3 + q] + am[q * 3 + r];
            bp[r * 3 + q] = ap[r * 3 + q] + ap[q * 3 + r];
        }
    if (m % 2 == 0 && m >= 2) {
        double X[9];
        H.load9(m / 2, cM, X);
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                bm[r * 3 + q] += X[r * 3] * X[q * 3] + X[r * 3 + 1] * X[q * 3 + 1] +
                                 X[r * 3 + 2] * X[q * 3 + 2];
        H.load_sym(m / 2, X);
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                bp[r * 3 + q] += X[r * 3] * X[q] + X[r * 3 + 1] * X[3 + q] +
                                 X[r * 3 + 2] * X[6 + q];
    }
    for (int i = 0; i < 9; ++i) c[i] = bm[i] - bp[i];
    for (int i = 1; i < m; ++i) {
        double X[9], Y[9];
        H.load_sym(i, X);
        H.load9(m - i, cW, Y);
        for (int r = 0; r < 3; ++r)
            for (int q = 0; q < 3; ++q)
                bpw[r * 3 + q] += X[r * 3] * Y[q] + X[r * 3 + 1] * Y[3 + q] +
                                  X[r * 3 + 2] * Y[6 + q];
    }
}

// Order-m pass.  COMMIT: store M_m (= Mm), S_m and W_m.  Otherwise (the
// bias, Mm == 0): write P_m = mu (0 - W_m) to P.
template <bool COMMIT>
__device__ void order_pass(const Hist& H, int m, const double* Mm, int R,
                           double mu, double* P) {
    double c[9], bpw[9];
    conv_sums(H, m, c, bpw);
    double U[9], s[3];
    H.load9(R, cU, U);
    for (int i = 0; i < 3; ++i) s[i] = H.get(R, cs + i);
    // e = (U^T c) U
    double T[9], e[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            T[i * 3 + j] = U[i] * c[j] + U[3 + i] * c[3 + j] + U[6 + i] * c[6 + j];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            e[i * 3 + j] = T[i * 3] * U[j] + T[i * 3 + 1] * U[3 + j] +
                           T[i * 3 + 2] * U[6 + j];
    if (COMMIT) {
        // umv = (U^T M_m) V0; e += umv diag(s) + diag(s) umv^T
        double V[9], umv[9];
        H.load9(R, cV, V);
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                T[i * 3 + j] = U[i] * Mm[j] + U[3 + i] * Mm[3 + j] +
                               U[6 + i] * Mm[6 + j];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                umv[i * 3 + j] = T[i * 3] * V[j] + T[i * 3 + 1] * V[3 + j] +
                                 T[i * 3 + 2] * V[6 + j];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                e[i * 3 + j] = e[i * 3 + j] + umv[i * 3 + j] * s[j] +
                               s[i] * umv[j * 3 + i];
    }
    // S_m = (U z) U^T
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            e[i * 3 + j] = clip_div(e[i * 3 + j], s[i] + s[j]);  // z
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            T[i * 3 + j] = U[i * 3] * e[j] + U[i * 3 + 1] * e[3 + j] +
                           U[i * 3 + 2] * e[6 + j];
    double S[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            S[i * 3 + j] = T[i * 3] * U[j * 3] + T[i * 3 + 1] * U[j * 3 + 1] +
                           T[i * 3 + 2] * U[j * 3 + 2];
    // resid = M_m - S_m W0 - Bpw
    double W0[9], res[9];
    H.load9(0, cW, W0);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            res[i * 3 + j] = (Mm[i * 3 + j] -
                              (S[i * 3] * W0[j] + S[i * 3 + 1] * W0[3 + j] +
                               S[i * 3 + 2] * W0[6 + j])) -
                             bpw[i * 3 + j];
    // W_m = (U diag(1/s) U^T) resid
    double sinv[3];
    for (int i = 0; i < 3; ++i) sinv[i] = clip_div(1.0, s[i]);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            T[i * 3 + j] = U[i * 3] * sinv[0] * U[j * 3] +
                           U[i * 3 + 1] * sinv[1] * U[j * 3 + 1] +
                           U[i * 3 + 2] * sinv[2] * U[j * 3 + 2];
    double Wm[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            Wm[i * 3 + j] = T[i * 3] * res[j] + T[i * 3 + 1] * res[3 + j] +
                            T[i * 3 + 2] * res[6 + j];
    if (COMMIT) {
        for (int i = 0; i < 9; ++i) H.set(m, cM + i, Mm[i]);
        H.set(m, cS + 0, S[0]);
        H.set(m, cS + 1, S[1]);
        H.set(m, cS + 2, S[2]);
        H.set(m, cS + 3, S[4]);
        H.set(m, cS + 4, S[5]);
        H.set(m, cS + 5, S[8]);
        for (int i = 0; i < 9; ++i) H.set(m, cW + i, Wm[i]);
        return;
    }
    for (int i = 0; i < 9; ++i) P[i] = (0.0 - Wm[i]) * mu;
}

__global__ void arap_step_kernel(double* __restrict__ hist,
                                 const double* __restrict__ gin,
                                 const double* __restrict__ dminv,
                                 double* __restrict__ bias_out, int64_t B,
                                 int k, int order, double mu, int want_bias) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    Hist H{hist, B, b};
    const int R = order + 1;
    // M_k = g_k Dm^-1 (k >= 1: the bias of Ds is an order-0 term)
    double Mk[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double acc = 0.0;
            for (int l = 0; l < 3; ++l)
                acc += gin[b * 9 + i * 3 + l] * dminv[b * 9 + l * 3 + j];
            Mk[i * 3 + j] = acc;
        }
    order_pass<true>(H, k, Mk, R, mu, nullptr);
    if (want_bias) {
        double zero[9], P[9];
        for (int i = 0; i < 9; ++i) zero[i] = 0.0;
        order_pass<false>(H, k + 1, zero, R, mu, P);
        for (int i = 0; i < 9; ++i) bias_out[b * 9 + i] = P[i];
    }
}

}  // namespace

extern "C" int sanm_arap_step(double* hist, const double* gin,
                              const double* dminv, double* bias_out,
                              int64_t B, int k, int order, double mu,
                              int want_bias, void* stream) {
    if (k < 1 || k > order || (want_bias && k + 1 > order))
        return (int)cudaErrorInvalidValue;
    if (B > 0)
        arap_step_kernel<<<(unsigned)((B + kThreads - 1) / kThreads),
                           kThreads, 0, (cudaStream_t)stream>>>(
            hist, gin, dminv, bias_out, B, k, order, mu, want_bias);
    return (int)cudaGetLastError();
}
