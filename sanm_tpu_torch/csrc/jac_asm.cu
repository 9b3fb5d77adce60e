// K3, K3n, K3s, K8c and K3i: element Jacobian of the stress and the
// condensed CSR assembly, for the NHC (K3), the NHI (K3n), the StVK
// stretch (K3s) and the ARAP (K8c) material and for the inverse model's
// NHC and NHI Cauchy stress (K3i); K3t: the assembled t column (grad_t) of the implicit continuation.
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
// Design: the Jacobian is closed form, not forward-mode, and is the one
// part that depends on the material: the device function Jac::fill,
// chosen by the template parameter of elem_stiffness_kernel, with which
// every lane of the warp rebuilds the element's factors from its inputs
// and writes its share of the 81 entries.  For the forward materials
// fill is Chained<Mat>: Mat::dpdf writes the F-space part
// D[(i,j), (m,l)] = dP_ij/dF_ml to shared memory, and the chain through
// F = (g + bias) Dm^-1 gives Jg[(i,j), (m,n)] = sum_l D[(i,j), (m,l)]
// Dm^-1_nl; K10's Projected<Mat> projects D before the same chain.
//   NHC:  P = mu F - mu F^-T + lam log(J) F^-T,  G = F^-1,
//         dP_ij/dF_ml = mu d_im d_jl + (mu - lam log J) G_jm G_li
//                       + lam G_ji G_lm.
//   NHI:  P = mu A F + c F^-T, A = J^(-2/3),
//         c = (-mu/3) A Ic + kap J^2 - kap J (sanm_tpu/fea/material.py:80),
//         dP_ij/dF_ml = mu A d_im d_jl - (2/3) mu A F_ij G_lm
//                       + G_ji [d1 G_lm - (2/3) mu A F_ml] - c G_jm G_li,
//         d1 = (2mu/9) A Ic + 2 kap J^2 - kap J.
//         K3n replaces the same batched_jacobian + assemble_csr_elem on
//         the NHI graph; its bound is K3's (the same bytes, ~40 more
//         operations an entry).
//   StVK: P = mu (F F^T F - F) (sanm_tpu/fea/material.py:95-100),
//         dP = mu (dF F^T F + F dF^T F + F F^T dF - dF), so with
//         C = F^T F and b = F F^T
//         dP_ij/dF_ml = mu (d_im C_lj + F_il F_mj + b_im d_jl - d_im d_jl).
//         K3s replaces batched_jacobian + assemble_csr_elem on the StVK
//         graph; its bound is K3's (the same bytes; ~100 operations an
//         element for F, C and b, ~4 an entry).
//   ARAP: P = mu (F - W), W = polar_w(F), from K8a's U, s, W of F (the
//         JVP of sanm_tpu/ops/svd_w.py:173): for dF = e_m e_l^T,
//         A = U^T dF V = U[m, :]^T V[l, :],
//         X = clip_div(A - A^T, s_p + s_q), dW = (U X) V^T, V = W^T U,
//         dP = mu (dF - dW).
//   Inverse (K3i, K3i-nhi): the Cauchy stress of the inverse model's graph
//         (sanm_tpu/fea/model.py:139-158), whose unknowns are the rest
//         shape: Dm = g + bias, Y = Dm^-1, F = Ds Y with Ds constant;
//         for dg = e_m e_n^T, dF = -F e_m Y[n, :] (dF_ij = -F_im Y_nj),
//         y = Y_nm, b = F F^T, R = F Y^T, so
//         db_ij = -F_im R_jn - R_in F_jm, dJ = -J y, dIc = -2 (F^T R)_mn.
//     NHC: sigma = mu J^-1 b - (mu J^-1 + lam J^-1 log J^-1) I,
//         dsigma_ij = mu J^-1 (y b_ij - F_im R_jn - R_in F_jm)
//                     - J^-1 y (mu + lam (log J^-1 + 1)) d_ij.
//     NHI: sigma = mu A b + ((-mu/3) A Ic + kap J - kap) I, A = J^(-5/3),
//         dsigma_ij = mu A ((5/3) y b_ij - F_im R_jn - R_in F_jm)
//                     + ((-mu/3) A ((5/3) y Ic - 2 (F^T R)_mn)
//                        - kap J y) d_ij.
//         K3i replaces batched_jacobian + assemble_csr_elem on those graphs
//         (the JAX package's forward-mode Jacobian through batched_inv);
//         its bound is K3's (the same bytes; ~50 more operations an
//         entry).  This Jacobian is not symmetric: the solve stays on
//         host LU (solver/anm.py).
// One warp per element: the warp fills the 9x9 Jacobian, the Dout x 9
// product Lout J and the Dout x Din E through shared memory.  The
// scatter-add into CSR is inverted on the host (nnz -> its slots,
// ascending), so a second kernel sums each value in a fixed order without
// atomics: the assembled matrix has the same bits on every run.
//
// K3t replaces the grad_t half of assemble_csr_elem
// (sanm_tpu/solver/remap.py:366-372: a scatter-add of E's t-column slots
// over t_slot_row, built at :273-277), which the implicit solver runs once
// per restart.  Its scatter is inverted on the host too (row -> its
// t-column slots, ascending), and the same segment-gather kernel as the
// CSR values sums each row in that fixed order: grad_t enters the
// expansion's first solve and with it Pade's accept/reject, which can flip
// on the last bit.  It is its own launch after K3/K3n/K8c rather than
// more rows of the CSR gather's grid: the launch costs a few microseconds
// once per restart, the gravity path's entry points stay as they are,
// and the pass can be held against its plain version and timed alone.
// Bound on the H100: memory, and tiny.  At armadillo-small's bend (n =
// 33,345 rows, 12,276 t-column slots in 837 rows) it reads the row
// pointers, the slot indices and the E values they name and writes n
// doubles: ~0.55 MB, 0.16 us at 3.35 TB/s, so the launch is its time.
//
// K10 replaces _Kernels.hess_blocks of sanm_tpu/fea/baseline.py (:178-207:
// the 9x9 dP/dF by nine JVPs on the device, the eigen-projection
// D+ = V max(L, 0) V^T of sym(dP/dF) in host NumPy, vol G^T D+ G), the
// projected element Hessian of the Newton baseline, once per projected
// Newton iteration.  It is a Jac policy of elem_stiffness_kernel,
// Projected<Mat>: the material's F-space part Mat::dpdf is symmetrised
// and projected by the element's warp in shared memory, then chained to
// g as in Chained<Mat>; K3's Lout/Lin contraction and segment gather
// then give the CSR values of -H+ (the sign of the ANM Jacobian, whose
// unprojected form is exactly minus the energy Hessian).  The projection
// is a cyclic Jacobi eigensolver: round-robin pairs, 4 disjoint rotations
// a step, 9 steps a sweep, until the off-diagonal norm is at most
// 1e-15 ||D||_F or after kMaxSweeps sweeps.  Jacobi is well behaved on
// the degenerate spectra of the rest state (three zero eigenvalues),
// where the TPU's emulated-f64 eigh gave NaN; D+ is unique even where V
// is not.  Bound on the H100: memory, as K3's (the same ~200 MB at
// armadillo-small, ~0.05 ms).  The function needs ~1.4e4 f64 operations
// an element: dP/dF, a symmetric 9x9 eigensolve with vectors (~9 n^3 =
// 6,561), the reconstruction, the chain and K3's contraction (~4,500);
// ~6e8 in all, ~0.02 ms at 34 TFLOP/s.  Jacobi does several times the
// eigensolve's share (~6,400 operations a sweep).
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kWarps = 4;    // elements per block
constexpr int kMaxD = 16;    // max Dout and Din taken (tets: 12)
constexpr int kThreads = 256;

constexpr double kClipEps = 1e-12;  // ops/svd_w.py CLIP_EPS

// Dm^-1 (M) and F = (g0 + bias) M of element b.
__device__ __forceinline__ void forward_f(const double* __restrict__ gin0,
                                          const double* __restrict__ bias,
                                          const double* __restrict__ dminv,
                                          int64_t b, double* M, double* F) {
    for (int i = 0; i < 9; ++i) M[i] = dminv[b * 9 + i];
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
}

// What both Neo-Hookean materials read: Dm^-1 (M), F = (g0 + bias) M,
// G = F^-1 = cof(F)^T / J and J = det F.
__device__ __forceinline__ void nh_factors(const double* __restrict__ gin0,
                                           const double* __restrict__ bias,
                                           const double* __restrict__ dminv,
                                           int64_t b, double* M, double* F,
                                           double* G, double& J) {
    forward_f(gin0, bias, dminv, b, M, F);
    // cofactor C, J = det F, G = F^-1 = C^T / J
    double C[9];
    for (int i = 0; i < 3; ++i) {
        const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
        for (int j = 0; j < 3; ++j) {
            const int k0 = j == 0 ? 1 : 0, k1 = j == 2 ? 1 : 2;
            double mnr = F[r0 * 3 + k0] * F[r1 * 3 + k1] -
                         F[r0 * 3 + k1] * F[r1 * 3 + k0];
            C[i * 3 + j] = ((i + j) & 1) ? -mnr : mnr;
        }
    }
    J = F[0] * C[0] + F[1] * C[1] + F[2] * C[2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) G[i * 3 + j] = C[j * 3 + i] / J;
}

// The NHC material's F-space part: sD[(i,j), (m,l)] = dP_ij/dF_ml
// = mu d_im d_jl + (mu - lam log J) G_jm G_li + lam G_ji G_lm at
// F = (g0 + bias) Dm^-1, written by the lanes of one warp, and M = Dm^-1
// in every lane's registers for the chain.
struct NHCMaterial {
    struct Params {
        const double *gin0, *bias, *dminv;
        double mu, lam;
    };

    static __device__ void dpdf(const Params& prm, int64_t b, int lane,
                                double* sD, double* M) {
        double F[9], G[9], J;
        nh_factors(prm.gin0, prm.bias, prm.dminv, b, M, F, G, J);
        const double c1 = prm.mu - prm.lam * log(J);
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, l = q % 3;
            double v = c1 * G[j * 3 + m] * G[l * 3 + i] +
                       prm.lam * G[j * 3 + i] * G[l * 3 + m];
            if (i == m && j == l) v += prm.mu;
            sD[idx] = v;
        }
    }
};

// The NHI material's F-space part: sD[(i,j), (m,l)] = dP_ij/dF_ml
// = mu A d_im d_jl - (2/3) mu A F_ij G_lm
//   + G_ji (d1 G_lm - (2/3) mu A F_ml) - c G_jm G_li; M as NHC's.
struct NHIMaterial {
    struct Params {
        const double *gin0, *bias, *dminv;
        double mu, kap;
    };

    static __device__ void dpdf(const Params& prm, int64_t b, int lane,
                                double* sD, double* M) {
        double F[9], G[9], J;
        nh_factors(prm.gin0, prm.bias, prm.dminv, b, M, F, G, J);
        double Ic = 0.0;
        for (int i = 0; i < 9; ++i) Ic += F[i] * F[i];
        const double mu = prm.mu, kap = prm.kap;
        const double A = pow(J, -2.0 / 3.0);
        const double c = (-mu / 3.0) * A * Ic + kap * J * J - kap * J;
        const double d1 = (2.0 * mu / 9.0) * A * Ic + 2.0 * kap * J * J -
                          kap * J;
        const double a23 = (2.0 * mu / 3.0) * A;
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, l = q % 3;
            double v = -a23 * F[i * 3 + j] * G[l * 3 + m] +
                       G[j * 3 + i] * (d1 * G[l * 3 + m] - a23 * F[q]) -
                       c * G[j * 3 + m] * G[l * 3 + i];
            if (i == m && j == l) v += mu * A;
            sD[idx] = v;
        }
    }
};

// The StVK stretch material's F-space part: P = mu (F F^T F - F), so with
// C = F^T F and b = F F^T
// sD[(i,j), (m,l)] = mu (d_im C_lj + F_il F_mj + b_im d_jl - d_im d_jl);
// M as NHC's.
struct StVKMaterial {
    struct Params {
        const double *gin0, *bias, *dminv;
        double mu;
    };

    static __device__ void dpdf(const Params& prm, int64_t b, int lane,
                                double* sD, double* M) {
        double F[9], C[9], Bb[9];
        forward_f(prm.gin0, prm.bias, prm.dminv, b, M, F);
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                C[i * 3 + j] = F[i] * F[j] + F[3 + i] * F[3 + j] +
                               F[6 + i] * F[6 + j];
                Bb[i * 3 + j] = F[i * 3] * F[j * 3] +
                                F[i * 3 + 1] * F[j * 3 + 1] +
                                F[i * 3 + 2] * F[j * 3 + 2];
            }
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, l = q % 3;
            double v = F[i * 3 + l] * F[m * 3 + j];
            if (i == m) v += C[l * 3 + j];
            if (j == l) v += Bb[i * 3 + m];
            if (i == m && j == l) v -= 1.0;
            sD[idx] = prm.mu * v;
        }
    }
};

// What both inverse Jacobians read: Y = Dm^-1 of Dm = g0 + bias (cofactor
// over the determinant), F = Ds Y, b = F F^T, R = F Y^T and J = det F =
// det Ds / det Dm.
__device__ __forceinline__ void inv_factors(const double* __restrict__ gin0,
                                            const double* __restrict__ bias,
                                            const double* __restrict__ ds,
                                            int64_t b, double* Y, double* F,
                                            double* Bb, double* R,
                                            double& J) {
    double Dm[9], Ds[9], C[9];
    for (int i = 0; i < 9; ++i) {
        Dm[i] = gin0[b * 9 + i] + bias[b * 9 + i];
        Ds[i] = ds[b * 9 + i];
    }
    for (int i = 0; i < 3; ++i) {
        const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
        for (int j = 0; j < 3; ++j) {
            const int k0 = j == 0 ? 1 : 0, k1 = j == 2 ? 1 : 2;
            double mnr = Dm[r0 * 3 + k0] * Dm[r1 * 3 + k1] -
                         Dm[r0 * 3 + k1] * Dm[r1 * 3 + k0];
            C[i * 3 + j] = ((i + j) & 1) ? -mnr : mnr;
        }
    }
    const double det = Dm[0] * C[0] + Dm[1] * C[1] + Dm[2] * C[2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Y[i * 3 + j] = C[j * 3 + i] / det;
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            F[i * 3 + j] = Ds[i * 3] * Y[j] + Ds[i * 3 + 1] * Y[3 + j] +
                           Ds[i * 3 + 2] * Y[6 + j];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            Bb[i * 3 + j] = F[i * 3] * F[j * 3] + F[i * 3 + 1] * F[j * 3 + 1] +
                            F[i * 3 + 2] * F[j * 3 + 2];
            R[i * 3 + j] = F[i * 3] * Y[j * 3] + F[i * 3 + 1] * Y[j * 3 + 1] +
                           F[i * 3 + 2] * Y[j * 3 + 2];
        }
    const double detDs = Ds[0] * (Ds[4] * Ds[8] - Ds[5] * Ds[7]) -
                         Ds[1] * (Ds[3] * Ds[8] - Ds[5] * Ds[6]) +
                         Ds[2] * (Ds[3] * Ds[7] - Ds[4] * Ds[6]);
    J = detDs / det;
}

// The inverse model's NHC Jacobian in g (the rest shape), written to sJ
// (81) by the lanes of one warp.
struct InvNHCJacobian {
    struct Params {
        const double *gin0, *bias, *ds;
        double mu, lam;
    };

    static __device__ void fill(const Params& prm, int64_t b, int lane,
                                double* sJ) {
        double Y[9], F[9], Bb[9], R[9], J;
        inv_factors(prm.gin0, prm.bias, prm.ds, b, Y, F, Bb, R, J);
        const double Jinv = 1.0 / J, mu = prm.mu;
        const double cd = Jinv * (mu + prm.lam * (log(Jinv) + 1.0));
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, n = q % 3;
            const double y = Y[n * 3 + m];
            double v = mu * Jinv *
                       (y * Bb[i * 3 + j] - F[i * 3 + m] * R[j * 3 + n] -
                        R[i * 3 + n] * F[j * 3 + m]);
            if (i == j) v -= cd * y;
            sJ[idx] = v;
        }
    }
};

// The inverse model's NHI Jacobian in g (the rest shape), written to sJ
// (81) by the lanes of one warp.
struct InvNHIJacobian {
    struct Params {
        const double *gin0, *bias, *ds;
        double mu, kap;
    };

    static __device__ void fill(const Params& prm, int64_t b, int lane,
                                double* sJ) {
        double Y[9], F[9], Bb[9], R[9], J;
        inv_factors(prm.gin0, prm.bias, prm.ds, b, Y, F, Bb, R, J);
        const double mu = prm.mu, kap = prm.kap;
        const double A = pow(J, -5.0 / 3.0);
        const double Ic = Bb[0] + Bb[4] + Bb[8];
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, n = q % 3;
            const double y = Y[n * 3 + m];
            double v = mu * A *
                       ((5.0 / 3.0) * y * Bb[i * 3 + j] -
                        F[i * 3 + m] * R[j * 3 + n] -
                        R[i * 3 + n] * F[j * 3 + m]);
            if (i == j) {
                const double S = F[m] * R[n] + F[3 + m] * R[3 + n] +
                                 F[6 + m] * R[6 + n];  // (F^T R)_mn
                v += (-mu / 3.0) * A * ((5.0 / 3.0) * y * Ic - 2.0 * S) -
                     kap * J * y;
            }
            sJ[idx] = v;
        }
    }
};

// The ARAP material's F-space part from the SVD-W (U, s, W) of F: for
// dF = e_m e_l^T, A = U^T dF V, A_ac = U_ma V_lc, and
// sD[(i,j), (m,l)] = mu (d_im d_jl - dW_ij), written by the lanes of one
// warp; M = Dm^-1 for the chain.
struct ARAPMaterial {
    struct Params {
        const double *u, *s, *w, *dminv;
        double mu;
    };

    static __device__ void dpdf(const Params& prm, int64_t b, int lane,
                                double* sD, double* M) {
        double U[9], W[9], V[9], sp[9];
        for (int i = 0; i < 9; ++i) {
            M[i] = prm.dminv[b * 9 + i];
            U[i] = prm.u[b * 9 + i];
            W[i] = prm.w[b * 9 + i];
        }
        for (int i = 0; i < 3; ++i)  // V = W^T U
            for (int j = 0; j < 3; ++j)
                V[i * 3 + j] = W[i] * U[j] + W[3 + i] * U[3 + j] +
                               W[6 + i] * U[6 + j];
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j)
                sp[i * 3 + j] = prm.s[b * 3 + i] + prm.s[b * 3 + j];
        for (int idx = lane; idx < 81; idx += 32) {
            const int p = idx / 9, q = idx % 9;
            const int i = p / 3, j = p % 3, m = q / 3, l = q % 3;
            double X[9];
            for (int a = 0; a < 3; ++a)
                for (int c = 0; c < 3; ++c) {
                    const double d = U[m * 3 + a] * V[l * 3 + c] -
                                     U[m * 3 + c] * V[l * 3 + a];
                    const double y = sp[a * 3 + c];
                    X[a * 3 + c] = d * y / (y * y + kClipEps);
                }
            double dw = 0.0;
            for (int c = 0; c < 3; ++c)
                dw += (U[i * 3] * X[c] + U[i * 3 + 1] * X[3 + c] +
                       U[i * 3 + 2] * X[6 + c]) * V[j * 3 + c];
            const double df = (i == m && j == l) ? 1.0 : 0.0;
            sD[idx] = (df - dw) * prm.mu;
        }
    }
};

// The chain through F = (g + bias) Dm^-1: Jg[(i,j), (m,n)] =
// sum_l D[(i,j), (m,l)] Dm^-1_nl from the F-space D (shared) to sJ, by
// the lanes of one warp.
__device__ __forceinline__ void chain_dminv(const double* D, const double* M,
                                            double* sJ, int lane) {
    for (int idx = lane; idx < 81; idx += 32) {
        const int p = idx / 9, q = idx % 9, m = q / 3, n = q % 3;
        sJ[idx] = D[p * 9 + m * 3] * M[n * 3] +
                  D[p * 9 + m * 3 + 1] * M[n * 3 + 1] +
                  D[p * 9 + m * 3 + 2] * M[n * 3 + 2];
    }
}

// The Jac policy of K3, K3n and K8c: Mat's F-space dP/dF chained to g.
template <class Mat>
struct Chained {
    using Params = typename Mat::Params;

    static __device__ void fill(const Params& prm, int64_t b, int lane,
                                double* sJ) {
        __shared__ double sD[kWarps][81];
        double* D = sD[threadIdx.x / 32];
        double M[9];
        Mat::dpdf(prm, b, lane, D, M);
        __syncwarp();
        chain_dminv(D, M, sJ, lane);
    }
};

// The cyclic Jacobi eigensolver of K10: the symmetric part of the 9x9 A
// (row-major, shared memory) is diagonalised in place by the 32 lanes of
// one warp, V (shared) accumulating the rotations, so that on return
// sym(A_in) = V diag(A) V^T.  A step applies the 4 disjoint rotations of
// one round of the circle method on 10 slots (slot 9 the bye, so round r
// pairs (r + k, r - k) mod 9, k = 1..4): c, s of each from A (lanes 0-3,
// into cs), then A V <- A V J (the columns) and A <- J^T A (the rows),
// and the annihilated pair set to zero.  9 rounds make a sweep, which
// covers each of the 36 pairs once; it stops after kMaxSweeps sweeps at
// the latest, at once when sym(A_in) is diagonal.  A NaN never meets the
// convergence test, so it runs every sweep and reaches V and A.
constexpr int kMaxSweeps = 10;
constexpr double kJacobiTol = 1e-15;

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ void jacobi9(double* A, double* V, double* cs, int lane) {
    double nrm = 0.0;
    for (int idx = lane; idx < 81; idx += 32) {
        const int r = idx / 9, c = idx % 9;
        if (r < c) {
            const double a = 0.5 * (A[idx] + A[c * 9 + r]);
            A[idx] = a;
            A[c * 9 + r] = a;
        }
        V[idx] = r == c ? 1.0 : 0.0;
    }
    __syncwarp();
    for (int idx = lane; idx < 81; idx += 32) nrm += A[idx] * A[idx];
    const double tol2 = kJacobiTol * kJacobiTol * warp_sum(nrm);
    for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
        double off = 0.0;
        for (int idx = lane; idx < 81; idx += 32)
            if (idx / 9 != idx % 9) off += A[idx] * A[idx];
        if (warp_sum(off) <= tol2) break;
        for (int r = 0; r < 9; ++r) {
            if (lane < 4) {
                const int p = (r + lane + 1) % 9, q = (r + 8 - lane) % 9;
                const double apq = A[p * 9 + q];
                double c = 1.0, s = 0.0;
                if (apq != 0.0) {
                    const double tau = (A[q * 10] - A[p * 10]) / (2.0 * apq);
                    const double t = (tau >= 0.0 ? 1.0 : -1.0) /
                                     (fabs(tau) + sqrt(1.0 + tau * tau));
                    c = 1.0 / sqrt(1.0 + t * t);
                    s = t * c;
                }
                cs[2 * lane] = c;
                cs[2 * lane + 1] = s;
            }
            __syncwarp();
            // columns p, q of A and of V: 2 x 4 pairs x 9 rows
            for (int task = lane; task < 72; task += 32) {
                double* X = task < 36 ? A : V;
                const int k = (task % 36) / 9, row = task % 9;
                const int p = (r + k + 1) % 9, q = (r + 8 - k) % 9;
                const double c = cs[2 * k], s = cs[2 * k + 1];
                const double xp = X[row * 9 + p], xq = X[row * 9 + q];
                X[row * 9 + p] = c * xp - s * xq;
                X[row * 9 + q] = s * xp + c * xq;
            }
            __syncwarp();
            // rows p, q of A: 4 pairs x 9 columns
            for (int task = lane; task < 36; task += 32) {
                const int k = task / 9, col = task % 9;
                const int p = (r + k + 1) % 9, q = (r + 8 - k) % 9;
                const double c = cs[2 * k], s = cs[2 * k + 1];
                const double xp = A[p * 9 + col], xq = A[q * 9 + col];
                A[p * 9 + col] = c * xp - s * xq;
                A[q * 9 + col] = s * xp + c * xq;
            }
            __syncwarp();
            if (lane < 4 && cs[2 * lane + 1] != 0.0) {
                const int p = (r + lane + 1) % 9, q = (r + 8 - lane) % 9;
                A[p * 9 + q] = 0.0;
                A[q * 9 + p] = 0.0;
            }
            __syncwarp();
        }
    }
}

// K10's Jac policy: Mat's F-space dP/dF, projected to D+ by jacobi9, then
// chained to g as in Chained<Mat>.
template <class Mat>
struct Projected {
    using Params = typename Mat::Params;

    static __device__ void fill(const Params& prm, int64_t b, int lane,
                                double* sJ) {
        __shared__ double sA[kWarps][81];
        __shared__ double sV[kWarps][81];
        __shared__ double sCS[kWarps][8];
        const int warp = threadIdx.x / 32;
        double* A = sA[warp];
        double* V = sV[warp];
        double M[9];
        Mat::dpdf(prm, b, lane, A, M);
        __syncwarp();
        jacobi9(A, V, sCS[warp], lane);
        // max(L, 0); a NaN stays NaN
        double lp[9];
        for (int k = 0; k < 9; ++k) {
            const double l = A[k * 10];
            lp[k] = l < 0.0 ? 0.0 : l;
        }
        __syncwarp();
        for (int idx = lane; idx < 81; idx += 32) {  // D+ = V diag(lp) V^T
            const int r = idx / 9, c = idx % 9;
            double acc = 0.0;
            for (int k = 0; k < 9; ++k) acc += V[r * 9 + k] * lp[k] * V[c * 9 + k];
            A[idx] = acc;
        }
        __syncwarp();
        chain_dminv(A, M, sJ, lane);
    }
};

template <class Jac>
__global__ void elem_stiffness_kernel(typename Jac::Params prm,
                                      const double* __restrict__ Lout,
                                      const double* __restrict__ Lin,
                                      double* __restrict__ E, int64_t B,
                                      int Dout, int Din) {
    __shared__ double sJ[kWarps][81];
    __shared__ double sT[kWarps][kMaxD * 9];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
    if (b >= B) return;  // whole warp leaves; only __syncwarp below

    Jac::fill(prm, b, lane, sJ[warp]);
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

// out[z] = sum of E[slot[p]] for p in [ptr[z], ptr[z+1]), ascending: the
// CSR values (ptr, slot = nz_ptr, nz_slot) and K3t's grad_t (t_ptr,
// t_slot).
__global__ void segment_gather_kernel(const double* __restrict__ E,
                                      const int32_t* __restrict__ ptr,
                                      const int32_t* __restrict__ slot,
                                      double* __restrict__ out, int64_t m) {
    int64_t z = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (z >= m) return;
    double acc = 0.0;
    for (int32_t p = ptr[z]; p < ptr[z + 1]; ++p) acc += E[slot[p]];
    out[z] = acc;
}

int segment_gather(const double* E, const int32_t* ptr, const int32_t* slot,
                   double* out, int64_t m, cudaStream_t s) {
    if (m > 0)
        segment_gather_kernel<<<(unsigned)((m + kThreads - 1) / kThreads),
                                kThreads, 0, s>>>(E, ptr, slot, out, m);
    return (int)cudaGetLastError();
}

template <class Jac>
int jac_asm(const typename Jac::Params& prm, const double* Lout,
            const double* Lin, const int32_t* nz_ptr, const int32_t* nz_slot,
            double* E, double* data, int64_t B, int Dout, int Din,
            int64_t nnz, cudaStream_t s) {
    if (Dout > kMaxD || Din > kMaxD) return (int)cudaErrorInvalidValue;
    if (B > 0)
        elem_stiffness_kernel<Jac><<<(unsigned)((B + kWarps - 1) / kWarps),
                                     kWarps * 32, 0, s>>>(prm, Lout, Lin, E, B,
                                                          Dout, Din);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return segment_gather(E, nz_ptr, nz_slot, data, nnz, s);
}

}  // namespace

extern "C" int sanm_jac_asm(const double* gin0, const double* bias,
                            const double* dminv, const double* Lout,
                            const double* Lin, const int32_t* nz_ptr,
                            const int32_t* nz_slot, double* E, double* data,
                            int64_t B, int Dout, int Din, int64_t nnz,
                            double mu, double lam, void* stream) {
    return jac_asm<Chained<NHCMaterial>>({gin0, bias, dminv, mu, lam}, Lout, Lin,
                                nz_ptr, nz_slot, E, data, B, Dout, Din, nnz,
                                (cudaStream_t)stream);
}

extern "C" int sanm_jac_asm_arap(const double* u, const double* s,
                                 const double* w, const double* dminv,
                                 const double* Lout, const double* Lin,
                                 const int32_t* nz_ptr,
                                 const int32_t* nz_slot, double* E,
                                 double* data, int64_t B, int Dout, int Din,
                                 int64_t nnz, double mu, void* stream) {
    return jac_asm<Chained<ARAPMaterial>>({u, s, w, dminv, mu}, Lout, Lin, nz_ptr,
                                 nz_slot, E, data, B, Dout, Din, nnz,
                                 (cudaStream_t)stream);
}

extern "C" int sanm_jac_asm_nhi(const double* gin0, const double* bias,
                                const double* dminv, const double* Lout,
                                const double* Lin, const int32_t* nz_ptr,
                                const int32_t* nz_slot, double* E,
                                double* data, int64_t B, int Dout, int Din,
                                int64_t nnz, double mu, double kappa,
                                void* stream) {
    return jac_asm<Chained<NHIMaterial>>({gin0, bias, dminv, mu, kappa}, Lout, Lin,
                                nz_ptr, nz_slot, E, data, B, Dout, Din, nnz,
                                (cudaStream_t)stream);
}

extern "C" int sanm_jac_asm_stvk(const double* gin0, const double* bias,
                                 const double* dminv, const double* Lout,
                                 const double* Lin, const int32_t* nz_ptr,
                                 const int32_t* nz_slot, double* E,
                                 double* data, int64_t B, int Dout, int Din,
                                 int64_t nnz, double mu, void* stream) {
    return jac_asm<Chained<StVKMaterial>>({gin0, bias, dminv, mu}, Lout, Lin,
                                          nz_ptr, nz_slot, E, data, B, Dout,
                                          Din, nnz, (cudaStream_t)stream);
}

extern "C" int sanm_jac_asm_inv(const double* gin0, const double* bias,
                                const double* ds, const double* Lout,
                                const double* Lin, const int32_t* nz_ptr,
                                const int32_t* nz_slot, double* E,
                                double* data, int64_t B, int Dout, int Din,
                                int64_t nnz, double mu, double lam,
                                void* stream) {
    return jac_asm<InvNHCJacobian>({gin0, bias, ds, mu, lam}, Lout, Lin,
                                   nz_ptr, nz_slot, E, data, B, Dout, Din,
                                   nnz, (cudaStream_t)stream);
}

extern "C" int sanm_jac_asm_inv_nhi(const double* gin0, const double* bias,
                                    const double* ds, const double* Lout,
                                    const double* Lin, const int32_t* nz_ptr,
                                    const int32_t* nz_slot, double* E,
                                    double* data, int64_t B, int Dout,
                                    int Din, int64_t nnz, double mu,
                                    double kappa, void* stream) {
    return jac_asm<InvNHIJacobian>({gin0, bias, ds, mu, kappa}, Lout, Lin,
                                   nz_ptr, nz_slot, E, data, B, Dout, Din,
                                   nnz, (cudaStream_t)stream);
}

extern "C" int sanm_hess_proj(const double* gin0, const double* bias,
                              const double* dminv, const double* Lout,
                              const double* Lin, const int32_t* nz_ptr,
                              const int32_t* nz_slot, double* E, double* data,
                              int64_t B, int Dout, int Din, int64_t nnz,
                              double mu, double lam, void* stream) {
    return jac_asm<Projected<NHCMaterial>>(
        {gin0, bias, dminv, mu, lam}, Lout, Lin, nz_ptr, nz_slot, E, data, B,
        Dout, Din, nnz, (cudaStream_t)stream);
}

extern "C" int sanm_hess_proj_nhi(const double* gin0, const double* bias,
                                  const double* dminv, const double* Lout,
                                  const double* Lin, const int32_t* nz_ptr,
                                  const int32_t* nz_slot, double* E,
                                  double* data, int64_t B, int Dout, int Din,
                                  int64_t nnz, double mu, double kappa,
                                  void* stream) {
    return jac_asm<Projected<NHIMaterial>>(
        {gin0, bias, dminv, mu, kappa}, Lout, Lin, nz_ptr, nz_slot, E, data,
        B, Dout, Din, nnz, (cudaStream_t)stream);
}

extern "C" int sanm_hess_proj_arap(const double* u, const double* s,
                                   const double* w, const double* dminv,
                                   const double* Lout, const double* Lin,
                                   const int32_t* nz_ptr,
                                   const int32_t* nz_slot, double* E,
                                   double* data, int64_t B, int Dout, int Din,
                                   int64_t nnz, double mu, void* stream) {
    return jac_asm<Projected<ARAPMaterial>>(
        {u, s, w, dminv, mu}, Lout, Lin, nz_ptr, nz_slot, E, data, B, Dout,
        Din, nnz, (cudaStream_t)stream);
}

extern "C" int sanm_grad_t(const double* E, const int32_t* t_ptr,
                           const int32_t* t_slot, double* grad_t,
                           int64_t n_rows, void* stream) {
    return segment_gather(E, t_ptr, t_slot, grad_t, n_rows,
                          (cudaStream_t)stream);
}
