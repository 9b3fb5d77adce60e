// C interface of the port's hand-written CUDA kernels (loaded with ctypes
// by sanm_tpu_torch/kernels.py).  Every entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = launched).  The band entry
// points loop over the block columns on the host and launch a few kernels
// per column.
//
// Arrays are float64 and int32, contiguous, row-major, on one card.
#pragma once
#include <cstdint>

extern "C" {

// K2 remap_in: gin[b, q] = sum_d Lin[b, q, d] * xp[loc_cols[b, d]].
int sanm_remap_in(const double* Lin, const int32_t* loc_cols,
                  const double* xp, double* gin, int64_t B, int idim,
                  int Din, void* stream);

// K2 remap_out, gather form: out[r] = sum over entries e = b*Dout + i in
// row_ent[row_ptr[r] : row_ptr[r+1]] of contrib[e], where
// contrib[e] = sum_p Lout[e, p] * bb[b, p] (scratch of nent = B*Dout).
int sanm_remap_out(const double* Lout, const double* bb,
                   const int32_t* row_ptr, const int32_t* row_ent,
                   double* contrib, double* out, int64_t n_rows,
                   int64_t nent, int Dout, int odim, void* stream);

// K3: per element the NHC Jacobian of P in g (9x9) at F = (g0 + bias) Dm^-1,
// E[b] = Lout[b] J[b] Lin[b] (Dout x Din), then the CSR values
// data[z] = sum of E's flat slots nz_slot[nz_ptr[z] : nz_ptr[z+1]].
int sanm_jac_asm(const double* gin0, const double* bias, const double* dminv,
                 const double* Lout, const double* Lin,
                 const int32_t* nz_ptr, const int32_t* nz_slot, double* E,
                 double* data, int64_t B, int Dout, int Din, int64_t nnz,
                 double mu, double lam, void* stream);

// K1: commit order k of the NHC series histories hist (order+1, 23, B)
// from the graph input g_k (B, 9) (plus bias at k = 0), then, when
// want_bias, write the order-(k+1) bias of P (B, 9) into bias_out.
int sanm_nhc_step(double* hist, const double* gin, const double* bias,
                  const double* dminv, double* bias_out, int64_t B, int k,
                  int order, double mu, double lam, int want_bias,
                  void* stream);

// K4: out[r] = (A x)[r] from the condensed stiffness E (B, Dout, Din):
// contrib[e] = sum_j E[e, j] x[loc_cols[b, j]] (b = e / Dout; columns >= n
// read as zero), then the row sums of remap_out's gather form.
int sanm_element_matvec(const double* E, const int32_t* loc_cols,
                        const double* x, const int32_t* row_ptr,
                        const int32_t* row_ent, double* contrib, double* out,
                        int64_t n, int64_t n_rows, int64_t nent, int Dout,
                        int Din, void* stream);

// K5a: zero the working band (band_len doubles), scale[r] =
// |data[diag_of_row[r]]|^-1/2 (1 where there is no or a zero diagonal),
// band[band_idx[e]] = -(data[sel[e]] scale[rows[e]] scale[cols[e]]) and
// band[pad_idx[i]] = 1.
int sanm_band_assemble(const double* data, const int32_t* diag_of_row,
                       const int32_t* sel, const int32_t* rows,
                       const int32_t* cols, const int64_t* band_idx,
                       const int64_t* pad_idx, double* scale, double* band,
                       int64_t n, int64_t nlow, int64_t npad,
                       int64_t band_len, void* stream);

// K5b: blocked skyline Cholesky of the working band (overwritten) into the
// panels; panel_off (nb + 1) and blk_w (nb) are HOST arrays.  The block
// size s is 128 in every band kernel.
int sanm_band_factor(double* band, double* panels, const int64_t* panel_off,
                     const int64_t* blk_w, int64_t nb, int64_t w,
                     void* stream);

// K5c: out = (L L^T)^-1 rhs in the original ordering: rhs (n) gathered by
// perm_ext into work (nrow, zero past n), forward and backward
// substitution against the panels, out[i] = work[invp_ext[i]].  partial
// holds 2 w rows of s doubles; panel_off and blk_w are HOST arrays.
int sanm_band_solve(const double* panels, const int64_t* panel_off,
                    const int64_t* blk_w, const int32_t* perm_ext,
                    const int32_t* invp_ext, const double* rhs, double* work,
                    double* partial, double* out, int64_t n, int64_t nrow,
                    int64_t nb, void* stream);

// K8a: per element the SVD-W of m (B, 3, 3): u (B, 3, 3), s (B, 3) sorted
// descending, w = u v^T (B, 3, 3), m = u diag(s) u^T w, with the sign flip
// of a group of singular values that makes det(w) = +1.
int sanm_svd_w(const double* m, double* u, double* s, double* w, int64_t B,
               void* stream);

// K8b: commit order k (1 <= k <= order) of the ARAP polar-mode series
// histories hist (order+2, 24, B) from the graph input g_k (B, 9), then,
// when want_bias, write the order-(k+1) bias of P (B, 9) into bias_out.
int sanm_arap_step(double* hist, const double* gin, const double* dminv,
                   double* bias_out, int64_t B, int k, int order, double mu,
                   int want_bias, void* stream);

// K8c: per element the ARAP Jacobian of P in g (9x9) from K8a's u, s, w of
// F, then E and the CSR values as sanm_jac_asm.
int sanm_jac_asm_arap(const double* u, const double* s, const double* w,
                      const double* dminv, const double* Lout,
                      const double* Lin, const int32_t* nz_ptr,
                      const int32_t* nz_slot, double* E, double* data,
                      int64_t B, int Dout, int Din, int64_t nnz, double mu,
                      void* stream);

// K1n: commit order k of the NHI series histories hist (order+1, 25, B)
// from the graph input g_k (B, 9) (plus bias at k = 0), then, when
// want_bias, write the order-(k+1) bias of P (B, 9) into bias_out.
int sanm_nhi_step(double* hist, const double* gin, const double* bias,
                  const double* dminv, double* bias_out, int64_t B, int k,
                  int order, double mu, double kappa, int want_bias,
                  void* stream);

// K3n: per element the NHI Jacobian of P in g (9x9) at
// F = (g0 + bias) Dm^-1 (shear modulus mu, bulk modulus kappa), then E and
// the CSR values as sanm_jac_asm.
int sanm_jac_asm_nhi(const double* gin0, const double* bias,
                     const double* dminv, const double* Lout,
                     const double* Lin, const int32_t* nz_ptr,
                     const int32_t* nz_slot, double* E, double* data,
                     int64_t B, int Dout, int Din, int64_t nnz, double mu,
                     double kappa, void* stream);

// K3t: grad_t[r] = sum of E's flat slots t_slot[t_ptr[r] : t_ptr[r+1]]
// (the t column of the implicit continuation's Jacobian), r < n_rows.
int sanm_grad_t(const double* E, const int32_t* t_ptr, const int32_t* t_slot,
                double* grad_t, int64_t n_rows, void* stream);

// K1i: commit order k of the inverse model's series histories hist
// (order+1, 29, B) (NHC, Lame parameters mu and lam) or (order+1, 30, B)
// (NHI, mu and the bulk modulus kappa) from the graph input g_k (B, 9)
// (plus bias at k = 0; Dm = g + bias, F = Ds Dm^-1 with Ds (B, 9)), then,
// when want_bias, write the order-(k+1) bias of the Cauchy stress (B, 9)
// into bias_out.
int sanm_inv_nhc_step(double* hist, const double* gin, const double* bias,
                      const double* ds, double* bias_out, int64_t B, int k,
                      int order, double mu, double lam, int want_bias,
                      void* stream);
int sanm_inv_nhi_step(double* hist, const double* gin, const double* bias,
                      const double* ds, double* bias_out, int64_t B, int k,
                      int order, double mu, double kappa, int want_bias,
                      void* stream);

// K3i: per element the Jacobian of the inverse model's Cauchy stress in g
// (9x9) at Dm = g0 + bias, F = Ds Dm^-1 (NHC: mu, lam; NHI: mu, kappa),
// then E and the CSR values as sanm_jac_asm.
int sanm_jac_asm_inv(const double* gin0, const double* bias,
                     const double* ds, const double* Lout, const double* Lin,
                     const int32_t* nz_ptr, const int32_t* nz_slot, double* E,
                     double* data, int64_t B, int Dout, int Din, int64_t nnz,
                     double mu, double lam, void* stream);
int sanm_jac_asm_inv_nhi(const double* gin0, const double* bias,
                         const double* ds, const double* Lout,
                         const double* Lin, const int32_t* nz_ptr,
                         const int32_t* nz_slot, double* E, double* data,
                         int64_t B, int Dout, int Din, int64_t nnz,
                         double mu, double kappa, void* stream);

// K10: per element the eigen-projected dP/dF of the NHC (mu, lam), NHI
// (mu, kappa) or ARAP (K8a's u, s, w of F; mu) stress at
// F = (g0 + bias) Dm^-1: D+ = V max(L, 0) V^T of sym(dP/dF) by a cyclic
// Jacobi eigensolver, chained to g, then E and the CSR values as
// sanm_jac_asm (the sign of the ANM Jacobian: minus the projected
// Hessian).
int sanm_hess_proj(const double* gin0, const double* bias,
                   const double* dminv, const double* Lout, const double* Lin,
                   const int32_t* nz_ptr, const int32_t* nz_slot, double* E,
                   double* data, int64_t B, int Dout, int Din, int64_t nnz,
                   double mu, double lam, void* stream);
int sanm_hess_proj_nhi(const double* gin0, const double* bias,
                       const double* dminv, const double* Lout,
                       const double* Lin, const int32_t* nz_ptr,
                       const int32_t* nz_slot, double* E, double* data,
                       int64_t B, int Dout, int Din, int64_t nnz, double mu,
                       double kappa, void* stream);
int sanm_hess_proj_arap(const double* u, const double* s, const double* w,
                        const double* dminv, const double* Lout,
                        const double* Lin, const int32_t* nz_ptr,
                        const int32_t* nz_slot, double* E, double* data,
                        int64_t B, int Dout, int Din, int64_t nnz, double mu,
                        void* stream);

// K6b: dense blocked Cholesky of A (npad x npad, npad = nb s, row-major,
// lower triangle read, overwritten by L) and the inverses of its diagonal
// blocks inv (nb, s, s); T is a scratch panel of (nb - 1) s x s.  s = 128.
int sanm_dense_factor(double* A, double* inv, double* T, int64_t nb,
                      void* stream);

// K6c: out = (L L^T)^-1 rhs: rhs (n) zero-extended to work (npad), forward
// and backward substitution against the lower triangle of L and inv,
// out = work[0:n].  partial holds ceil((npad - s) / 64) rows of s doubles.
int sanm_dense_solve(const double* L, const double* inv, const double* rhs,
                     double* work, double* partial, double* out, int64_t n,
                     int64_t nb, void* stream);

// K7b: X = blkdiag(L_p L_p^T)^-1 R for the P partitions' local factors
// (panel j of partition p at panels + off[p mb + j], blk_w[p mb + j]
// subdiagonal blocks; off and blk_w on the card, wmax (mb) = the largest
// reach of each block column over the partitions, on the HOST); R and X
// (P, mb s, k), R overwritten; Z scratch (P, s, k).  k a multiple of 64.
int sanm_spike_rhs_solve(const double* panels, const int64_t* off,
                         const int64_t* blk_w, const int64_t* wmax,
                         double* R, double* X, double* Z, int64_t P,
                         int64_t mb, int64_t k, void* stream);

// K7c: out = A^-1 rhs through the SPIKE factor: rhs (n) gathered by
// perm_ext into work (P m), the local substitutions (as K7b's), the
// reduced block-Thomas recursion with V, W (P, m, b), LU (P, b, b) and its
// row permutations lu_perm (P, b), invL / invUt (P, b / s, s, s), G
// (P, b, b), Mh (2, P, b, b), the recombination, out[i] =
// work[invp_ext[i]].  partial (P, ceil(max reach s / 64), s), red
// (3 + 4P, b) scratch; wmax on the HOST.
int sanm_spike_solve(const double* panels, const int64_t* off,
                     const int64_t* blk_w, const int64_t* wmax,
                     const double* V, const double* W, const double* LU,
                     const int32_t* lu_perm, const double* invL,
                     const double* invUt, const double* G, const double* Mh,
                     const int32_t* perm_ext, const int32_t* invp_ext,
                     const double* rhs, double* work, double* partial,
                     double* red, double* out, int64_t n, int64_t P,
                     int64_t mb, int64_t b, void* stream);

const char* sanm_error_string(int err);

}  // extern "C"
