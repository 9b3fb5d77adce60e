// C interface of the port's hand-written CUDA kernels (loaded with ctypes
// by sanm_tpu_torch/kernels.py).  Every entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = launched).  The band and
// dense factors loop over the block columns on the host and launch a few
// kernels per column.
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
// crow[ent_pos[e]] = sum_j E[e, j] x[loc_cols[b, j]] (b = e / Dout;
// columns >= n read as zero; entries with ent_pos -1 are dead), then
// out[r] = sum of crow[row_ptr[r] : row_ptr[r+1]] in ascending order
// (crow: scratch of row_ptr[n_rows] doubles, the live entries in row
// order).  Dout = 12 and Din = 12 or 13 (the t column); other shapes
// return cudaErrorInvalidValue.
int sanm_element_matvec(const double* E, const int32_t* loc_cols,
                        const double* x, const int32_t* ent_pos,
                        const int32_t* row_ptr, double* crow, double* out,
                        int64_t n, int64_t n_rows, int64_t B, int Dout,
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
// perm_ext (zero past n), forward and backward substitution against the
// panels, each one persistent kernel whose CTAs take block rows (columns)
// by ticket and poll each other's published results; out[perm_ext[g]] =
// x[g] for perm_ext[g] < n.  panel_off (nb + 1), blk_w and row_lo (nb:
// the first block column whose reach covers block row i) are DEVICE
// arrays; work (nb s) ends holding the permuted solution; sync holds 16
// bytes of counters, then 4 nb s 64-bit words, all zeroed here (4 + 8 nb
// s int32).  *err (zeroed by the caller, not here) is set to 1 when a
// wait timed out, and a call that finds it set does nothing: the result
// of that call and of every later one on the same word is then invalid.
int sanm_band_solve(const double* panels, const int64_t* panel_off,
                    const int64_t* blk_w, const int32_t* row_lo,
                    const int32_t* perm_ext, const double* rhs, double* work,
                    int* sync, int* err, double* out, int64_t n, int64_t nb,
                    void* stream);

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

// K4 COO: out[i] = sum over q in ptr[i] .. ptr[i+1] of
// data[pos ? pos[q] : q] * v[idx[q]], i < n_out: A x with the CSR row
// pointer, pos NULL and idx the columns; A^T y with the column gather map
// (pos the value positions, idx their rows).
int sanm_csr_matvec(const int32_t* ptr, const int32_t* pos,
                    const int32_t* idx, const double* data, const double* v,
                    double* out, int64_t n_out, void* stream);

// K4 COO: out[t] = dmap[t] < nnz ? data[dmap[t]] : 0, t < count (the
// diagonal blocks).
int sanm_diag_blocks(const int32_t* dmap, const double* data, double* out,
                     int64_t count, int64_t nnz, void* stream);

// K9: n_steps block-Jacobi PCG iterations on A (row_ptr, cols, data; in
// Tikhonov mode, pen != 0, on A^T A + pen I with A^T's gather map t_ptr,
// t_src, t_rows and the scratch y (n)), binv (n/3, 3, 3) = M^-1, the state
// x, r, z, p (n) in place, the scratch Ap (n) and part (3 G), the scalars
// S (7): slot c = S[3c .. 3c+2] holds (r.z, r.r, live iterations),
// iteration it0 + s reads slot (it0 + s) & 1 and writes the other, S[6] =
// b.b; an iteration is frozen (x, r untouched, alpha = beta = 0) once
// r.r <= tol2 b.b.  G CTAs per launch.
int sanm_pcg_step(const int32_t* row_ptr, const int32_t* cols,
                  const int32_t* t_ptr, const int32_t* t_src,
                  const int32_t* t_rows, const double* data,
                  const double* binv, double* x, double* r, double* z,
                  double* p, double* Ap, double* y, double* S, double* part,
                  int64_t n, int64_t n_steps, int64_t it0, int64_t G,
                  double tol2, double pen, void* stream);

const char* sanm_error_string(int err);

}  // extern "C"
