// C interface of the port's hand-written CUDA kernels (loaded with ctypes
// by sanm_tpu_torch/kernels.py).  Every entry point launches on the given
// stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after its launches (0 = launched).
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

const char* sanm_error_string(int err);

}  // extern "C"
