// K8a: batched 3x3 SVD-W, M = U S U^T W with det(W) = +1.
//
// Replaces the JAX package's svd_w primitive as it evaluates on 3x3
// batches: svd_batched_small (sanm_tpu/ops/svd3.py:64, one-sided Jacobi
// with the rotation of _rotate_pair, :24-61) followed by _svd_w_eval's
// require_rotation flip (sanm_tpu/ops/svd_w.py:60-118), always applied
// (every caller asks for det(W) = +1).  Per element:
//   12 fixed cyclic sweeps over the column pairs (0,1), (0,2), (1,2) of
//   A = M V, each rotation t = 2 apq sign(d) / (|d| + sqrt(d^2 + 4 apq^2)),
//   d = aqq - app (never divides by apq, so a tiny apq cannot overflow);
//   s = column norms, sorted descending (stable), U = A / s, a near-null
//   third column rebuilt as the cross product of the first two;
//   if det(U) det(V) < 0, flip the group of singular values (closer than
//   GROUP_EPS) with the fewest members, the later group on a tie, whole
//   when its size is odd, else its first member; W = U V^T.
// The arithmetic is the plain version's (ops/svd3.py, ops/svd_w.py) in
// the same order, so that ties and the flip choice are decided alike
// (up to the fused multiply-adds nvcc forms).
//
// Bound on the H100: latency.  At armadillo-small (B = 42,288) it reads
// 72 B and writes 168 B an element (~10 MB, ~3 us at 3.35 TB/s) and does
// ~1.6 k f64 operations an element (~70 MFLOP, ~2 us at 34 TFLOP/s); 42 k
// threads fill the card's 132 SMs only about five warps deep, so the
// dependent chain of 36 rotations (a sqrt and two divisions each) sets
// the time.  Design: one thread per element, the 3x3 matrices in
// registers, no shared memory.
#include <cuda_runtime.h>

#include "sanm_kernels.h"

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 12;          // ops/svd3.py N_SWEEPS
constexpr double kGroupEps = 1e-3;   // ops/svd_w.py GROUP_EPS

// One Jacobi rotation orthogonalising columns p, q of A (row-major 3x3);
// V accumulates it.
__device__ inline void rotate_pair(double* A, double* V, int p, int q) {
    double app = A[p] * A[p] + A[3 + p] * A[3 + p] + A[6 + p] * A[6 + p];
    double aqq = A[q] * A[q] + A[3 + q] * A[3 + q] + A[6 + q] * A[6 + q];
    double apq = A[p] * A[q] + A[3 + p] * A[3 + q] + A[6 + p] * A[6 + q];
    double d = aqq - app;
    double den = fabs(d) + sqrt(d * d + 4.0 * apq * apq);
    double sign_d = d < 0 ? -1.0 : 1.0;
    double t = 2.0 * apq * sign_d / (den == 0 ? 1.0 : den);
    if (fabs(apq) <= 1e-300) t = 0.0;
    double c = 1.0 / sqrt(1.0 + t * t);
    double s = t * c;
    for (int r = 0; r < 3; ++r) {
        double ap = A[r * 3 + p], aq = A[r * 3 + q];
        A[r * 3 + p] = c * ap - s * aq;
        A[r * 3 + q] = s * ap + c * aq;
        double vp = V[r * 3 + p], vq = V[r * 3 + q];
        V[r * 3 + p] = c * vp - s * vq;
        V[r * 3 + q] = s * vp + c * vq;
    }
}

__device__ inline double det3(const double* x) {
    return x[0] * (x[4] * x[8] - x[5] * x[7]) -
           x[1] * (x[3] * x[8] - x[5] * x[6]) +
           x[2] * (x[3] * x[7] - x[4] * x[6]);
}

__global__ void svd_w_kernel(const double* __restrict__ m,
                             double* __restrict__ u_out,
                             double* __restrict__ s_out,
                             double* __restrict__ w_out, int64_t B) {
    int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (b >= B) return;
    double A[9], V[9];
    for (int i = 0; i < 9; ++i) {
        A[i] = m[b * 9 + i];
        V[i] = (i % 4 == 0) ? 1.0 : 0.0;
    }
#pragma unroll 1
    for (int sweep = 0; sweep < kSweeps; ++sweep) {
        rotate_pair(A, V, 0, 1);
        rotate_pair(A, V, 0, 2);
        rotate_pair(A, V, 1, 2);
    }
    double sv[3];
    for (int c = 0; c < 3; ++c)
        sv[c] = sqrt(A[c] * A[c] + A[3 + c] * A[3 + c] + A[6 + c] * A[6 + c]);
    // stable descending sort: rank = #larger + #equal before
    int order[3];
    for (int i = 0; i < 3; ++i) {
        int r = 0;
        for (int j = 0; j < 3; ++j)
            if (-sv[j] < -sv[i] || (-sv[j] == -sv[i] && j < i)) ++r;
        order[r] = i;
    }
    double s[3], U[9], Vs[9];
    for (int c = 0; c < 3; ++c) {
        const int o = order[c];
        s[c] = sv[o];
        const double den = s[c] > 1e-300 ? s[c] : 1.0;
        for (int r = 0; r < 3; ++r) {
            U[r * 3 + c] = A[r * 3 + o] / den;
            Vs[r * 3 + c] = V[r * 3 + o];
        }
    }
    if (s[2] <= 1e-15 * s[0]) {
        double cr[3] = {U[3] * U[7] - U[6] * U[4], U[6] * U[1] - U[0] * U[7],
                        U[0] * U[4] - U[3] * U[1]};
        double cn = sqrt(cr[0] * cr[0] + cr[1] * cr[1] + cr[2] * cr[2]);
        if (!(cn > 0)) cn = 1.0;
        for (int r = 0; r < 3; ++r) U[r * 3 + 2] = cr[r] / cn;
    }
    if (det3(U) * det3(Vs) < 0) {
        bool is_start[3] = {true, (s[0] - s[1]) >= kGroupEps,
                            (s[1] - s[2]) >= kGroupEps};
        int best_idx = 0, best_nr = 4;
        for (int i = 0; i < 3; ++i) {
            if (!is_start[i]) continue;
            int nr = 1;
            for (int j = i + 1; j < 3 && !is_start[j]; ++j) ++nr;
            if (nr <= best_nr || (nr == best_nr + 1 && nr % 2 == 1)) {
                best_idx = i;
                best_nr = nr;
            }
        }
        const bool single = best_nr == 1 || best_nr % 2 == 0;
        for (int c = 0; c < 3; ++c) {
            const bool flip = single ? c == best_idx
                                     : (c >= best_idx && c < best_idx + best_nr);
            if (flip) {
                s[c] = -s[c];
                for (int r = 0; r < 3; ++r) U[r * 3 + c] = -U[r * 3 + c];
            }
        }
    }
    // W = U V^T
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            w_out[b * 9 + i * 3 + j] = U[i * 3 + 0] * Vs[j * 3 + 0] +
                                       U[i * 3 + 1] * Vs[j * 3 + 1] +
                                       U[i * 3 + 2] * Vs[j * 3 + 2];
    for (int i = 0; i < 9; ++i) u_out[b * 9 + i] = U[i];
    for (int i = 0; i < 3; ++i) s_out[b * 3 + i] = s[i];
}

}  // namespace

extern "C" int sanm_svd_w(const double* m, double* u, double* s, double* w,
                          int64_t B, void* stream) {
    if (B > 0)
        svd_w_kernel<<<(unsigned)((B + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(m, u, s, w, B);
    return (int)cudaGetLastError();
}
