// The f64 mma.sync shapes of Hopper, measured: on no path of the solver.
// Hopper has no f64 wgmma; sm_90 adds m16n8k4, k8 and k16 to sm_80's
// m8n8k4.  chip_smoke.py runs these beside the factors' rows, to choose
// and record the shape of the factors' product tile (kTileShape,
// chol_blocks.h) from the card's own rates.
//
// * sanm_mma_rate: each of `ctas` CTAs of 8 warps issues `iters` rounds of
//   8 independent mma.sync of the shape per warp on register operands:
//   the rate of one SM (ctas = 1) or of the card;
// * sanm_mma_layout: one warp multiplies an M x K by a K x N matrix (both
//   row-major) with one mma.sync of the shape through the fragment maps of
//   chol_blocks.h, so that a wrong map shows as a wrong product;
// * sanm_tile_probe: a variant of tile_nt (chol_blocks.h: its tile, warp
//   part, stages and shape) over an M x N output (multiples of the tile)
//   at depth K (a multiple of 16): C -= A B^T, A (M x K) and B (N x K)
//   row-major.
#include <cuda_runtime.h>

#include "chol_blocks.h"
#include "sanm_kernels.h"

namespace {

template <int S>
__global__ void __launch_bounds__(kFactorThreads)
mma_rate_kernel(double* out, int iters) {
    using T = Mma<S>;
    double a[T::NA], b[T::NB], d[8][T::NC];
#pragma unroll
    for (int q = 0; q < T::NA; ++q) a[q] = 1.0 + 1e-3 * (threadIdx.x + q);
#pragma unroll
    for (int q = 0; q < T::NB; ++q) b[q] = 1.0 - 1e-3 * q;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int q = 0; q < T::NC; ++q) d[u][q] = 0.0;
    for (int it = 0; it < iters; ++it)
#pragma unroll
        for (int u = 0; u < 8; ++u) mma_f64<S>(d[u], a, b);
    double sum = 0.0;
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int q = 0; q < T::NC; ++q) sum += d[u][q];
    out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <int S>
__global__ void mma_layout_kernel(const double* A, const double* B,
                                  double* C) {
    using T = Mma<S>;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    double a[T::NA], b[T::NB], d[T::NC];
#pragma unroll
    for (int q = 0; q < T::NA; ++q)
        a[q] = A[frag_a_row<S>(q, g) * T::K + frag_a_col(q, t)];
#pragma unroll
    for (int q = 0; q < T::NB; ++q) b[q] = B[frag_b_k(q, t) * T::N + g];
#pragma unroll
    for (int q = 0; q < T::NC; ++q) d[q] = 0.0;
    mma_f64<S>(d, a, b);
#pragma unroll
    for (int q = 0; q < T::NC; ++q)
        C[frag_c_row(q, g) * T::N + frag_c_col(q, t)] = d[q];
}

template <int BM, int BN, int WM, int kStages, int kMin, int S, int kT,
          int KT, int kSeg>
__global__ void __launch_bounds__(kT, kMin)
tile_probe_kernel(const double* A, const double* B, double* C, int64_t N,
                  int K) {
    const int64_t r0 = (int64_t)blockIdx.y * BM, c0 = (int64_t)blockIdx.x * BN;
    tile_nt<BM, BN, WM, kStages, kSubtract, S, kT, KT>(
        A + r0 * K, K, B + c0 * K, K, C + r0 * N + c0, N, K, -1, false, kSeg);
}

template <int BM, int BN, int WM, int kStages, int kMin, int S,
          int kT = kFactorThreads, int KT = kTK, int kSeg = 0>
cudaError_t tile_probe(const double* A, const double* B, double* C,
                       int64_t M, int64_t N, int64_t K, cudaStream_t st) {
    if (M % BM || N % BN || K % KT || (kSeg && K % kSeg))
        return cudaErrorInvalidValue;
    const size_t smem = tile_smem_bytes<BM, BN, kStages, KT>();
    auto kern = tile_probe_kernel<BM, BN, WM, kStages, kMin, S, kT, KT, kSeg>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3((unsigned)(N / BN), (unsigned)(M / BM)), kT, smem, st>>>(
        A, B, C, N, (int)K);
    return cudaGetLastError();
}

template <int S>
cudaError_t probe(int what, int ctas, int iters, const double* A,
                  const double* B, double* C, cudaStream_t st) {
    if (what == 0) {
        mma_rate_kernel<S><<<ctas, kFactorThreads, 0, st>>>(C, iters);
    } else if (what == 1) {
        mma_layout_kernel<S><<<1, 32, 0, st>>>(A, B, C);
    }
    return cudaGetLastError();
}

cudaError_t probe_shape(int shape, int what, int ctas, int iters,
                        const double* A, const double* B, double* C,
                        cudaStream_t st) {
    switch (shape) {
        case kM8N8K4:
            return probe<kM8N8K4>(what, ctas, iters, A, B, C, st);
        case kM16N8K4:
            return probe<kM16N8K4>(what, ctas, iters, A, B, C, st);
        case kM16N8K8:
            return probe<kM16N8K8>(what, ctas, iters, A, B, C, st);
        case kM16N8K16:
            return probe<kM16N8K16>(what, ctas, iters, A, B, C, st);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" int sanm_mma_rate(int shape, int ctas, int iters, double* out,
                             void* stream) {
    return (int)probe_shape(shape, 0, ctas, iters, nullptr, nullptr, out,
                            (cudaStream_t)stream);
}

extern "C" int sanm_mma_layout(int shape, const double* A, const double* B,
                               double* C, void* stream) {
    return (int)probe_shape(shape, 1, 0, 0, A, B, C, (cudaStream_t)stream);
}

// variant: 0-3 the 128 x 64 tile (8 warps of 32 x 32, 3 stages) of shape
// 0-3; 4-6 the 128 x 128 tile (8 warps of 64 x 32) of m16n8k8 with 3 and 4
// stages and of m16n8k4 with 4; 7 the 64 x 128 panel tile of m16n8k8;
// 8-9 the 128 x 128 tile of 16 warps of 32 x 32, m16n8k8, 3 and 4 stages;
// 10 a 256 x 64 tile of 16 warps of 32 x 32, m16n8k8, 3 stages; 11 the
// 128 x 64 tile of 4 warps of 64 x 32, m16n8k8, 3 stages of 16; 12 and 13
// the 128 x 64 tile of 8 warps of 32 x 32 and of 4 warps of 64 x 32,
// m16n8k8, 2 stages of 32; 14 the 128 x 64 tile of variant 2 subtracting
// each 128-deep slice's product in turn (K a multiple of 128).
extern "C" int sanm_tile_probe(int variant, const double* A, const double* B,
                               double* C, int64_t M, int64_t N, int64_t K,
                               void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    switch (variant) {
        case 0: return (int)tile_probe<128, 64, 32, 3, 2, kM8N8K4>(A, B, C, M, N, K, st);
        case 1: return (int)tile_probe<128, 64, 32, 3, 2, kM16N8K4>(A, B, C, M, N, K, st);
        case 2: return (int)tile_probe<128, 64, 32, 3, 2, kM16N8K8>(A, B, C, M, N, K, st);
        case 3: return (int)tile_probe<128, 64, 32, 3, 2, kM16N8K16>(A, B, C, M, N, K, st);
        case 4: return (int)tile_probe<128, 128, 64, 3, 1, kM16N8K8>(A, B, C, M, N, K, st);
        case 5: return (int)tile_probe<128, 128, 64, 4, 1, kM16N8K8>(A, B, C, M, N, K, st);
        case 6: return (int)tile_probe<128, 128, 64, 4, 1, kM16N8K4>(A, B, C, M, N, K, st);
        case 7: return (int)tile_probe<64, 128, 32, 3, 2, kM16N8K8>(A, B, C, M, N, K, st);
        case 8: return (int)tile_probe<128, 128, 32, 3, 1, kM16N8K8, 512>(A, B, C, M, N, K, st);
        case 9: return (int)tile_probe<128, 128, 32, 4, 1, kM16N8K8, 512>(A, B, C, M, N, K, st);
        case 10: return (int)tile_probe<256, 64, 32, 3, 1, kM16N8K8, 512>(A, B, C, M, N, K, st);
        case 11: return (int)tile_probe<128, 64, 64, 3, 2, kM16N8K8, 128>(A, B, C, M, N, K, st);
        case 12: return (int)tile_probe<128, 64, 32, 2, 2, kM16N8K8, 256, 32>(A, B, C, M, N, K, st);
        case 13: return (int)tile_probe<128, 64, 64, 2, 2, kM16N8K8, 128, 32>(A, B, C, M, N, K, st);
        case 14: return (int)tile_probe<128, 64, 32, 3, 2, kM16N8K8, 256, 16, 128>(A, B, C, M, N, K, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
