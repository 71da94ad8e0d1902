// Staged LUT mpGEMM: table [Mp, Gp*E] (int8 per_row, int8 per_group, or
// f32) x packed B-bit weight codes [Np, Gp*B*K/8] -> f32 [Mp, Np].
//
// Replaces the TPU kernel kernels/lut_mpgemm.py:lut_mpgemm_pallas
// (_kernel_int, _kernel_f32, _unpack_cw). What bounds it on the H100: at a
// 128-token prefill chunk the lookup is M·N·G·E multiply-adds against
// M·G·E + N·G·B·K/8 input bytes, about 512 operations per byte, so the
// arithmetic bounds it. This first version runs the int8 path on __dp4a
// (int32 accumulation, exact) and the f32 path on IEEE fp32 FMA, not on
// tensor cores; each block loops over K itself, rebuilding the CW tile
// of its channels from the packed codes in shared memory at every K-step,
// and carries no sum across the grid. wgmma, TMA and pipelining are later
// work.
#include <type_traits>

#include "lut_common.cuh"

namespace {

template <class C, bool kInt>
__global__ void __launch_bounds__(lut::kThreads)
lut_mpgemm_kernel(const void* __restrict__ tv, const float* __restrict__ ts,
                  const uint8_t* __restrict__ packed, const float* __restrict__ ws,
                  float* __restrict__ out, int n_total, int gp, int k_group,
                  int planes, int bg, int mode, lut::PlaneScales ps) {
  using T = typename std::conditional<kInt, int8_t, float>::type;
  const int e_count = 1 << (k_group - 1);
  const int kt = bg * e_count;
  const int ld = lut::tile_ld<T>(kt);
  const long long ge = static_cast<long long>(gp) * e_count;   // table row
  const int pb = gp * planes * k_group / 8;                    // packed row
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + C::BM * ld;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int ty = threadIdx.x / C::TX, tx = threadIdx.x % C::TX;

  using Acc = typename std::conditional<kInt, int, float>::type;
  Acc acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0;

  for (int g0 = 0; g0 < gp; g0 += bg) {
    const long long col0 = static_cast<long long>(g0) * e_count;
    if constexpr (kInt) {
      // table tile, 4 codes per word (rows and K-steps are word aligned)
      const int words = kt / 4;
      const int* src = static_cast<const int*>(tv);
      for (int p = threadIdx.x; p < C::BM * words; p += lut::kThreads) {
        const int r = p / words, w = p % words;
        reinterpret_cast<int*>(As + r * ld)[w] =
            src[((m0 + r) * ge + col0) / 4 + w];
      }
    } else {
      for (int p = threadIdx.x; p < C::BM * kt; p += lut::kThreads) {
        const int r = p / kt, k = p % kt;
        const long long at = (m0 + r) * ge + col0 + k;
        As[r * ld + k] =
            mode == lut::kPerGroup
                ? __fmul_rn(static_cast<float>(static_cast<const int8_t*>(tv)[at]),
                            ts[static_cast<long long>(m0 + r) * gp + g0 + k / e_count])
                : static_cast<const float*>(tv)[at];
      }
    }
    lut::unpack_cw_tile<T, C>(packed, pb, n0, g0, bg, planes, k_group, ps, Bs);
    __syncthreads();
    if constexpr (kInt)
      lut::contract_int8<C>(As, Bs, kt, ty, tx, acc);
    else
      lut::contract_f32<C>(As, Bs, kt, ty, tx, acc);
    __syncthreads();
  }
  if constexpr (kInt)
    lut::store_int<C>(acc, ts, ws, out, n_total, m0, n0, ty, tx);
  else
    lut::store_f32<C>(acc, ws, out, n_total, m0, n0, ty, tx);
}

template <class C, bool kInt>
int launch(const void* tv, const float* ts, const uint8_t* packed, const float* ws,
           float* out, int mp, int np, int gp, int k_group, int planes, int bg,
           int mode, const lut::PlaneScales& ps, cudaStream_t stream) {
  if (mp % C::BM || np % C::BN) return static_cast<int>(cudaErrorInvalidValue);
  using T = typename std::conditional<kInt, int8_t, float>::type;
  const size_t smem = lut::tile_smem_bytes<T, C>(bg << (k_group - 1));
  auto kernel = lut_mpgemm_kernel<C, kInt>;
  cudaError_t err = lut::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM);
  kernel<<<grid, lut::kThreads, smem, stream>>>(tv, ts, packed, ws, out, np, gp,
                                                k_group, planes, bg, mode, ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 f32 table, 1 int8 table + per-row scale ts [mp], 2 int8 table +
// per-group scale ts [mp, gp]. config: 0 SmallTile, 1 LargeTile. bg: groups
// per K-step (gp % bg == 0). plane_scales: host array of `planes` ints.
extern "C" int lut_mpgemm_launch(const void* tv, const float* ts,
                                 const uint8_t* packed, const float* ws,
                                 float* out, int mp, int np, int gp,
                                 int k_group, int planes,
                                 const int* plane_scales, int mode, int config,
                                 int bg, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || ((bg << (k_group - 1)) % 4) ||
      (bg * planes * k_group) % 8 || mode < lut::kFloat || mode > lut::kPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  const bool int_path = mode == lut::kPerRow;
  if (config == 0)
    return int_path ? launch<lut::SmallTile, true>(tv, ts, packed, ws, out, mp, np, gp,
                                                   k_group, planes, bg, mode, ps, stream)
                    : launch<lut::SmallTile, false>(tv, ts, packed, ws, out, mp, np, gp,
                                                    k_group, planes, bg, mode, ps, stream);
  if (config == 1)
    return int_path ? launch<lut::LargeTile, true>(tv, ts, packed, ws, out, mp, np, gp,
                                                   k_group, planes, bg, mode, ps, stream)
                    : launch<lut::LargeTile, false>(tv, ts, packed, ws, out, mp, np, gp,
                                                    k_group, planes, bg, mode, ps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
