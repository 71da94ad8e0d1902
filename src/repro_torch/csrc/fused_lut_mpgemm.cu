// Fused precompute -> lookup LUT mpGEMM: activations [Mp, Gp*K] f32 x packed
// B-bit weight codes [Np, Gp*B*K/8] -> f32 [Mp, Np]. The half-table of each
// K-step is rebuilt in shared memory from the activation tile (quantized to
// INT8 with the wrapper's per-row scale, or per_group quantize->dequantize,
// or left in f32) and contracted at once; it never reaches device memory.
//
// Replaces the TPU kernel kernels/fused_lut_mpgemm.py:fused_lut_mpgemm_pallas
// (_table_block, _kernel_int, _kernel_f32). What bounds it on the H100: at
// decode (M = batch <= 64) it reads each packed weight byte once and does
// few operations per byte, so device-memory bytes bound it. This first
// version gives every block BN channels and all (padded) rows of M, walks
// K inside the block, and runs the int8 path on __dp4a with exact int32
// sums; a small-M tile (8 x 32 outputs) keeps decode from computing 64
// padded rows. Overlapping the weight stream with the contraction (TMA,
// pipelining) and tensor cores are later work.
#include <type_traits>

#include "lut_common.cuh"

namespace {

template <class C, bool kInt>
__global__ void __launch_bounds__(lut::kThreads)
fused_lut_mpgemm_kernel(const float* __restrict__ x, const float* __restrict__ rs,
                        const uint8_t* __restrict__ packed,
                        const float* __restrict__ ws, float* __restrict__ out,
                        int n_total, int gp, int k_group, int planes, int bg,
                        int mode, lut::PlaneScales ps) {
  using T = typename std::conditional<kInt, int8_t, float>::type;
  const int e_count = 1 << (k_group - 1);
  const int kt = bg * e_count;
  const int ld = lut::tile_ld<T>(kt);
  const long long kp = static_cast<long long>(gp) * k_group;   // activation row
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
    // table block [BM, bg*E], rebuilt from the activation block
    for (int p = threadIdx.x; p < C::BM * bg; p += lut::kThreads) {
      const int r = p / bg, gl = p % bg;
      float a[lut::kMaxKGroup];
      lut::load_group(x + (m0 + r) * kp + static_cast<long long>(g0 + gl) * k_group,
                      k_group, a);
      T* dst = As + r * ld + gl * e_count;
      if constexpr (kInt) {
        const float s = rs[m0 + r];
        for (int e = 0; e < e_count; ++e)
          dst[e] = static_cast<int8_t>(
              lut::quantize_entry(lut::half_table_entry(a, k_group, e), s));
      } else if (mode == lut::kPerGroup) {
        const float s = lut::per_group_scale(lut::group_abs_sum(a, k_group));
        for (int e = 0; e < e_count; ++e)
          dst[e] = __fmul_rn(lut::quantize_entry(lut::half_table_entry(a, k_group, e), s), s);
      } else {
        for (int e = 0; e < e_count; ++e) dst[e] = lut::half_table_entry(a, k_group, e);
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
    lut::store_int<C>(acc, rs, ws, out, n_total, m0, n0, ty, tx);
  else
    lut::store_f32<C>(acc, ws, out, n_total, m0, n0, ty, tx);
}

template <class C, bool kInt>
int launch(const float* x, const float* rs, const uint8_t* packed, const float* ws,
           float* out, int mp, int np, int gp, int k_group, int planes, int bg,
           int mode, const lut::PlaneScales& ps, cudaStream_t stream) {
  if (mp % C::BM || np % C::BN) return static_cast<int>(cudaErrorInvalidValue);
  using T = typename std::conditional<kInt, int8_t, float>::type;
  const size_t smem = lut::tile_smem_bytes<T, C>(bg << (k_group - 1));
  auto kernel = fused_lut_mpgemm_kernel<C, kInt>;
  cudaError_t err = lut::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM);
  kernel<<<grid, lut::kThreads, smem, stream>>>(x, rs, packed, ws, out, np, gp,
                                                k_group, planes, bg, mode, ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 f32 table, 1 per_row INT8 (row_scale [mp]), 2 per_group
// quantize->dequantize. config: 0 SmallTile, 1 LargeTile. bg: groups per
// K-step (gp % bg == 0). plane_scales: host array of `planes` ints.
extern "C" int fused_lut_mpgemm_launch(const float* x, const float* row_scale,
                                       const uint8_t* packed, const float* ws,
                                       float* out, int mp, int np, int gp,
                                       int k_group, int planes,
                                       const int* plane_scales, int mode,
                                       int config, int bg, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || ((bg << (k_group - 1)) % 4) ||
      (bg * planes * k_group) % 8 || mode < lut::kFloat || mode > lut::kPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  const bool int_path = mode == lut::kPerRow;
  if (config == 0)
    return int_path ? launch<lut::SmallTile, true>(x, row_scale, packed, ws, out, mp, np,
                                                   gp, k_group, planes, bg, mode, ps, stream)
                    : launch<lut::SmallTile, false>(x, row_scale, packed, ws, out, mp, np,
                                                    gp, k_group, planes, bg, mode, ps, stream);
  if (config == 1)
    return int_path ? launch<lut::LargeTile, true>(x, row_scale, packed, ws, out, mp, np,
                                                   gp, k_group, planes, bg, mode, ps, stream)
                    : launch<lut::LargeTile, false>(x, row_scale, packed, ws, out, mp, np,
                                                    gp, k_group, planes, bg, mode, ps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
