// Dequantization-based mpGEMM (the paper's Fig. 2b baseline): activations
// [Mp, Gp*K] f32 x packed B-bit weight codes [Np, Gp*B*K/8] -> f32 [Mp, Np],
// out[m, n] = ws[n] * Σ_k a[m, k] q'[n, k], where q' = Σ_b ps_b (2 bit_b − 1)
// is the reinterpreted weight, its plane bits unfolded from the stored codes
// by Eq. 6. No zero point here: the wrapper applies it as a rank-1 update.
//
// Replaces the TPU kernel kernels/dequant_mpgemm.py:dequant_mpgemm_pallas
// (_unpack_w, _kernel). What bounds it on the H100: its contract is IEEE
// f32, so its 2·M·N·K operations run on the f32 pipes (67 TFLOP/s), not the
// tensor cores; at M = 4 with W2 weights they already outweigh the packed
// bytes (0.50 µs against 0.33 µs at N = K = 2048), and at M = 128 they bound
// it 17x over. This first version gives each block a BM x BN output tile
// and walks K itself: per K-step it stages the A tile and unpacks its
// channels' q' tile to f32 in shared memory (the packed bytes are read once
// per block row), then contracts both with register micro-tiles of fp32 FMA
// and multiplies by ws in the epilogue. A bf16 or wgmma variant would be
// faster and needs its own tolerance; pipelining the unpack with the
// contraction is later work.
#include "lut_common.cuh"

namespace {

template <class C>
__global__ void __launch_bounds__(lut::kThreads)
dequant_mpgemm_kernel(const float* __restrict__ a, const uint8_t* __restrict__ packed,
                      const float* __restrict__ ws, float* __restrict__ out,
                      int n_total, int gp, int k_group, int planes, int bg,
                      lut::PlaneScales ps) {
  const int kt = bg * k_group;                                 // K per step
  const int ld = lut::tile_ld<float>(kt);
  const long long kp = static_cast<long long>(gp) * k_group;   // activation row
  const int pb = gp * planes * k_group / 8;                    // packed row
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + C::BM * ld;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int ty = threadIdx.x / C::TX, tx = threadIdx.x % C::TX;

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;

  for (int g0 = 0; g0 < gp; g0 += bg) {
    const long long k0 = static_cast<long long>(g0) * k_group;
    // A tile [BM, kt]: neighbouring threads read neighbouring addresses
    for (int p = threadIdx.x; p < C::BM * kt; p += lut::kThreads) {
      const int r = p / kt, c = p % kt;
      As[r * ld + c] = a[(m0 + r) * kp + k0 + c];
    }
    // q' tile [BN, kt], one (channel, group) per thread and iteration
    for (int p = threadIdx.x; p < C::BN * bg; p += lut::kThreads) {
      const int nl = p / bg, gl = p % bg;
      lut::unpack_qprime_group(packed + static_cast<size_t>(n0 + nl) * pb, g0 + gl,
                               planes, k_group, ps, Bs + nl * ld + gl * k_group);
    }
    __syncthreads();
    lut::contract_f32<C>(As, Bs, kt, ty, tx, acc);
    __syncthreads();
  }
  lut::store_f32<C>(acc, ws, out, n_total, m0, n0, ty, tx);
}

template <class C>
int launch(const float* a, const uint8_t* packed, const float* ws, float* out,
           int mp, int np, int gp, int k_group, int planes, int bg,
           const lut::PlaneScales& ps, cudaStream_t stream) {
  if (mp % C::BM || np % C::BN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lut::tile_smem_bytes<float, C>(bg * k_group);
  auto kernel = dequant_mpgemm_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM);
  kernel<<<grid, lut::kThreads, smem, stream>>>(a, packed, ws, out, np, gp, k_group,
                                                planes, bg, ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// config: 0 SmallTile, 1 LargeTile. bg: groups per K-step (gp % bg == 0, a
// K-step starts on a byte of the packed row). plane_scales: host array of
// `planes` ints.
extern "C" int dequant_mpgemm_launch(const float* a, const uint8_t* packed,
                                     const float* ws, float* out, int mp, int np,
                                     int gp, int k_group, int planes,
                                     const int* plane_scales, int config, int bg,
                                     cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || (bg * planes * k_group) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  if (config == 0)
    return launch<lut::SmallTile>(a, packed, ws, out, mp, np, gp, k_group, planes,
                                  bg, ps, stream);
  if (config == 1)
    return launch<lut::LargeTile>(a, packed, ws, out, mp, np, gp, k_group, planes,
                                  bg, ps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
