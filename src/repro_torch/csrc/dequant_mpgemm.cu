// Dequantization-based mpGEMM (the paper's Fig. 2b baseline): activations
// [M, Gp*K] f32 x packed B-bit weight codes [Np, Gp*B*K/8] -> f32 [M, Np],
// out[m, n] = ws[n] * Σ_k a[m, k] q'[n, k], where q' = Σ_b ps_b (2 bit_b − 1)
// is the reinterpreted weight, its plane bits unfolded from the stored codes
// by Eq. 6. No zero point here: the wrapper applies it as a rank-1 update.
//
// Replaces the TPU kernel kernels/dequant_mpgemm.py:dequant_mpgemm_pallas
// (_unpack_w, _kernel).
//
// Numerics: bf16 tensor cores, f32 sums, within 1e-4 of IEEE f32. The plane
// scales are integers with Σ|ps_b| <= 255 (kernels/lut_mpgemm.py:
// plane_args), so every q' is an integer that bf16 holds exactly. Each f32
// activation is split into kTerms = 3 bf16 terms that sum to it exactly,
// and each term runs its own MMA into the same f32 accumulator
// (bf16_mma.cuh): every product is exact, only the tensor cores' f32 sums
// round (PERF.md gives the error measured at the serve shapes). Two terms
// would leave up to 2^-14 |a|: within 1e-4 of the largest output, but not
// of each output (tests/test_torch_dequant.py holds a CPU emulation of this
// arithmetic to the reference and shows two terms miss its elementwise
// bound; tests/test_torch_cuda.py shows the same of a -DDEQUANT_TERMS=2
// build on the card).
//
// What bounds it on the H100. At decode (M = 4), the packed weight bytes
// (N·K/4 at W2: 1 MB at N = K = 2048, 0.3 µs at 3.35 TB/s) and, far above
// them, the latency of a block's few K-steps. At a 128-token prefill chunk,
// the 3 · 2·M·N·K bf16 MMA operations (0.051 ms at (32000, 2048) at
// 989 TFLOP/s; mma.sync issues below that peak), and beside them the work
// every K-step repeats in the block of every N-tile: the split of the
// activation tile and the q' decode. The design, the bf16 main loop of
// bf16_mma.cuh with the activations as A (F32Rows) and q' as B:
//  * the tensor-core tiles of lut_mma.cuh (MmaTile: 16 x 128 for M <= 16,
//    64 x 64 for M <= 64, 128 x 128 above) with K-steps of 128 / 64 / 32
//    weights, so that two blocks share an SM (kernels/lut_mpgemm.py:
//    BF16_TILES); mma.sync m16n8k16 bf16 x bf16 -> f32 with ldmatrix
//    fragments from shared rows padded by kPad bytes;
//  * per K-step a 3-deep cp.async ring brings the activation tile (rows < M
//    only; rows >= M are zero rows in shared memory, never loaded) and the
//    packed tile; the block splits the activations into the three bf16
//    tiles (bit masks and subtractions, no conversions) and decodes q' into
//    a bf16 tile [BN, kt]: for W2 K=4 one read of a 256-entry byte table per
//    group (a packed byte is one group, its four q' one 8-byte word), else
//    the field decoder;
//  * split-K (kernels/dequant_mpgemm.py: plan) gives as many blocks as one
//    wave of two an SM holds, where the K-steps allow. The f32 partial tiles
//    are reduced in the same launch without atomics on the sums: each block
//    writes its tile to its slot of a workspace [S, M, Np] and bumps its
//    tile's arrival count; the last block to arrive adds the S slots in
//    split order (a batch of loads in flight at once), writes acc · ws[n]
//    and resets the count. Two calls on the same inputs give the same bits.
#include <algorithm>

#include "bf16_mma.cuh"

namespace {

// bf16 terms per activation (dequant_mpgemm.py: PASSES). A build with
// -DDEQUANT_TERMS=2 exists only for the card test that shows two terms miss
// the 1e-4 elementwise bound (tests/test_torch_cuda.py).
#ifndef DEQUANT_TERMS
#define DEQUANT_TERMS 3
#endif
constexpr int kTerms = DEQUANT_TERMS;

// W2 K=4: byte_q[v] holds the four q' of packed byte v (one group, plane 0
// in the low nibble) as bf16, element i at bytes 2i, 2i + 1; built once per
// block with the field decoder.
__device__ __forceinline__ void build_byte_qprime(uint2* byte_q,
                                                  const lut::PlaneScales& ps) {
  for (int v = threadIdx.x; v < 256; v += lut::kThreads) {
    const uint8_t byte = static_cast<uint8_t>(v);
    int q[lut::kMaxKGroup];
    lut::qprime_group(&byte, 0, 2, 4, ps, q);
    byte_q[v] = make_uint2(lut::bf16_bits(q[0]) | lut::bf16_bits(q[1]) << 16,
                           lut::bf16_bits(q[2]) | lut::bf16_bits(q[3]) << 16);
  }
}

// q' tile [bn, bg·K] bf16 of one K-step (row stride ldb bytes) from the
// packed tile in shared memory (pbs bytes per channel), one (channel, group)
// per work item: the (planes, k_group) other than W2 K=4.
__device__ __forceinline__ void decode_qprime(const uint8_t* Ps, int pbs,
                                              uint8_t* Bs, int ldb, int bn,
                                              int bg, int planes, int k_group,
                                              const lut::PlaneScales& ps) {
  for (int p = threadIdx.x; p < bn * bg; p += lut::kThreads) {
    const int nl = p / bg, gl = p % bg;
    int q[lut::kMaxKGroup];
    lut::qprime_group(Ps + nl * pbs, gl, planes, k_group, ps, q);
    unsigned short* dst =
        reinterpret_cast<unsigned short*>(Bs + nl * ldb) + gl * k_group;
    for (int i = 0; i < k_group; ++i)
      dst[i] = static_cast<unsigned short>(lut::bf16_bits(static_cast<float>(q[i])));
  }
}

// B = q' [bn, bg·K] bf16: for W2 K=4 one read of the byte table per group
// (its 8-byte words land as the int8 CW decoder's do), else the field
// decoder.
struct QprimeB {
  int planes, k_group;
  lut::PlaneScales ps;

  static constexpr int kTableBytes = 256 * sizeof(uint2);
  __device__ bool w2k4() const { return k_group == 4 && planes == 2; }
  __device__ void init(uint8_t* table) const {
    if (w2k4()) build_byte_qprime(reinterpret_cast<uint2*>(table), ps);
  }
  __device__ void decode(const uint8_t* Ps, int pbs, uint8_t* Bs, int ldb, int bn,
                         int bg_shift, const uint8_t* table) const {
    if (w2k4())
      lut::decode_cw_w2k4(Ps, pbs, reinterpret_cast<int8_t*>(Bs), ldb, bn, bg_shift,
                          reinterpret_cast<const uint2*>(table));
    else
      decode_qprime(Ps, pbs, Bs, ldb, bn, 1 << bg_shift, planes, k_group, ps);
  }
};

template <class C>
__global__ void __launch_bounds__(lut::kThreads, 2)
dequant_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ ws, float* __restrict__ out,
                   float* __restrict__ work, int* __restrict__ arrivals, int m,
                   int np, int gp, int k_group, int planes, int bg, int splits,
                   int stages, int pchunk, lut::PlaneScales ps) {
  lut::bf16_block<C, kTerms>(
      lut::F32Rows<C>{x, static_cast<long long>(gp) * k_group, m},
      QprimeB{planes, k_group, ps}, packed, ws, out, work, arrivals, m, np, gp, bg,
      bg * k_group, bg * planes * k_group / 8, splits, stages, pchunk);
}

// The ring's stages and the dynamic shared memory of a launch: per stage
// the activation tile of x's rows (f32) and the packed tile, then the q'
// tile, the kTerms bf16 term tiles and the W2 K=4 byte table.
template <class C>
lut::RingPlan ring_for(int m, int kt, int pbs) {
  return lut::bf16_ring<C>(lut::F32Rows<C>::stage_bytes(m, kt, 0), kt, pbs, kTerms,
                           QprimeB::kTableBytes);
}

template <class C>
int launch(const float* x, const uint8_t* packed, const float* ws, float* out,
           float* work, int* arrivals, int m, int np, int gp, int k_group,
           int planes, int bg, int splits, const lut::PlaneScales& ps,
           cudaStream_t stream) {
  const int kt = bg * k_group;
  const int pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (np % C::BN || kt % 16 || pbs % 4 || (bg & (bg - 1)) || splits < 1 ||
      splits > gp / bg || (splits > 1) != (work != nullptr && arrivals != nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const lut::RingPlan plan = ring_for<C>(m, kt, pbs);
  if (plan.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dequant_mma_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, (m + C::BM - 1) / C::BM, splits);
  kernel<<<grid, lut::kThreads, plan.smem, stream>>>(
      x, packed, ws, out, work, arrivals, m, np, gp, k_group, planes, bg, splits,
      plan.stages, lut::packed_chunk(pbs, pb, pk), ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// m: rows of x and out (any number). config: MmaSmall (0), MmaMid (1),
// MmaLarge (2). bg: groups per K-step (gp % bg == 0, a power of two, the
// step starting on a byte of the packed row). splits: K-ranges; when > 1,
// an f32 workspace [splits, m, np] and arrival counts [ceil(m / BM) * np /
// BN], zero on entry and left zero. plane_scales: host array of `planes`
// ints.
extern "C" int dequant_mpgemm_launch(const float* x, const uint8_t* packed,
                                     const float* ws, float* out, float* workspace,
                                     int* arrivals, int m, int np, int gp,
                                     int k_group, int planes,
                                     const int* plane_scales, int config, int bg,
                                     int splits, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || (bg * planes * k_group) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  switch (config) {
    case 0:
      return launch<lut::MmaSmall>(x, packed, ws, out, workspace, arrivals, m, np,
                                   gp, k_group, planes, bg, splits, ps, stream);
    case 1:
      return launch<lut::MmaMid>(x, packed, ws, out, workspace, arrivals, m, np, gp,
                                 k_group, planes, bg, splits, ps, stream);
    case 2:
      return launch<lut::MmaLarge>(x, packed, ws, out, workspace, arrivals, m, np,
                                   gp, k_group, planes, bg, splits, ps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The ring plan dequant_mpgemm_launch takes for these arguments: returns
// its dynamic shared memory in bytes and writes its stages (0: does not
// fit), or returns -1 for arguments the launch refuses.
extern "C" long long dequant_mpgemm_ring(int m, int k_group, int planes,
                                         int config, int bg, int* stages) {
  if (m < 1 || !lut::valid_k_group(k_group) || planes < 1 ||
      planes > lut::kMaxPlanes || bg < 1 || (bg * planes * k_group) % 8)
    return -1;
  const int kt = bg * k_group, pbs = bg * planes * k_group / 8;
  lut::RingPlan plan;
  switch (config) {
    case 0: plan = ring_for<lut::MmaSmall>(m, kt, pbs); break;
    case 1: plan = ring_for<lut::MmaMid>(m, kt, pbs); break;
    case 2: plan = ring_for<lut::MmaLarge>(m, kt, pbs); break;
    default: return -1;
  }
  *stages = plan.stages;
  return static_cast<long long>(plan.smem);
}
