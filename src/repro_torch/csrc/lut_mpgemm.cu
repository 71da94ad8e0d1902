// Staged LUT mpGEMM: table [Mp, Gp*E] (int8 per_row, int8 per_group, or
// f32) x packed B-bit weight codes [Np, Gp*B*K/8] -> f32 [Mp, Np].
//
// Replaces the TPU kernel kernels/lut_mpgemm.py:lut_mpgemm_pallas
// (_kernel_int, _kernel_f32, _unpack_cw).
//
// What bounds it on the H100. At a 128-token prefill chunk the lookup is the
// one-hot contraction T·CW: M·N·G·E int8 multiply-adds (2.15 G operations at
// N = K = 2048, about 1.1 µs at the dense int8 tensor-core peak) against
// M·G·E + N·G·B·K/8 input bytes (0.79 µs at 3.35 TB/s). Both bounds are a
// microsecond, so what bounds a kernel is how much of the card it keeps
// busy: a first version of this kernel ran the contraction on __dp4a in one
// block per 64 x 64 output tile, each block walking all of K, which left
// half of the 132 SMs idle at N = 2048 and ran at about 10 TOP/s.
//
// The int path (per_row tables: exact int32 sums; the serve path) runs the
// tensor-core main loop of lut_mma.cuh with the table tile as A. It:
//  * contracts on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32,
//    with fragments loaded by ldmatrix from shared rows padded by 16 bytes
//    (8 consecutive rows fall in distinct banks, rows stay 16-byte aligned);
//  * keeps up to 128 table rows in one block (the whole prefill chunk, a
//    128 x 128 output tile; 64 x 64 and 16 x 128 for fewer rows), so each
//    (channel, group) of CW is decoded once per K-step and serves every
//    row; at W2 K=4 the decode is one read of a 256-entry table per packed
//    byte (built per block), since computing the entries cost more than the
//    contraction;
//  * splits the K-steps into S contiguous ranges (kernels/lut_mpgemm.py:
//    split_for) so that tiles x S blocks fill the SMs; the partial int32
//    sums go to a workspace [S, Mp, Np] and a second kernel adds them in
//    order and applies the epilogue (int32 adds are exact, so the split
//    changes no bit);
//  * streams the table and packed bytes of the next K-steps through a ring
//    of cp.async copies (3 stages, 2 where 3 do not fit) while the current
//    one is decoded and contracted.
// The epilogue is (float(acc) · ts[m]) · ws[n] in IEEE fp32, as the plain
// version's.
//
// The f32 paths (None tables, f32 [M, G·E]; per_group tables, INT8 codes
// with scales [M, G]) replace the TPU kernel's _kernel_f32 (IEEE f32 sums,
// each output within rtol = atol = 1e-4 of the reference). What bounds
// them on the H100 at a 128-token chunk: the contraction over G·E = 2K
// table entries per weight at W2 K=4, twice dequant_mpgemm's MMA work, on
// the bf16 tensor cores (IEEE f32 FMA, as a first version ran it from
// shared memory, one block per 8 x 32 or 64 x 64 tile walking all of K,
// took 36-83x a bf16 torch.matmul). They run the bf16 main loop of
// bf16_mma.cuh with dequant_mpgemm's tiles and split-K:
//  * A: the table values (None: as they are; per_group: float(code) ·
//    scale, one IEEE product, as the plain version dequantizes), each split
//    into three bf16 terms that sum to it exactly; B: the CW entries,
//    integers |CW| <= 255, exact in bf16 (at W2 K=4 one read of a 256-entry
//    byte table per group). Every product is exact; only the f32 sums
//    round. The rows of the table are not padded: rows >= M are zero rows
//    in shared memory, never loaded;
//  * a 3-deep cp.async ring for the table tile (the codes and their group
//    scales for per_group) and the packed tile;
//  * split-K (kernels/lut_mpgemm.py: f32_plan) to one wave of two blocks an
//    SM; the f32 partial tiles meet in a workspace [S, M, Np] and the last
//    block of a tile adds them in split order, in the same launch, without
//    atomics on the sums: two calls give the same bits.
//
// The expert axis (kernels/lut_mpgemm.py: *_batched): the MoE FFN's E
// experts' products in one launch, which the reference gets by vmapping
// lut_mpgemm_pallas over the experts (a grid axis of the pallas_call). With
// cp > 0 the rows are E row blocks of cp rows, each padded to the tile's BM,
// and a block reads the codes and scales of its rows' expert
// (lut_mma.cuh: expert_of); the grid, split-K and arrival counts are the
// 2-D ones over the E·cp rows. At olmoe-1b-7b's experts (E = 64; N, K =
// 1024, 2048 or 2048, 1024) a call reads 33.5 MB of packed codes, a bytes
// bound of 0.010 ms, in 512+ blocks of S = 1, each walking every K-step of
// its expert: the steps' latency, not the bytes, sets its time. Empty
// expert rows are zero rows and are computed, as the reference computes them.
#include <algorithm>

#include "bf16_mma.cuh"

namespace {

// ---------------------------------------------------------------- int path

// acc = Σ over this block's K-steps [first, first + count) of table x CW.
// With `part` null (one split) the block writes the epilogue itself; else
// it writes its int32 partial sums to part[blockIdx.z].
template <class C>
__global__ void __launch_bounds__(lut::kThreads, 2)
lut_mma_kernel(const int8_t* __restrict__ tv, const float* __restrict__ ts,
               const uint8_t* __restrict__ packed, const float* __restrict__ ws,
               float* __restrict__ out, int* __restrict__ part, int mp, int np,
               int gp, int k_group, int planes, int bg, int splits, int stages,
               int pchunk, lut::PlaneScales ps, int cp) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN, z = blockIdx.z;
  const int steps = gp / bg, q = steps / splits, r = steps % splits;
  const int first = z * q + min(z, r), count = q + (z < r ? 1 : 0);
  // the block's expert (lut_mma.cuh: expert_of): its codes and scales
  const long long e = lut::expert_of(m0, cp);
  packed += e * np * (static_cast<long long>(gp) * planes * k_group / 8);
  ws += e * np;
  int acc[C::MT][C::NT][4];
  const lut::TableA<C> a{tv, static_cast<long long>(gp) << (k_group - 1)};
  lut::int_mainloop<C>(a, packed, gp, k_group, planes, bg, first, count,
                       stages, pchunk, ps, m0, n0, acc);
  lut::for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
    const int m = m0 + ml, n = n0 + nl;
    const int v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
    if (part != nullptr)
      *reinterpret_cast<int2*>(part + (static_cast<long long>(z) * mp + m) * np + n) =
          make_int2(v0, v1);
    else
      *reinterpret_cast<float2*>(out + static_cast<long long>(m) * np + n) =
          lut::int_epilogue(v0, v1, ts[m], ws, n);
  });
}

// out = (float(Σ_z part[z]) · ts[m]) · ws[n], four outputs per thread; with
// cp > 0, ws[n] of row m's expert m / cp.
__global__ void __launch_bounds__(lut::kThreads)
splitk_epilogue_kernel(const int* __restrict__ part, const float* __restrict__ ts,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int mp, int np, int splits, int cp) {
  const long long quads = static_cast<long long>(mp) * np / 4;
  const int4* p4 = reinterpret_cast<const int4*>(part);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < quads; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int4 s = p4[i];
    for (int z = 1; z < splits; ++z) {
      const int4 v = p4[z * quads + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int m = static_cast<int>(4 * i / np);
    const int n = static_cast<int>(4 * i % np) + (cp == 0 ? 0 : m / cp * np);
    const float tm = ts[m];
    reinterpret_cast<float4*>(out)[i] =
        make_float4(__fmul_rn(__fmul_rn(__int2float_rn(s.x), tm), ws[n]),
                    __fmul_rn(__fmul_rn(__int2float_rn(s.y), tm), ws[n + 1]),
                    __fmul_rn(__fmul_rn(__int2float_rn(s.z), tm), ws[n + 2]),
                    __fmul_rn(__fmul_rn(__int2float_rn(s.w), tm), ws[n + 3]));
  }
}

template <class C>
int launch_int(const int8_t* tv, const float* ts, const uint8_t* packed,
               const float* ws, float* out, int* part, int mp, int np, int gp,
               int k_group, int planes, int bg, int splits,
               const lut::PlaneScales& ps, int cp, cudaStream_t stream) {
  const int kt = bg << (k_group - 1), ld = kt + lut::kPad;
  const int pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (mp % C::BM || np % C::BN || kt % 32 || pbs % 4 || (bg & (bg - 1)) ||
      !lut::valid_experts(cp, C::BM, mp) || splits < 1 ||
      splits > gp / bg || (splits > 1) != (part != nullptr) ||
      reinterpret_cast<uintptr_t>(tv) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const lut::RingPlan plan = lut::ring_plan(
      static_cast<size_t>(C::BM) * ld + C::BN * pbs,
      static_cast<size_t>(C::BN) * ld + 256 * sizeof(uint2));
  if (plan.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lut_mma_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM, splits);
  kernel<<<grid, lut::kThreads, plan.smem, stream>>>(
      tv, ts, packed, ws, out, part, mp, np, gp, k_group, planes, bg, splits,
      plan.stages, lut::packed_chunk(pbs, pb, pk), ps, cp);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long quads = static_cast<long long>(mp) * np / 4;
  const int blocks = static_cast<int>(
      std::min<long long>((quads + lut::kThreads - 1) / lut::kThreads, 132 * 8));
  splitk_epilogue_kernel<<<blocks, lut::kThreads, 0, stream>>>(part, ts, ws, out,
                                                               mp, np, splits, cp);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32 path

// bf16 terms per table value (kernels/lut_mpgemm.py: F32_PASSES). A build
// with -DLUT_TERMS=2 exists only for the card test of the term count
// (tests/test_torch_cuda.py).
#ifndef LUT_TERMS
#define LUT_TERMS 3
#endif
constexpr int kTerms = LUT_TERMS;

// The float-table paths on the bf16 main loop of bf16_mma.cuh: A is the
// None table as it is (F32Rows) or the per_group table's codes times their
// group scales (ScaledCodes), B the CW entries.
template <class C, int kMode>
__global__ void __launch_bounds__(lut::kThreads, 2)
lut_bf16_kernel(const void* __restrict__ tv, const float* __restrict__ ts,
                const uint8_t* __restrict__ packed, const float* __restrict__ ws,
                float* __restrict__ out, float* __restrict__ work,
                int* __restrict__ arrivals, int m, int np, int gp, int k_group,
                int planes, int bg, int splits, int stages, int pchunk,
                lut::PlaneScales ps, int cp) {
  const int kt = bg << (k_group - 1), pbs = bg * planes * k_group / 8;
  const lut::CwB b{planes, k_group, ps};
  if constexpr (kMode == lut::kFloat)
    lut::bf16_block<C, kTerms>(
        lut::F32Rows<C>{static_cast<const float*>(tv),
                        static_cast<long long>(gp) << (k_group - 1), m},
        b, packed, ws, out, work, arrivals, m, np, gp, bg, kt, pbs, splits, stages,
        pchunk, cp);
  else
    lut::bf16_block<C, kTerms>(
        lut::ScaledCodes<C>{static_cast<const int8_t*>(tv), ts, gp, m, k_group}, b,
        packed, ws, out, work, arrivals, m, np, gp, bg, kt, pbs, splits, stages,
        pchunk, cp);
}

// The ring's stages and the dynamic shared memory of an f32 launch.
template <class C, int kMode>
lut::RingPlan f32_ring(int m, int k_group, int planes, int bg) {
  const int kt = bg << (k_group - 1), pbs = bg * planes * k_group / 8;
  const int a_bytes = kMode == lut::kFloat
                          ? lut::F32Rows<C>::stage_bytes(m, kt, k_group)
                          : lut::ScaledCodes<C>::stage_bytes(m, kt, k_group);
  return lut::bf16_ring<C>(a_bytes, kt, pbs, kTerms, lut::CwB::kTableBytes);
}

template <class C, int kMode>
int launch_f32(const void* tv, const float* ts, const uint8_t* packed,
               const float* ws, float* out, float* work, int* arrivals, int m,
               int np, int gp, int k_group, int planes, int bg, int splits,
               const lut::PlaneScales& ps, int cp, cudaStream_t stream) {
  const int kt = bg << (k_group - 1), pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (np % C::BN || kt % 16 || pbs % 4 || (bg & (bg - 1)) ||
      !lut::valid_experts(cp, C::BM, m) || splits < 1 ||
      splits > gp / bg || (splits > 1) != (work != nullptr && arrivals != nullptr) ||
      (kMode == lut::kPerGroup && ts == nullptr) ||
      reinterpret_cast<uintptr_t>(tv) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const lut::RingPlan plan = f32_ring<C, kMode>(m, k_group, planes, bg);
  if (plan.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lut_bf16_kernel<C, kMode>;
  cudaError_t err = lut::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, (m + C::BM - 1) / C::BM, splits);
  kernel<<<grid, lut::kThreads, plan.smem, stream>>>(
      tv, ts, packed, ws, out, work, arrivals, m, np, gp, k_group, planes, bg,
      splits, plan.stages, lut::packed_chunk(pbs, pb, pk), ps, cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 f32 table, 1 int8 table + per-row scale ts [mp], 2 int8 table +
// per-group scale ts [mp, gp]. config: the tile, MmaSmall (0), MmaMid (1),
// MmaLarge (2). bg: groups per K-step (gp % bg == 0, a power of two).
// splits: K-ranges. Mode 1 (the int path): mp rows padded to the tile;
// when splits > 1 an int32 workspace [splits, mp, np] summed by a second
// kernel, and no arrival counts. Modes 0 and 2 (the f32 paths): any mp;
// when splits > 1 an f32 workspace [splits, mp, np] and arrival counts
// [ceil(mp / BM) * np / BN], zero on entry and left zero. plane_scales:
// host array of `planes` ints. cp: 0, or the expert axis (lut_mma.cuh:
// expert_of): the mp rows are mp / cp experts' row blocks of cp rows (a
// multiple of the tile's BM), packed is [mp / cp, np, gp·B·K/8] and ws
// [mp / cp, np], and each expert's rows contract against its own codes.
extern "C" int lut_mpgemm_launch(const void* tv, const float* ts,
                                 const uint8_t* packed, const float* ws,
                                 float* out, void* workspace, int* arrivals,
                                 int mp, int np, int gp, int k_group, int planes,
                                 const int* plane_scales, int mode, int config,
                                 int bg, int splits, int cp, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || ((bg << (k_group - 1)) % 4) ||
      (bg * planes * k_group) % 8 || mode < lut::kFloat || mode > lut::kPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  if (mode == lut::kPerRow) {
    const int8_t* t8 = static_cast<const int8_t*>(tv);
    int* work = static_cast<int*>(workspace);
    if (arrivals != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    switch (config) {
      case 0:
        return launch_int<lut::MmaSmall>(t8, ts, packed, ws, out, work, mp, np, gp,
                                    k_group, planes, bg, splits, ps, cp, stream);
      case 1:
        return launch_int<lut::MmaMid>(t8, ts, packed, ws, out, work, mp, np, gp,
                                  k_group, planes, bg, splits, ps, cp, stream);
      case 2:
        return launch_int<lut::MmaLarge>(t8, ts, packed, ws, out, work, mp, np, gp,
                                    k_group, planes, bg, splits, ps, cp, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  float* work = static_cast<float*>(workspace);
  return lut::with_tile(config, static_cast<int>(cudaErrorInvalidValue), [&](auto tile) {
    using C = decltype(tile);
    return mode == lut::kFloat
               ? launch_f32<C, lut::kFloat>(tv, ts, packed, ws, out, work, arrivals,
                                            mp, np, gp, k_group, planes, bg, splits,
                                            ps, cp, stream)
               : launch_f32<C, lut::kPerGroup>(tv, ts, packed, ws, out, work,
                                               arrivals, mp, np, gp, k_group, planes,
                                               bg, splits, ps, cp, stream);
  });
}

// The ring plan lut_mpgemm_launch takes for an f32 path (mode 0 or 2) with
// these arguments: returns its dynamic shared memory in bytes and writes
// its stages (0: does not fit), or returns -1 for arguments it refuses.
extern "C" long long lut_mpgemm_ring(int m, int k_group, int planes, int mode,
                                     int config, int bg, int* stages) {
  if (m < 1 || !lut::valid_k_group(k_group) || planes < 1 ||
      planes > lut::kMaxPlanes || bg < 1 || (bg * planes * k_group) % 8 ||
      (mode != lut::kFloat && mode != lut::kPerGroup))
    return -1;
  const lut::RingPlan plan = lut::with_tile(
      config, lut::RingPlan{-1, 0}, [&](auto tile) {
        using C = decltype(tile);
        return mode == lut::kFloat ? f32_ring<C, lut::kFloat>(m, k_group, planes, bg)
                                   : f32_ring<C, lut::kPerGroup>(m, k_group, planes, bg);
      });
  if (plan.stages < 0) return -1;
  *stages = plan.stages;
  return static_cast<long long>(plan.smem);
}
