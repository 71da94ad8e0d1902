// Fused precompute -> lookup LUT mpGEMM: activations [M, Gp*K] f32 x packed
// B-bit weight codes [Np, Gp*B*K/8] -> f32 [M, Np]. Each table tile is
// built in shared memory from the activation tile (quantized to INT8 with
// the wrapper's per-row scale, or per_group quantize->dequantize, or left
// in f32) and contracted at once; it never reaches device memory.
//
// Replaces the TPU kernel kernels/fused_lut_mpgemm.py:fused_lut_mpgemm_pallas
// (_table_block, _kernel_int, _kernel_f32).
//
// What bounds it on the H100. At decode (M = batch <= 64) the kernel reads
// each packed weight byte once and does few operations per byte, so bytes
// bound it: about 1.1 MB at M = 4, (N, K) = (2048, 2048), 0.34 µs at
// 3.35 TB/s. To approach that a kernel must keep the whole card busy, with
// loads in flight, for a few microseconds. A first version (one block per
// 8 x 32 outputs walking all of K, the table rebuilt for 8 padded rows,
// __dp4a sums) ran 64 blocks at N = 2048 and 8 at N = 256, and took
// 0.11 ms at both.
//
// The int path (per_row: exact int32 sums; the decode path) now runs the
// tensor-core main loop of lut_mma.cuh with the table built from x as A:
//  * the staged int path's tiles (16 x 128 at M <= 16, 64 x 64 at M <= 64,
//    128 x 128 above) with K-steps of 256 table entries, twice the staged
//    path's, since at decode each step's phases wait on each other in turn
//    and fewer, wider steps cost less (kernels/fused_lut_mpgemm.py:
//    int_tile); the activation and packed tiles of the next K-steps stream
//    in through a cp.async ring;
//  * each block builds only its own table tile: its rows < M (rows >= M
//    are zero) x its K-range x E entries, with table_precompute's entry
//    and quantization code, so the codes, the sums and the epilogue equal
//    the staged pair's bit for bit;
//  * the W2 K=4 CW decode reads the 256-entry byte table;
//  * split-K (kernels/lut_mpgemm.py: split_for) gives tiles x S >= 132
//    blocks where the K-steps allow. The split sums are reduced in the same
//    launch: each block adds its int32 tile into a workspace with atomics,
//    then bumps its tile's arrival count; the last block to arrive reads
//    the sum (and zeroes the workspace tile and the count for the next
//    call) and writes the epilogue (float(acc) · rs[m]) · ws[n]. Integer
//    addition is exact in any order, so the split changes no bit.
// The f32 paths (None tables, and per_group quantize -> dequantize) replace
// the TPU kernel's _kernel_f32 (IEEE f32 sums, each output within rtol =
// atol = 1e-4 of the reference). They run the bf16 main loop of
// bf16_mma.cuh, as lut_mpgemm.cu's f32 paths do, with the table built in
// shared memory as A: each K-step's activation tile [rows < M, bg·K]
// streams in through the cp.async ring, and the block computes its entries
// (half_table_entry, and per_group quantize_entry(entry, s) · s, as
// table_precompute does, so the values equal the staged table's) and
// splits each into three bf16 terms as it builds it. What bounds them: at
// decode the packed weight bytes and the latency of a block's few K-steps
// (an IEEE FMA first version, one block per 8 x 32 tile walking all of K,
// took 0.12-1.03 ms at M = 4, 10-17x a bf16 torch.matmul); the table build
// is repeated by the block of every N-tile, but it is a few adds per entry
// beside the three MMA passes. x's rows are not padded: rows >= M are zero
// rows in shared memory. Split-K (kernels/lut_mpgemm.py: f32_plan) fills
// one wave of two blocks an SM; the f32 partials meet in a workspace and
// the last block of a tile adds them in split order, in the same launch,
// so two calls give the same bits.
//
// The expert axis (kernels/fused_lut_mpgemm.py: *_batched): the MoE FFN's E
// experts' products in one launch, which the reference gets by vmapping
// fused_lut_mpgemm_pallas over the experts (a grid axis of the pallas_call). With
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

template <class C>
__global__ void __launch_bounds__(lut::kThreads, 2)
fused_mma_kernel(const float* __restrict__ x, const float* __restrict__ rs,
                 const uint8_t* __restrict__ packed, const float* __restrict__ ws,
                 float* __restrict__ out, int* __restrict__ work,
                 int* __restrict__ arrivals, int m, int np, int gp, int k_group,
                 int planes, int bg, int splits, int stages, int pchunk,
                 lut::PlaneScales ps, int cp) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN, z = blockIdx.z;
  const int steps = gp / bg, q = steps / splits, r = steps % splits;
  const int first = z * q + min(z, r), count = q + (z < r ? 1 : 0);
  // the block's expert (lut_mma.cuh: expert_of): its codes and scales
  const long long e = lut::expert_of(m0, cp);
  packed += e * np * (static_cast<long long>(gp) * planes * k_group / 8);
  ws += e * np;
  int acc[C::MT][C::NT][4];
  const lut::ActivationA<C> a{x, rs, static_cast<long long>(gp) * k_group, m,
                              k_group, __ffs(bg) - 1};
  lut::int_mainloop<C>(a, packed, gp, k_group, planes, bg, first, count,
                       stages, pchunk, ps, m0, n0, acc);
  auto store = [&](int ml, int nl, int v0, int v1) {
    const int mg = m0 + ml, n = n0 + nl;
    *reinterpret_cast<float2*>(out + static_cast<long long>(mg) * np + n) =
        lut::int_epilogue(v0, v1, rs[mg], ws, n);
  };
  if (splits == 1) {
    lut::for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
      if (m0 + ml < m) store(ml, nl, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
    });
    return;
  }
  // split-K: add this block's sums into the tile's workspace [m, np]
  const auto at = [&](int ml, int nl) {
    return work + static_cast<long long>(m0 + ml) * np + n0 + nl;
  };
  lut::for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
    if (m0 + ml < m) {
      atomicAdd(at(ml, nl), acc[mi][nj][2 * h]);
      atomicAdd(at(ml, nl) + 1, acc[mi][nj][2 * h + 1]);
    }
  });
  __threadfence();  // this thread's adds are seen before the arrival below
  __syncthreads();
  __shared__ int last;
  int* arrival = arrivals + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(arrival, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every split's adds have landed; read and zero the sums
  lut::for_each_pair<C>([&](int, int, int, int ml, int nl) {
    if (m0 + ml < m) {
      const int v0 = atomicExch(at(ml, nl), 0), v1 = atomicExch(at(ml, nl) + 1, 0);
      store(ml, nl, v0, v1);
    }
  });
  if (threadIdx.x == 0) *arrival = 0;
}

template <class C>
int launch_int(const float* x, const float* rs, const uint8_t* packed,
               const float* ws, float* out, int* work, int* arrivals, int m,
               int np, int gp, int k_group, int planes, int bg, int splits,
               const lut::PlaneScales& ps, int cp, cudaStream_t stream) {
  const int kt = bg << (k_group - 1), ld = kt + lut::kPad;
  const int pbs = bg * planes * k_group / 8;
  const int x_bytes = bg * k_group * static_cast<int>(sizeof(float));
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (np % C::BN || kt % 32 || pbs % 4 || x_bytes % 16 || (bg & (bg - 1)) ||
      !lut::valid_experts(cp, C::BM, m) || splits < 1 || splits > gp / bg ||
      (splits > 1) != (work != nullptr && arrivals != nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const lut::RingPlan plan = lut::ring_plan(
      static_cast<size_t>(std::min(C::BM, m)) * x_bytes + C::BN * pbs,
      static_cast<size_t>(C::BN + C::BM) * ld + 256 * sizeof(uint2));
  if (plan.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_mma_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, (m + C::BM - 1) / C::BM, splits);
  kernel<<<grid, lut::kThreads, plan.smem, stream>>>(
      x, rs, packed, ws, out, work, arrivals, m, np, gp, k_group, planes, bg,
      splits, plan.stages, lut::packed_chunk(pbs, pb, pk), ps, cp);
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
// table built from x in shared memory (BuiltTable: f32 entries, or per_group
// quantize -> dequantize), B the CW entries.
template <class C, int kMode>
__global__ void __launch_bounds__(lut::kThreads, 2)
fused_bf16_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ ws, float* __restrict__ out,
                  float* __restrict__ work, int* __restrict__ arrivals, int m,
                  int np, int gp, int k_group, int planes, int bg, int splits,
                  int stages, int pchunk, lut::PlaneScales ps, int cp) {
  lut::bf16_block<C, kTerms>(
      lut::BuiltTable<C, kMode == lut::kPerGroup>{
          x, static_cast<long long>(gp) * k_group, m, k_group},
      lut::CwB{planes, k_group, ps}, packed, ws, out, work, arrivals, m, np, gp, bg,
      bg << (k_group - 1), bg * planes * k_group / 8, splits, stages, pchunk, cp);
}

// The ring's stages and the dynamic shared memory of an f32 launch.
template <class C, int kMode>
lut::RingPlan f32_ring(int m, int k_group, int planes, int bg) {
  const int kt = bg << (k_group - 1), pbs = bg * planes * k_group / 8;
  return lut::bf16_ring<C>(
      lut::BuiltTable<C, kMode == lut::kPerGroup>::stage_bytes(m, kt, k_group), kt,
      pbs, kTerms, lut::CwB::kTableBytes);
}

template <class C, int kMode>
int launch_f32(const float* x, const uint8_t* packed, const float* ws, float* out,
               float* work, int* arrivals, int m, int np, int gp, int k_group,
               int planes, int bg, int splits, const lut::PlaneScales& ps,
               int cp, cudaStream_t stream) {
  const int kt = bg << (k_group - 1), pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (np % C::BN || kt % 16 || pbs % 4 || (bg * k_group) % 4 || (bg & (bg - 1)) ||
      !lut::valid_experts(cp, C::BM, m) || splits < 1 || splits > gp / bg ||
      (splits > 1) != (work != nullptr && arrivals != nullptr) ||
      reinterpret_cast<uintptr_t>(x) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const lut::RingPlan plan = f32_ring<C, kMode>(m, k_group, planes, bg);
  if (plan.stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_bf16_kernel<C, kMode>;
  cudaError_t err = lut::allow_smem(kernel, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, (m + C::BM - 1) / C::BM, splits);
  kernel<<<grid, lut::kThreads, plan.smem, stream>>>(
      x, packed, ws, out, work, arrivals, m, np, gp, k_group, planes, bg, splits,
      plan.stages, lut::packed_chunk(pbs, pb, pk), ps, cp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 f32 table, 1 per_row INT8 (row_scale [m]), 2 per_group
// quantize->dequantize. m: rows of x and out (any number). config: the
// tile, MmaSmall (0), MmaMid (1), MmaLarge (2). bg: groups per K-step
// (gp % bg == 0, a power of two). splits: K-ranges; when > 1, a workspace
// and arrival counts [ceil(m / BM) * np / BN], zero on entry and left
// zero: for mode 1 int32 [m, np] (the splits add into it), for modes 0 and
// 2 f32 [splits, m, np] (a slot a split). plane_scales: host array of
// `planes` ints. cp: 0, or the expert axis (lut_mma.cuh: expert_of): the m
// rows are m / cp experts' row blocks of cp rows (a multiple of the tile's
// BM; rows past an expert's own are zero rows), packed is [m / cp, np,
// gp·B·K/8] and ws [m / cp, np].
extern "C" int fused_lut_mpgemm_launch(const float* x, const float* row_scale,
                                       const uint8_t* packed, const float* ws,
                                       float* out, void* workspace, int* arrivals,
                                       int m, int np, int gp, int k_group,
                                       int planes, const int* plane_scales,
                                       int mode, int config, int bg, int splits,
                                       int cp, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || ((bg << (k_group - 1)) % 4) ||
      (bg * planes * k_group) % 8 || mode < lut::kFloat || mode > lut::kPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  if (mode == lut::kPerRow) {
    int* work = static_cast<int*>(workspace);
    switch (config) {
      case 0:
        return launch_int<lut::MmaSmall>(x, row_scale, packed, ws, out, work,
                                         arrivals, m, np, gp, k_group, planes, bg,
                                         splits, ps, cp, stream);
      case 1:
        return launch_int<lut::MmaMid>(x, row_scale, packed, ws, out, work,
                                       arrivals, m, np, gp, k_group, planes, bg,
                                       splits, ps, cp, stream);
      case 2:
        return launch_int<lut::MmaLarge>(x, row_scale, packed, ws, out, work,
                                         arrivals, m, np, gp, k_group, planes, bg,
                                         splits, ps, cp, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  float* work = static_cast<float*>(workspace);
  return lut::with_tile(config, static_cast<int>(cudaErrorInvalidValue), [&](auto tile) {
    using C = decltype(tile);
    return mode == lut::kFloat
               ? launch_f32<C, lut::kFloat>(x, packed, ws, out, work, arrivals, m, np,
                                            gp, k_group, planes, bg, splits, ps,
                                            cp, stream)
               : launch_f32<C, lut::kPerGroup>(x, packed, ws, out, work, arrivals, m,
                                               np, gp, k_group, planes, bg, splits,
                                               ps, cp, stream);
  });
}

// The ring plan fused_lut_mpgemm_launch takes for an f32 path (mode 0 or 2)
// with these arguments: returns its dynamic shared memory in bytes and
// writes its stages (0: does not fit), or returns -1 for arguments it
// refuses.
extern "C" long long fused_lut_mpgemm_ring(int m, int k_group, int planes,
                                           int mode, int config, int bg,
                                           int* stages) {
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
