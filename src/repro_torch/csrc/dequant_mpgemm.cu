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
// activation is split into kTerms = 3 bf16 terms that sum to it exactly
// (split_terms: each term is the remainder with its low 16 bits cleared),
// and each term runs its own MMA into the same f32 accumulator: every
// product is exact, only the tensor cores' f32 sums round (PERF.md gives
// the error measured at the serve shapes). Two terms would leave up to
// 2^-14 |a|: within 1e-4 of the largest output, but not of each output
// (tests/test_torch_dequant.py holds a CPU emulation of this arithmetic to
// the reference and shows two terms miss its elementwise bound;
// tests/test_torch_cuda.py shows the same of a -DDEQUANT_TERMS=2 build on
// the card).
//
// What bounds it on the H100. At decode (M = 4), the packed weight bytes
// (N·K/4 at W2: 1 MB at N = K = 2048, 0.3 µs at 3.35 TB/s) and, far above
// them, the latency of a block's few K-steps. At a 128-token prefill chunk,
// the 3 · 2·M·N·K bf16 MMA operations (0.051 ms at (32000, 2048) at
// 989 TFLOP/s; mma.sync issues below that peak), and beside them the work
// every K-step repeats in the block of every N-tile: the split of the
// activation tile and the q' decode. The design:
//  * the tensor-core tiles of lut_mma.cuh (MmaTile: 16 x 128 for M <= 16,
//    64 x 64 for M <= 64, 128 x 128 above) with K-steps of 128 / 64 / 32
//    weights, so that two blocks share an SM (kernels/dequant_mpgemm.py:
//    TILES); mma.sync m16n8k16 bf16 x bf16 -> f32 with ldmatrix fragments
//    from shared rows padded by kPad bytes;
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
#include <cuda_bf16.h>

#include "lut_mma.cuh"

namespace {

// bf16 terms per activation (dequant_mpgemm.py: PASSES). A build with
// -DDEQUANT_TERMS=2 exists only for the card test that shows two terms miss
// the 1e-4 elementwise bound (tests/test_torch_cuda.py).
#ifndef DEQUANT_TERMS
#define DEQUANT_TERMS 3
#endif
constexpr int kTerms = DEQUANT_TERMS;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// W2 K=4: byte_q[v] holds the four q' of packed byte v (one group, plane 0
// in the low nibble) as bf16, element i at bytes 2i, 2i + 1; built once per
// block with the field decoder.
__device__ __forceinline__ void build_byte_qprime(uint2* byte_q,
                                                  const lut::PlaneScales& ps) {
  for (int v = threadIdx.x; v < 256; v += lut::kThreads) {
    const uint8_t byte = static_cast<uint8_t>(v);
    int q[lut::kMaxKGroup];
    lut::qprime_group(&byte, 0, 2, 4, ps, q);
    byte_q[v] = make_uint2(bf16_bits(q[0]) | bf16_bits(q[1]) << 16,
                           bf16_bits(q[2]) | bf16_bits(q[3]) << 16);
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
      dst[i] = static_cast<unsigned short>(bf16_bits(static_cast<float>(q[i])));
  }
}

// The stage's activation tile [rows, kt] f32 (rows packed) as kTerms bf16
// tiles [BM, ldb bytes] at As, four activations per work item. Each term is
// the remainder with its low 16 bits cleared (bf16 by truncation), and the
// remainder less the term is exact in f32: a has 24 significant bits, each
// term takes the next 8, so with kTerms = 3 the terms sum to a exactly (for
// |a| >= 2^-103). Bit masks and subtractions only, no conversions.
__device__ __forceinline__ void split_terms(const float* xs, int rows, int kt,
                                            uint8_t* As, int ldb, int bm) {
  const int qshift = __ffs(kt) - 3;  // kt / 4 work items a row (kt a power of 2)
  for (int p = threadIdx.x; p < rows << qshift; p += lut::kThreads) {
    const int r = p >> qshift, c = p & ((1 << qshift) - 1);
    const float4 v = reinterpret_cast<const float4*>(xs)[p];
    float rem[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      unsigned h[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        h[j] = __float_as_uint(rem[j]) & 0xffff0000u;
        rem[j] = __fsub_rn(rem[j], __uint_as_float(h[j]));
      }
      // the high halves, two bf16 to a word
      *reinterpret_cast<uint2*>(As + (t * bm + r) * ldb + c * 8) =
          make_uint2(__byte_perm(h[0], h[1], 0x7632), __byte_perm(h[2], h[3], 0x7632));
    }
  }
}

template <class C>
__global__ void __launch_bounds__(lut::kThreads, 2)
dequant_mma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ ws, float* __restrict__ out,
                   float* __restrict__ work, int* __restrict__ arrivals, int m,
                   int np, int gp, int k_group, int planes, int bg, int splits,
                   int stages, int pchunk, lut::PlaneScales ps) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN, z = blockIdx.z;
  const int steps = gp / bg, q = steps / splits, r = steps % splits;
  const int first = z * q + min(z, r), count = q + (z < r ? 1 : 0);
  const int kt = bg * k_group, ldb = 2 * kt + lut::kPad;
  const int pbs = bg * planes * k_group / 8;
  const long long kp = static_cast<long long>(gp) * k_group;
  const long long pb = static_cast<long long>(steps) * pbs;
  const int rows = min(C::BM, m - m0);
  const int a_bytes = min(C::BM, m) * kt * static_cast<int>(sizeof(float));
  const int stage_bytes = a_bytes + C::BN * pbs;
  const int bg_shift = __ffs(bg) - 1;
  const bool w2k4 = k_group == 4 && planes == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Bs = smem + stages * stage_bytes;
  uint8_t* As = Bs + C::BN * ldb;  // kTerms tiles [BM, ldb]
  uint2* byte_q = reinterpret_cast<uint2*>(As + kTerms * C::BM * ldb);
  // both are read after the loop's first barrier
  if (w2k4) build_byte_qprime(byte_q, ps);
  for (int t = 0; t < kTerms; ++t) {  // rows >= m stay zero
    int* tile = reinterpret_cast<int*>(As + t * C::BM * ldb);
    for (int i = rows * ldb / 4 + threadIdx.x; i < C::BM * ldb / 4; i += lut::kThreads)
      tile[i] = 0;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  // ldmatrix.x4 row addresses, as in lut_mma.cuh: 16 bytes are 8 bf16
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0f;

  // one K-step's stage: the activation tile [rows, kt], then the packed
  // tile [BN, pbs]
  auto load = [&](int slot, int step) {
    uint8_t* stage = smem + slot * stage_bytes;
    const int row_bytes = kt * static_cast<int>(sizeof(float));
    lut::copy_rows<16>(stage, row_bytes,
                       reinterpret_cast<const uint8_t*>(
                           x + m0 * kp + static_cast<long long>(step) * kt),
                       kp * static_cast<long long>(sizeof(float)), rows, row_bytes);
    uint8_t* dst = stage + a_bytes;
    const uint8_t* src = packed + n0 * pb + static_cast<long long>(step) * pbs;
    if (pchunk == 16)
      lut::copy_rows<16>(dst, pbs, src, pb, C::BN, pbs);
    else if (pchunk == 8)
      lut::copy_rows<8>(dst, pbs, src, pb, C::BN, pbs);
    else
      lut::copy_rows<4>(dst, pbs, src, pb, C::BN, pbs);
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < count) load(s, first + s);
    lut::cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    if (stages == 3)
      lut::cp_async_wait<1>();
    else
      lut::cp_async_wait<0>();
    __syncthreads();  // step i has landed; step i-1's reads are done
    const int next = i + stages - 1;
    if (next < count) load(next % stages, first + next);
    lut::cp_async_commit();
    const uint8_t* stage = smem + (i % stages) * stage_bytes;
    // the byte table's 8-byte words land as the CW decoder's do
    if (w2k4)
      lut::decode_cw_w2k4(stage + a_bytes, pbs, reinterpret_cast<int8_t*>(Bs), ldb,
                          C::BN, bg_shift, byte_q);
    else
      decode_qprime(stage + a_bytes, pbs, Bs, ldb, C::BN, bg, planes, k_group, ps);
    split_terms(reinterpret_cast<const float*>(stage), rows, kt, As, ldb, C::BM);
    __syncthreads();
#pragma unroll 2
    for (int kb = 0; kb < 2 * kt; kb += 32) {  // 16 weights a slice
      unsigned bf[C::NT][2];
#pragma unroll
      for (int nj = 0; nj < C::NT; nj += 2) {
        unsigned t[4];
        lut::ldmatrix_x4(t, Bs + (wn0 + nj * 8 + b_row) * ldb + kb + b_col);
        bf[nj][0] = t[0];
        bf[nj][1] = t[1];
        bf[nj + 1][0] = t[2];
        bf[nj + 1][1] = t[3];
      }
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        const uint8_t* At = As + t * C::BM * ldb;
        unsigned af[C::MT][4];
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi)
          lut::ldmatrix_x4(af[mi], At + (wm0 + mi * 16 + a_row) * ldb + kb + a_col);
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < C::NT; ++nj)
            mma_bf16(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
      }
    }
  }

  auto store = [&](int ml, int nl, float v0, float v1) {
    const int n = n0 + nl;
    *reinterpret_cast<float2*>(out + static_cast<long long>(m0 + ml) * np + n) =
        make_float2(__fmul_rn(v0, ws[n]), __fmul_rn(v1, ws[n + 1]));
  };
  if (splits == 1) {
    lut::for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
      if (m0 + ml < m) store(ml, nl, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
    });
    return;
  }
  // split-K: this block's partial tile into its slot of the workspace
  const auto slot = [&](int zz, int ml, int nl) {
    return reinterpret_cast<float2*>(
        work + (static_cast<long long>(zz) * m + m0 + ml) * np + n0 + nl);
  };
  lut::for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
    if (m0 + ml < m)
      *slot(z, ml, nl) = make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
  });
  __threadfence();  // this thread's partials are seen before the arrival below
  __syncthreads();
  __shared__ int last;
  int* arrival = arrivals + blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(arrival, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every split's partials have landed; add them in split
  // order, four outputs a work item. The loads of a batch of items carry no
  // branch (rows >= m read row m - 1, never stored), so they are all in
  // flight before the first add waits on one.
  constexpr int kQuads = C::BM * C::BN / 4 / lut::kThreads;
  constexpr int kBatch = kQuads < 8 ? kQuads : 8;
  const long long slot_words = static_cast<long long>(m) * np;
  const float* tile = work + static_cast<long long>(m0) * np + n0;
#pragma unroll 1
  for (int it0 = 0; it0 < kQuads; it0 += kBatch) {
    int off[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = threadIdx.x + (it0 + b) * lut::kThreads;
      off[b] = min(p / (C::BN / 4), m - 1 - m0) * np + p % (C::BN / 4) * 4;
    }
    float4 sum[kBatch];
#pragma unroll 1
    for (int zz = 0; zz < splits; ++zz) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        v[b] = __ldcg(reinterpret_cast<const float4*>(tile + zz * slot_words + off[b]));
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        sum[b] = zz == 0 ? v[b]
                         : make_float4(__fadd_rn(sum[b].x, v[b].x), __fadd_rn(sum[b].y, v[b].y),
                                       __fadd_rn(sum[b].z, v[b].z), __fadd_rn(sum[b].w, v[b].w));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = threadIdx.x + (it0 + b) * lut::kThreads;
      const int ml = p / (C::BN / 4), nl = p % (C::BN / 4) * 4;
      if (m0 + ml < m) {
        store(ml, nl, sum[b].x, sum[b].y);
        store(ml, nl + 2, sum[b].z, sum[b].w);
      }
    }
  }
  if (threadIdx.x == 0) *arrival = 0;
}

// The ring's stages and the dynamic shared memory of a launch: per stage
// the activation tile of x's rows (f32) and the packed tile, then the q'
// tile, the kTerms bf16 term tiles (rows padded by kPad bytes) and the
// W2 K=4 byte table.
template <class C>
lut::RingPlan ring_for(int m, int kt, int pbs) {
  const int ldb = 2 * kt + lut::kPad;
  return lut::ring_plan(
      static_cast<size_t>(std::min(C::BM, m)) * kt * sizeof(float) + C::BN * pbs,
      static_cast<size_t>(C::BN + kTerms * C::BM) * ldb + 256 * sizeof(uint2));
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
