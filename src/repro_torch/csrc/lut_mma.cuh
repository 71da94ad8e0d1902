// The int path of the LUT mpGEMMs (per_row INT8 tables, exact int32 sums)
// on the int8 tensor cores, shared by lut_mpgemm.cu and fused_lut_mpgemm.cu.
//
// One templated main loop serves both kernels. Per K-step (bg groups, kt =
// bg·E table entries) it streams the step's operands through a ring of
// cp.async copies, decodes the packed codes into a CW tile [BN, kt] in
// shared memory (the B operand), and contracts the A tile [BM, kt] against
// it with mma.sync m16n8k32 s8 x s8 -> s32, fragments loaded by ldmatrix
// from shared rows padded by kPad bytes. The A policy says where A comes
// from:
//  * TableA (staged): the INT8 table tile, copied from device memory into
//    the ring as it is;
//  * ActivationA (fused): the activation tile [rows, bg·K] f32 is copied
//    into the ring, and the block builds its own table tile from it in shared
//    memory, with the same entry and quantization code as table_precompute
//    (so the codes equal the staged table's bit for bit). Rows >= M are
//    zero and never computed.
// The caller picks the block's K-steps (split-K) and writes the epilogue.
#pragma once

#include <algorithm>
#include <cstdint>

#include "lut_common.cuh"

namespace lut {

// Block tile BM x BN of 8 warps, each owning WM x WN outputs as (WM/16) x
// (WN/8) m16n8 accumulator tiles. kernels/lut_mpgemm.py: INT_TILES carries
// the same (BM, BN) per config.
template <int BM_, int BN_, int WM_, int WN_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int MT = WM / 16, NT = WN / 8, WARPS_N = BN / WN;
  static_assert((BM / WM) * (BN / WN) * 32 == kThreads, "8 warps");
  static_assert(NT % 2 == 0, "B fragments load two n8 tiles at a time");
};
using MmaSmall = MmaTile<16, 128, 16, 16>;
using MmaMid = MmaTile<64, 64, 32, 16>;
using MmaLarge = MmaTile<128, 128, 64, 32>;

constexpr int kPad = 16;                 // bytes after each shared row
constexpr int kMaxStages = 3;
constexpr size_t kSmemLimit = 232448;    // a block's shared memory on sm_90

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)), "l"(src), "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of `row_bytes` bytes (global stride `src_ld`) into shared
// memory (stride `dst_ld`) in kBytes cp.async pieces. Where a row's pieces
// divide the block, each thread keeps one column and steps over rows.
template <int kBytes>
__device__ __forceinline__ void copy_rows(uint8_t* dst, int dst_ld,
                                          const uint8_t* src, long long src_ld,
                                          int rows, int row_bytes) {
  const int per_row = row_bytes / kBytes;
  if (kThreads % per_row == 0) {
    const int o = (threadIdx.x % per_row) * kBytes;
    for (int r = threadIdx.x / per_row; r < rows; r += kThreads / per_row)
      cp_async<kBytes>(dst + r * dst_ld + o, src + r * src_ld + o);
    return;
  }
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int r = c / per_row, o = (c % per_row) * kBytes;
    cp_async<kBytes>(dst + r * dst_ld + o, src + r * src_ld + o);
  }
}

// CW [BN, bg·E] int8 of one K-step into Bs (row stride ld), from the packed
// tile in shared memory (pbs bytes per channel; bg = 1 << bg_shift). Each
// plane puts ±ps_b at its entry idx_b; planes that pick the same entry add.
// Where E >= 4, four entries are built as one word with per-byte adds
// (__vadd4 wraps each byte, as the plain version's int8 cast does).
__device__ __forceinline__ void decode_cw(const uint8_t* Ps, int pbs,
                                          int8_t* Bs, int ld, int bn,
                                          int bg_shift, int planes,
                                          int k_group, const PlaneScales& ps) {
  const int e_count = 1 << (k_group - 1), bg = 1 << bg_shift;
  for (int p = threadIdx.x; p < bn * bg; p += kThreads) {
    const int nl = p >> bg_shift, gl = p & (bg - 1);
    const uint8_t* row = Ps + nl * pbs;
    int8_t* dst = Bs + nl * ld + gl * e_count;
    if (e_count < 4) {
      unpack_cw_group<int8_t>(row, gl, planes, k_group, ps, dst);
      continue;
    }
    unsigned idx[kMaxPlanes], coef[kMaxPlanes];
#pragma unroll
    for (int b = 0; b < kMaxPlanes; ++b) {
      idx[b] = 0;
      coef[b] = 0;
      if (b < planes) {
        const int field = read_field(row, gl, b, planes, k_group);
        idx[b] = field & (e_count - 1);
        coef[b] = static_cast<unsigned>(ps.v[b] * (1 - 2 * (field >> (k_group - 1))))
                  & 0xffu;
      }
    }
    for (int w = 0; w < e_count / 4; ++w) {
      unsigned v = 0;
#pragma unroll
      for (int b = 0; b < kMaxPlanes; ++b)
        if (b < planes && static_cast<int>(idx[b] >> 2) == w)
          v = __vadd4(v, coef[b] << (8 * (idx[b] & 3)));
      reinterpret_cast<unsigned*>(dst)[w] = v;
    }
  }
}

// W2 K=4, the serve path: a group's two 4-bit fields fill one packed byte
// (plane 0 low), and its 8 CW entries are one 8-byte word. byte_cw[v] holds
// that word for byte v, built once per block; a K-step's decode is then one
// table read per group, four groups per thread and 32-bit word of codes.
__device__ __forceinline__ void build_byte_cw(uint2* byte_cw,
                                              const PlaneScales& ps) {
  for (int v = threadIdx.x; v < 256; v += kThreads) {
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int field = (v >> (4 * b)) & 15, idx = field & 7;
      const unsigned entry =
          (static_cast<unsigned>(ps.v[b] * (1 - 2 * (field >> 3))) & 0xffu)
          << (8 * (idx & 3));
      if (idx < 4)
        lo = __vadd4(lo, entry);
      else
        hi = __vadd4(hi, entry);
    }
    byte_cw[v] = make_uint2(lo, hi);
  }
}

__device__ __forceinline__ void decode_cw_w2k4(const uint8_t* Ps, int pbs,
                                               int8_t* Bs, int ld, int bn,
                                               int bg_shift,
                                               const uint2* byte_cw) {
  const int wshift = bg_shift - 2;  // pbs = bg bytes: bg / 4 words a channel
  for (int w = threadIdx.x; w < bn << wshift; w += kThreads) {
    const int nl = w >> wshift, gw = w & ((1 << wshift) - 1);
    const unsigned codes = reinterpret_cast<const unsigned*>(Ps + nl * pbs)[gw];
    const uint2 c0 = byte_cw[codes & 255], c1 = byte_cw[(codes >> 8) & 255];
    const uint2 c2 = byte_cw[(codes >> 16) & 255], c3 = byte_cw[codes >> 24];
    uint4* dst = reinterpret_cast<uint4*>(Bs + nl * ld + gw * 32);
    dst[0] = make_uint4(c0.x, c0.y, c1.x, c1.y);
    dst[1] = make_uint4(c2.x, c2.y, c3.x, c3.y);
  }
}

// ------------------------------------------------------------ A policies

// The staged table tile [BM, kt] of table tv [Mp, G·E] (row length ge),
// copied into the ring as it is.
template <class C>
struct TableA {
  const int8_t* tv;
  long long ge;

  __device__ int stage_bytes(int ld) const { return C::BM * ld; }
  __device__ void init(int8_t*, int, int) const {}
  __device__ void load(uint8_t* dst, int m0, int step, int kt, int ld) const {
    copy_rows<16>(dst, ld,
                  reinterpret_cast<const uint8_t*>(tv) + m0 * ge +
                      static_cast<long long>(step) * kt,
                  ge, C::BM, kt);
  }
  __device__ const int8_t* tile(const uint8_t* stage, int8_t*, int, int) const {
    return reinterpret_cast<const int8_t*>(stage);
  }
};

// The table tile built from the activations x [m, kp] f32 with the per-row
// scales rs [m]: the ring holds the step's activation tile [min(BM, m),
// bg·K] (rows < m), and each K-step writes its INT8 codes into As [BM, ld].
template <class C>
struct ActivationA {
  const float* x;
  const float* rs;
  long long kp;
  int m, k_group, bg_shift;

  __device__ int rows(int m0) const { return min(C::BM, m - m0); }
  __device__ int stage_bytes(int) const {
    return min(C::BM, m) * (k_group << bg_shift) * static_cast<int>(sizeof(float));
  }
  // rows >= m stay zero: they add nothing to the real rows' sums
  __device__ void init(int8_t* As, int ld, int m0) const {
    const int first = rows(m0) * ld / 4, words = C::BM * ld / 4;
    for (int i = first + threadIdx.x; i < words; i += kThreads)
      reinterpret_cast<int*>(As)[i] = 0;
  }
  __device__ void load(uint8_t* dst, int m0, int step, int, int) const {
    const int kx = k_group << bg_shift;  // activations per row and K-step
    copy_rows<16>(dst, kx * static_cast<int>(sizeof(float)),
                  reinterpret_cast<const uint8_t*>(
                      x + m0 * kp + static_cast<long long>(step) * kx),
                  kp * static_cast<long long>(sizeof(float)), rows(m0),
                  kx * static_cast<int>(sizeof(float)));
  }
  // Entries e of (row, group), four per work item where E >= 4 (one 32-bit
  // store), else all E of the group: rint(T[e] / rs[row]) clipped to ±127.
  __device__ const int8_t* tile(const uint8_t* stage, int8_t* As, int m0,
                                int ld) const {
    const float* xs = reinterpret_cast<const float*>(stage);
    const int e_count = 1 << (k_group - 1), kx = k_group << bg_shift;
    const int chunk = e_count >= 4 ? 4 : e_count;
    const int c_shift = e_count >= 4 ? k_group - 3 : 0;  // log2(E / chunk)
    const int items = rows(m0) << (bg_shift + c_shift);
    for (int p = threadIdx.x; p < items; p += kThreads) {
      const int c = p & ((1 << c_shift) - 1), q = p >> c_shift;
      const int gl = q & ((1 << bg_shift) - 1), r = q >> bg_shift;
      float a[kMaxKGroup];
      load_group(xs + r * kx + gl * k_group, k_group, a);
      const float s = rs[m0 + r];
      int8_t* dst = As + r * ld + gl * e_count + c * chunk;
      if (chunk == 4) {
        unsigned v = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int code = static_cast<int>(
              quantize_entry(half_table_entry(a, k_group, c * 4 + j), s));
          v |= (static_cast<unsigned>(code) & 0xffu) << (8 * j);
        }
        *reinterpret_cast<unsigned*>(dst) = v;
      } else {
        for (int e = 0; e < chunk; ++e)
          dst[e] = static_cast<int8_t>(
              quantize_entry(half_table_entry(a, k_group, e), s));
      }
    }
    return As;
  }
};

// ------------------------------------------------------------ main loop

// Dynamic shared memory of the main loop: `stages` ring stages (A part +
// packed codes [BN, pbs]), the CW tile [BN, ld], the W2 K=4 byte table, and
// for ActivationA the built table tile [BM, ld].
struct RingPlan {
  int stages;
  size_t smem;
};

// 3 stages, or 2 where 3 do not fit; stages 0 where 2 do not fit either.
inline RingPlan ring_plan(size_t stage_bytes, size_t fixed_bytes) {
  int stages = kMaxStages;
  while (stages > 2 && stages * stage_bytes + fixed_bytes > kSmemLimit) --stages;
  const size_t smem = stages * stage_bytes + fixed_bytes;
  return {smem > kSmemLimit ? 0 : stages, smem};
}

// Widest cp.async piece (16, 8 or 4 bytes) that the packed stream's step
// (pbs bytes), row (pb bytes) and base address allow.
inline int packed_chunk(int pbs, long long pb, uintptr_t pk) {
  return (pbs % 16 == 0 && pb % 16 == 0 && pk % 16 == 0)  ? 16
         : (pbs % 8 == 0 && pb % 8 == 0 && pk % 8 == 0) ? 8
                                                         : 4;
}

// acc = Σ over the K-steps [first, first + count) of A x CW for the block's
// tile (rows m0.., channels n0..).
template <class C, class A>
__device__ __forceinline__ void int_mainloop(
    const A& a, const uint8_t* __restrict__ packed, int gp, int k_group,
    int planes, int bg, int first, int count, int stages, int pchunk,
    const PlaneScales& ps, int m0, int n0, int (&acc)[C::MT][C::NT][4]) {
  const int kt = bg << (k_group - 1), ld = kt + kPad;
  const int pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const int a_bytes = a.stage_bytes(ld);
  const int stage_bytes = a_bytes + C::BN * pbs;
  const int bg_shift = __ffs(bg) - 1;
  const bool w2k4 = k_group == 4 && planes == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + stages * stage_bytes);
  uint2* byte_cw = reinterpret_cast<uint2*>(Bs + C::BN * ld);
  int8_t* As = reinterpret_cast<int8_t*>(byte_cw + 256);  // ActivationA only
  // both are read after the loop's first barrier
  if (w2k4) build_byte_cw(byte_cw, ps);
  a.init(As, ld, m0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  // ldmatrix.x4 row addresses: A as (rows 0-7 | 8-15) x (bytes 0-15 | 16-31),
  // B as (bytes 0-15 | 16-31) x (channels 0-7 | 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

  // one K-step's stage: A part, then the packed tile [BN, pbs]
  auto load = [&](int slot, int step) {
    uint8_t* stage = smem + slot * stage_bytes;
    a.load(stage, m0, step, kt, ld);
    uint8_t* dst = stage + a_bytes;
    const uint8_t* src = packed + n0 * pb + static_cast<long long>(step) * pbs;
    if (pchunk == 16)
      copy_rows<16>(dst, pbs, src, pb, C::BN, pbs);
    else if (pchunk == 8)
      copy_rows<8>(dst, pbs, src, pb, C::BN, pbs);
    else
      copy_rows<4>(dst, pbs, src, pb, C::BN, pbs);
  };

  for (int s = 0; s < stages - 1; ++s) {
    if (s < count) load(s, first + s);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // step i has landed; step i-1's reads are done
    const int next = i + stages - 1;
    if (next < count) load(next % stages, first + next);
    cp_async_commit();
    const uint8_t* stage = smem + (i % stages) * stage_bytes;
    if (w2k4)
      decode_cw_w2k4(stage + a_bytes, pbs, Bs, ld, C::BN, bg_shift, byte_cw);
    else
      decode_cw(stage + a_bytes, pbs, Bs, ld, C::BN, bg_shift, planes,
                k_group, ps);
    const int8_t* At = a.tile(stage, As, m0, ld);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kt; kk += 32) {
      unsigned af[C::MT][4], bf[C::NT][2];
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
        ldmatrix_x4(af[mi], At + (wm0 + mi * 16 + a_row) * ld + kk + a_col);
#pragma unroll
      for (int nj = 0; nj < C::NT; nj += 2) {
        unsigned t[4];
        ldmatrix_x4(t, Bs + (wn0 + nj * 8 + b_row) * ld + kk + b_col);
        bf[nj][0] = t[0];
        bf[nj][1] = t[1];
        bf[nj + 1][0] = t[2];
        bf[nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < C::NT; ++nj)
          mma_s8(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
    }
  }
}

// Calls f(mi, nj, h, m, n) for each pair of this thread's accumulators,
// acc[mi][nj][2h] and acc[mi][nj][2h + 1], at tile row m and columns n,
// n + 1: c0, c1 at row lane/4, columns 2·(lane%4) + {0, 1}; c2, c3 eight
// rows below.
template <class C, class F>
__device__ __forceinline__ void for_each_pair(F&& f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nj = 0; nj < C::NT; ++nj)
        f(mi, nj, h, wm0 + mi * 16 + g + h * 8, wn0 + nj * 8 + t2);
}

// The expert axis of the batched mpGEMMs (the MoE FFN: E experts' products
// in one launch, as the reference's vmapped pallas_call computes them). The
// rows are E row blocks of cp rows, each padded to a multiple of the tile's
// BM, so no block straddles two experts; the packed codes are [E, Np, pb]
// and the weight scales [E, Np]. A block of rows m0.. belongs to expert
// m0 / cp and reads that expert's codes and scales; the grid, the split-K
// ranges and the arrival counts keep their 2-D shape over the E·cp rows.
// cp = 0: one weight for every row. Returns the block's expert.
__device__ __forceinline__ long long expert_of(int m0, int cp) {
  return cp == 0 ? 0 : m0 / cp;
}

// The launch-side check of the expert layout: cp = 0, or cp a multiple of
// the tile's rows that divides the rows.
inline bool valid_experts(int cp, int bm, int rows) {
  return cp == 0 || (cp > 0 && cp % bm == 0 && rows % cp == 0);
}

// The int path's epilogue of one output pair: (float(acc) · ts[m]) · ws[n].
__device__ __forceinline__ float2 int_epilogue(int v0, int v1, float tm,
                                               const float* __restrict__ ws,
                                               int n) {
  return make_float2(__fmul_rn(__fmul_rn(__int2float_rn(v0), tm), ws[n]),
                     __fmul_rn(__fmul_rn(__int2float_rn(v1), tm), ws[n + 1]));
}

}  // namespace lut
