// The bf16 tensor-core main loop of the f32 mpGEMMs, shared by
// dequant_mpgemm.cu (A: the activations; B: the reinterpreted weights q')
// and the float-table paths (None and per_group tables) of lut_mpgemm.cu
// and fused_lut_mpgemm.cu (A: the table, read or built; B: the CW entries).
//
// Exactness. B holds integers with |v| <= Σ|ps_b| <= 255
// (kernels/lut_mpgemm.py: plane_args), which bf16 holds exactly. Each f32
// value of A is split into kTerms bf16 terms by truncation (split_quad):
// each term is the remainder with its low 16 bits cleared, and the
// remainder less the term is exact in f32. A value has 24 significant
// bits and each term takes the next 8, so with three terms they sum to it
// exactly (for |v| >= 2^-103). Each term runs its own mma.sync m16n8k16
// bf16 x bf16 -> f32 into the same accumulator: every product is exact,
// only the tensor cores' f32 sums round.
//
// Per K-step (kt values of the contraction: weights for dequant_mpgemm,
// table entries for the LUT kernels) a ring of cp.async copies brings the
// step's A part (the A policy's: f32 rows, INT8 codes with their group
// scales, or activations) and packed codes. The block decodes B into a
// bf16 tile [BN, kt] (the B policy), writes the kTerms bf16 tiles of A
// [BM, kt] (rows >= M are zero rows, never loaded or written), and
// contracts them with ldmatrix fragments from rows padded by kPad bytes.
// Split-K (store_or_reduce): each block of a split writes its f32 partial
// tile to its slot of a workspace [S, M, Np]; the last block of a tile to
// arrive adds the S slots in split order and writes acc · ws[n]. No
// atomics touch the sums, so two calls on the same inputs give the same
// bits.
#pragma once

#include <cuda_bf16.h>

#include "lut_mma.cuh"

namespace lut {

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

// An integer as bf16 bits: the element type of a bf16 B tile, so the field
// decoder (unpack_cw_group) writes bf16 CW entries.
struct Bf16Int {
  unsigned short bits;
  __device__ explicit Bf16Int(int v) : bits(bf16_bits(static_cast<float>(v))) {}
};

// The kTerms bf16 terms of four f32 values (row r, values 4c .. 4c + 3 of
// its K-step) into the term tiles at As ([BM, ldb bytes] each, term t at
// t·BM rows): bit masks and subtractions, no conversions.
template <int kTerms>
__device__ __forceinline__ void split_quad(float (&rem)[4], uint8_t* As, int ldb,
                                           int bm, int r, int c) {
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

__host__ __device__ constexpr int rows_of(int bm, int m) { return m < bm ? m : bm; }

// ------------------------------------------------------------ A policies
// Each holds its operands and M, and gives the bytes of its part of a ring
// stage (a multiple of 16; also callable on the host for the launch's ring
// plan), the step's cp.async copies, and the split of the step's values.

// f32 rows [M, len] (dequant_mpgemm's activations, lut_mpgemm's None
// table): the step's tile [rows, kt] as it is.
template <class C>
struct F32Rows {
  const float* src;
  long long len;
  int m;

  static __host__ __device__ int stage_bytes(int m, int kt, int) {
    return rows_of(C::BM, m) * kt * static_cast<int>(sizeof(float));
  }
  __device__ int bytes(int kt) const { return stage_bytes(m, kt, 0); }
  __device__ void load(uint8_t* stage, int m0, int step, int kt) const {
    const int row_bytes = kt * static_cast<int>(sizeof(float));
    copy_rows<16>(stage, row_bytes,
                  reinterpret_cast<const uint8_t*>(
                      src + m0 * len + static_cast<long long>(step) * kt),
                  len * static_cast<long long>(sizeof(float)),
                  rows_of(C::BM, m - m0), row_bytes);
  }
  template <int kTerms>
  __device__ void split(const uint8_t* stage, uint8_t* As, int ldb, int m0,
                        int kt) const {
    const int qshift = __ffs(kt) - 3;  // kt / 4 work items a row
    for (int p = threadIdx.x; p < rows_of(C::BM, m - m0) << qshift; p += kThreads) {
      const float4 v = reinterpret_cast<const float4*>(stage)[p];
      float rem[4] = {v.x, v.y, v.z, v.w};
      split_quad<kTerms>(rem, As, ldb, C::BM, p >> qshift, p & ((1 << qshift) - 1));
    }
  }
};

// lut_mpgemm's per_group table: INT8 codes [M, G·E] and scales [M, G];
// each value is float(code) · scale, one IEEE product, as the plain
// version dequantizes. The stage holds the codes [rows, kt], then the
// scales [rows, bg].
template <class C>
struct ScaledCodes {
  const int8_t* codes;
  const float* scales;
  int gp, m, k_group;

  static __host__ __device__ int scale_bytes(int m, int kt, int k_group) {
    const int bytes = rows_of(C::BM, m) * (kt >> (k_group - 1)) *
                      static_cast<int>(sizeof(float));
    return (bytes + 15) & ~15;
  }
  static __host__ __device__ int stage_bytes(int m, int kt, int k_group) {
    return rows_of(C::BM, m) * kt + scale_bytes(m, kt, k_group);
  }
  __device__ int bytes(int kt) const { return stage_bytes(m, kt, k_group); }
  __device__ void load(uint8_t* stage, int m0, int step, int kt) const {
    const int rows = rows_of(C::BM, m - m0), bg = kt >> (k_group - 1);
    const long long ge = static_cast<long long>(gp) << (k_group - 1);
    copy_rows<16>(stage, kt,
                  reinterpret_cast<const uint8_t*>(codes) + m0 * ge +
                      static_cast<long long>(step) * kt,
                  ge, rows, kt);
    copy_rows<4>(stage + rows_of(C::BM, m) * kt, bg * static_cast<int>(sizeof(float)),
                 reinterpret_cast<const uint8_t*>(
                     scales + static_cast<long long>(m0) * gp +
                     static_cast<long long>(step) * bg),
                 static_cast<long long>(gp) * sizeof(float), rows,
                 bg * static_cast<int>(sizeof(float)));
  }
  template <int kTerms>
  __device__ void split(const uint8_t* stage, uint8_t* As, int ldb, int m0,
                        int kt) const {
    const int qshift = __ffs(kt) - 3, bg = kt >> (k_group - 1);
    const float* ss = reinterpret_cast<const float*>(stage + rows_of(C::BM, m) * kt);
    for (int p = threadIdx.x; p < rows_of(C::BM, m - m0) << qshift; p += kThreads) {
      const int r = p >> qshift, c = p & ((1 << qshift) - 1);
      const char4 q = reinterpret_cast<const char4*>(stage)[p];
      const int code[4] = {q.x, q.y, q.z, q.w};
      // E >= 4: one group's scale for the four entries
      const float s0 = ss[r * bg + ((4 * c) >> (k_group - 1))];
      float rem[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rem[j] = __fmul_rn(static_cast<float>(code[j]),
                           k_group >= 3 ? s0
                                        : ss[r * bg + ((4 * c + j) >> (k_group - 1))]);
      split_quad<kTerms>(rem, As, ldb, C::BM, r, c);
    }
  }
};

// fused_lut_mpgemm's table, built from the activations x [M, G·K]: the
// stage holds the step's activation tile [rows, bg·K], and each entry is
// half_table_entry of its group, as table_precompute builds it; per_group
// (kPerGroup) then quantize_entry(entry, s) · s with the group's scale s,
// so the values equal the staged per_group table's.
template <class C, bool kPerGroup>
struct BuiltTable {
  const float* x;
  long long kp;
  int m, k_group;

  static __host__ __device__ int stage_bytes(int m, int kt, int k_group) {
    return rows_of(C::BM, m) * (kt >> (k_group - 1)) * k_group *
           static_cast<int>(sizeof(float));
  }
  __device__ int bytes(int kt) const { return stage_bytes(m, kt, k_group); }
  __device__ void load(uint8_t* stage, int m0, int step, int kt) const {
    const int kx = (kt >> (k_group - 1)) * k_group;  // activations a row
    copy_rows<16>(stage, kx * static_cast<int>(sizeof(float)),
                  reinterpret_cast<const uint8_t*>(
                      x + m0 * kp + static_cast<long long>(step) * kx),
                  kp * static_cast<long long>(sizeof(float)),
                  rows_of(C::BM, m - m0), kx * static_cast<int>(sizeof(float)));
  }
  // the group's per_group scale (unused for a float table)
  __device__ float scale(const float (&a)[kMaxKGroup], int k) const {
    return kPerGroup ? per_group_scale(group_abs_sum(a, k)) : 0.0f;
  }
  __device__ float entry(const float (&a)[kMaxKGroup], float s, int k, int e) const {
    const float t = half_table_entry(a, k, e);
    return kPerGroup ? __fmul_rn(quantize_entry(t, s), s) : t;
  }
  template <int kTerms>
  __device__ void split(const uint8_t* stage, uint8_t* As, int ldb, int m0,
                        int kt) const {
    const int qshift = __ffs(kt) - 3, e_shift = k_group - 1;
    const int kx = (kt >> e_shift) * k_group, rows = rows_of(C::BM, m - m0);
    const float* xs = reinterpret_cast<const float*>(stage);
    if (k_group == 4) {
      // the serve path, a group a work item: one float4 of x, its scale
      // once, its 8 entries as two quads; the same entry and scale code
      // with K a constant, which the compiler folds
      const int gshift = qshift - 1;  // kt / 8 groups a row
      for (int p = threadIdx.x; p < rows << gshift; p += kThreads) {
        const int r = p >> gshift, gl = p & ((1 << gshift) - 1);
        const float4 v = reinterpret_cast<const float4*>(xs + r * kx)[gl];
        const float a[kMaxKGroup] = {v.x, v.y, v.z, v.w};
        const float s = scale(a, 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float rem[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) rem[j] = entry(a, s, 4, 4 * h + j);
          split_quad<kTerms>(rem, As, ldb, C::BM, r, 2 * gl + h);
        }
      }
      return;
    }
    // any other K: a quad a work item, each entry from its own group
    for (int p = threadIdx.x; p < rows << qshift; p += kThreads) {
      const int r = p >> qshift, c = p & ((1 << qshift) - 1);
      float rem[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a[kMaxKGroup];
        load_group(xs + r * kx + ((4 * c + j) >> e_shift) * k_group, k_group, a);
        rem[j] = entry(a, scale(a, k_group), k_group,
                       (4 * c + j) & ((1 << e_shift) - 1));
      }
      split_quad<kTerms>(rem, As, ldb, C::BM, r, c);
    }
  }
};

// ------------------------------------------------------------ B: CW

// W2 K=4: table[v] holds the 8 CW entries of packed byte v (one group,
// plane 0 in the low nibble) as bf16, entry e at bytes 2e, 2e + 1; built
// once per block.
__device__ __forceinline__ void build_byte_cw_bf16(uint4* table,
                                                   const PlaneScales& ps) {
  for (int v = threadIdx.x; v < 256; v += kThreads) {
    const uint8_t byte = static_cast<uint8_t>(v);
    Bf16Int cw[8] = {Bf16Int(0), Bf16Int(0), Bf16Int(0), Bf16Int(0),
                     Bf16Int(0), Bf16Int(0), Bf16Int(0), Bf16Int(0)};
    unpack_cw_group<Bf16Int>(&byte, 0, 2, 4, ps, cw);
    table[v] = make_uint4(cw[0].bits | cw[1].bits << 16, cw[2].bits | cw[3].bits << 16,
                          cw[4].bits | cw[5].bits << 16, cw[6].bits | cw[7].bits << 16);
  }
}

// The LUT kernels' B: the CW tile [bn, bg·E] bf16 (row stride ldb bytes)
// of one K-step from the packed tile in shared memory (pbs bytes a
// channel). W2 K=4 reads the byte table (a 32-bit word of codes is four
// groups, 64 bytes of CW); other (planes, k_group) run the field decoder,
// one (channel, group) a work item.
struct CwB {
  int planes, k_group;
  PlaneScales ps;

  static constexpr int kTableBytes = 256 * sizeof(uint4);
  __device__ bool w2k4() const { return k_group == 4 && planes == 2; }
  __device__ void init(uint8_t* table) const {
    if (w2k4()) build_byte_cw_bf16(reinterpret_cast<uint4*>(table), ps);
  }
  __device__ void decode(const uint8_t* Ps, int pbs, uint8_t* Bs, int ldb, int bn,
                         int bg_shift, const uint8_t* table) const {
    if (w2k4()) {
      const uint4* byte_cw = reinterpret_cast<const uint4*>(table);
      const int wshift = bg_shift - 2;  // pbs = bg bytes: bg / 4 words a channel
      for (int w = threadIdx.x; w < bn << wshift; w += kThreads) {
        const int nl = w >> wshift, gw = w & ((1 << wshift) - 1);
        const unsigned codes = reinterpret_cast<const unsigned*>(Ps + nl * pbs)[gw];
        uint4* dst = reinterpret_cast<uint4*>(Bs + nl * ldb + gw * 64);
#pragma unroll
        for (int j = 0; j < 4; ++j) dst[j] = byte_cw[(codes >> (8 * j)) & 255];
      }
      return;
    }
    const int e_count = 1 << (k_group - 1), bg = 1 << bg_shift;
    for (int p = threadIdx.x; p < bn << bg_shift; p += kThreads) {
      const int nl = p >> bg_shift, gl = p & (bg - 1);
      unpack_cw_group<Bf16Int>(Ps + nl * pbs, gl, planes, k_group, ps,
                               reinterpret_cast<Bf16Int*>(Bs + nl * ldb) + gl * e_count);
    }
  }
};

// ------------------------------------------------------------ main loop

// The ring plan of a launch: per stage the A part and the packed tile
// [BN, pbs]; then the B tile [BN, ldb], the kTerms A term tiles [BM, ldb]
// and B's byte table.
template <class C>
inline RingPlan bf16_ring(int a_stage_bytes, int kt, int pbs, int terms,
                          int table_bytes) {
  const int ldb = 2 * kt + kPad;
  return ring_plan(static_cast<size_t>(a_stage_bytes) + C::BN * pbs,
                   static_cast<size_t>(C::BN + terms * C::BM) * ldb + table_bytes);
}

// acc = Σ over the K-steps [first, first + count) of A x B for the block's
// tile (rows m0.., channels n0..); bg groups of packed codes a step.
template <class C, int kTerms, class A, class B>
__device__ __forceinline__ void bf16_mainloop(
    const A& a, const B& b, const uint8_t* __restrict__ packed, int kt, int pbs,
    long long pb, int m, int bg, int first, int count, int stages, int pchunk,
    int m0, int n0, float (&acc)[C::MT][C::NT][4]) {
  const int ldb = 2 * kt + kPad;
  const int rows = rows_of(C::BM, m - m0);
  const int a_bytes = a.bytes(kt);
  const int stage_bytes = a_bytes + C::BN * pbs;
  const int bg_shift = __ffs(bg) - 1;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Bs = smem + stages * stage_bytes;
  uint8_t* As = Bs + C::BN * ldb;  // kTerms tiles [BM, ldb]
  uint8_t* table = As + kTerms * C::BM * ldb;
  // both are read after the loop's first barrier
  b.init(table);
  for (int t = 0; t < kTerms; ++t) {  // rows >= m stay zero
    int* tile = reinterpret_cast<int*>(As + t * C::BM * ldb);
    for (int i = rows * ldb / 4 + threadIdx.x; i < C::BM * ldb / 4; i += kThreads)
      tile[i] = 0;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  // ldmatrix.x4 row addresses, as in lut_mma.cuh: 16 bytes are 8 bf16
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0f;

  // one K-step's stage: the A part, then the packed tile [BN, pbs]
  auto load = [&](int slot, int step) {
    uint8_t* stage = smem + slot * stage_bytes;
    a.load(stage, m0, step, kt);
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
    b.decode(stage + a_bytes, pbs, Bs, ldb, C::BN, bg_shift, table);
    a.template split<kTerms>(stage, As, ldb, m0, kt);
    __syncthreads();
#pragma unroll 2
    for (int kb = 0; kb < 2 * kt; kb += 32) {  // 16 values a slice
      unsigned bf[C::NT][2];
#pragma unroll
      for (int nj = 0; nj < C::NT; nj += 2) {
        unsigned t[4];
        ldmatrix_x4(t, Bs + (wn0 + nj * 8 + b_row) * ldb + kb + b_col);
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
          ldmatrix_x4(af[mi], At + (wm0 + mi * 16 + a_row) * ldb + kb + a_col);
#pragma unroll
        for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
          for (int nj = 0; nj < C::NT; ++nj)
            mma_bf16(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
      }
    }
  }
}

// The epilogue: out = acc · ws[n] for rows < m. With S > 1 splits, this
// block's partial tile goes to its slot z of the workspace [S, m, np] and
// the last block of the tile to arrive adds the S slots in split order,
// writes the outputs and resets the tile's arrival count.
template <class C>
__device__ __forceinline__ void store_or_reduce(
    const float (&acc)[C::MT][C::NT][4], const float* __restrict__ ws,
    float* __restrict__ out, float* __restrict__ work, int* __restrict__ arrivals,
    int m, int np, int m0, int n0, int z, int splits) {
  auto store = [&](int ml, int nl, float v0, float v1) {
    const int n = n0 + nl;
    *reinterpret_cast<float2*>(out + static_cast<long long>(m0 + ml) * np + n) =
        make_float2(__fmul_rn(v0, ws[n]), __fmul_rn(v1, ws[n + 1]));
  };
  if (splits == 1) {
    for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
      if (m0 + ml < m) store(ml, nl, acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
    });
    return;
  }
  // split-K: this block's partial tile into its slot of the workspace
  const auto slot = [&](int zz, int ml, int nl) {
    return reinterpret_cast<float2*>(
        work + (static_cast<long long>(zz) * m + m0 + ml) * np + n0 + nl);
  };
  for_each_pair<C>([&](int mi, int nj, int h, int ml, int nl) {
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
  constexpr int kQuads = C::BM * C::BN / 4 / kThreads;
  constexpr int kBatch = kQuads < 8 ? kQuads : 8;
  const long long slot_words = static_cast<long long>(m) * np;
  const float* tile = work + static_cast<long long>(m0) * np + n0;
#pragma unroll 1
  for (int it0 = 0; it0 < kQuads; it0 += kBatch) {
    int off[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int p = threadIdx.x + (it0 + b) * kThreads;
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
      const int p = threadIdx.x + (it0 + b) * kThreads;
      const int ml = p / (C::BN / 4), nl = p % (C::BN / 4) * 4;
      if (m0 + ml < m) {
        store(ml, nl, sum[b].x, sum[b].y);
        store(ml, nl + 2, sum[b].z, sum[b].w);
      }
    }
  }
  if (threadIdx.x == 0) *arrival = 0;
}

// f(C{}) for the tile of a launch's config: MmaSmall (0), MmaMid (1),
// MmaLarge (2); `refused` for any other.
template <class R, class F>
inline R with_tile(int config, R refused, F&& f) {
  switch (config) {
    case 0: return f(MmaSmall{});
    case 1: return f(MmaMid{});
    case 2: return f(MmaLarge{});
    default: return refused;
  }
}

// One block of a bf16 kernel: its split z's K-range of the Gp/bg K-steps
// (the first steps % S ranges one step longer, kernels/lut_mpgemm.py:
// k_ranges), the main loop, the epilogue. With cp > 0 the rows are E
// experts' row blocks of cp rows each (cp a multiple of BM): the block's
// expert is e = m0 / cp, whose packed codes [Np, pb] and weight scales
// [Np] follow expert e - 1's (lut_mma.cuh: expert_of).
template <class C, int kTerms, class A, class B>
__device__ __forceinline__ void bf16_block(
    const A& a, const B& b, const uint8_t* __restrict__ packed,
    const float* __restrict__ ws, float* __restrict__ out, float* __restrict__ work,
    int* __restrict__ arrivals, int m, int np, int gp, int bg, int kt, int pbs,
    int splits, int stages, int pchunk, int cp = 0) {
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN, z = blockIdx.z;
  const int steps = gp / bg, q = steps / splits, r = steps % splits;
  const int first = z * q + min(z, r), count = q + (z < r ? 1 : 0);
  const long long pb = static_cast<long long>(steps) * pbs, e = expert_of(m0, cp);
  float acc[C::MT][C::NT][4];
  bf16_mainloop<C, kTerms>(a, b, packed + e * np * pb, kt, pbs, pb, m, bg, first,
                           count, stages, pchunk, m0, n0, acc);
  store_or_reduce<C>(acc, ws + e * np, out, work, arrivals, m, np, m0, n0, z, splits);
}

}  // namespace lut
