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
// The int path (per_row tables: exact int32 sums; the serve path) now:
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
// version's. The f32 path (None and per_group tables) runs IEEE fp32 FMA
// from shared memory, one block per 8 x 32 or 64 x 64 tile walking all of K.
#include <algorithm>

#include "lut_common.cuh"

namespace {

// ---------------------------------------------------------------- int path

// Block tile BM x BN of 8 warps, each owning WM x WN outputs as (WM/16) x
// (WN/8) m16n8 accumulator tiles. kernels/lut_mpgemm.py: INT_TILES carries
// the same (BM, BN) per config.
template <int BM_, int BN_, int WM_, int WN_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int MT = WM / 16, NT = WN / 8, WARPS_N = BN / WN;
  static_assert((BM / WM) * (BN / WN) * 32 == lut::kThreads, "8 warps");
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
  if (lut::kThreads % per_row == 0) {
    const int o = (threadIdx.x % per_row) * kBytes;
    for (int r = threadIdx.x / per_row; r < rows; r += lut::kThreads / per_row)
      cp_async<kBytes>(dst + r * dst_ld + o, src + r * src_ld + o);
    return;
  }
  for (int c = threadIdx.x; c < rows * per_row; c += lut::kThreads) {
    const int r = c / per_row, o = (c % per_row) * kBytes;
    cp_async<kBytes>(dst + r * dst_ld + o, src + r * src_ld + o);
  }
}

// One K-step's stage: the table tile [BM, kt] (row stride ld) and the packed
// tile [BN, pbs] (packed bytes of the step's bg groups per channel).
template <class C>
__device__ __forceinline__ void load_stage(uint8_t* stage, const int8_t* tv,
                                           const uint8_t* packed, long long ge,
                                           long long pb, int m0, int n0,
                                           int step, int kt, int ld, int pbs,
                                           int pchunk) {
  copy_rows<16>(stage, ld,
                reinterpret_cast<const uint8_t*>(tv) + m0 * ge +
                    static_cast<long long>(step) * kt,
                ge, C::BM, kt);
  uint8_t* dst = stage + C::BM * ld;
  const uint8_t* src = packed + n0 * pb + static_cast<long long>(step) * pbs;
  if (pchunk == 16)
    copy_rows<16>(dst, pbs, src, pb, C::BN, pbs);
  else if (pchunk == 8)
    copy_rows<8>(dst, pbs, src, pb, C::BN, pbs);
  else
    copy_rows<4>(dst, pbs, src, pb, C::BN, pbs);
}

// CW [BN, bg·E] int8 of one K-step into Bs (row stride ld), from the packed
// tile in shared memory (pbs bytes per channel; bg = 1 << bg_shift). Each
// plane puts ±ps_b at its entry idx_b; planes that pick the same entry add.
// Where E >= 4, four entries are built as one word with per-byte adds
// (__vadd4 wraps each byte, as the plain version's int8 cast does).
__device__ __forceinline__ void decode_cw(const uint8_t* Ps, int pbs,
                                          int8_t* Bs, int ld, int bn,
                                          int bg_shift, int planes,
                                          int k_group,
                                          const lut::PlaneScales& ps) {
  const int e_count = 1 << (k_group - 1), bg = 1 << bg_shift;
  for (int p = threadIdx.x; p < bn * bg; p += lut::kThreads) {
    const int nl = p >> bg_shift, gl = p & (bg - 1);
    const uint8_t* row = Ps + nl * pbs;
    int8_t* dst = Bs + nl * ld + gl * e_count;
    if (e_count < 4) {
      lut::unpack_cw_group<int8_t>(row, gl, planes, k_group, ps, dst);
      continue;
    }
    unsigned idx[lut::kMaxPlanes], coef[lut::kMaxPlanes];
#pragma unroll
    for (int b = 0; b < lut::kMaxPlanes; ++b) {
      idx[b] = 0;
      coef[b] = 0;
      if (b < planes) {
        const int field = lut::read_field(row, gl, b, planes, k_group);
        idx[b] = field & (e_count - 1);
        coef[b] = static_cast<unsigned>(ps.v[b] * (1 - 2 * (field >> (k_group - 1))))
                  & 0xffu;
      }
    }
    for (int w = 0; w < e_count / 4; ++w) {
      unsigned v = 0;
#pragma unroll
      for (int b = 0; b < lut::kMaxPlanes; ++b)
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
                                              const lut::PlaneScales& ps) {
  for (int v = threadIdx.x; v < 256; v += lut::kThreads) {
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
  for (int w = threadIdx.x; w < bn << wshift; w += lut::kThreads) {
    const int nl = w >> wshift, gw = w & ((1 << wshift) - 1);
    const unsigned codes = reinterpret_cast<const unsigned*>(Ps + nl * pbs)[gw];
    const uint2 c0 = byte_cw[codes & 255], c1 = byte_cw[(codes >> 8) & 255];
    const uint2 c2 = byte_cw[(codes >> 16) & 255], c3 = byte_cw[codes >> 24];
    uint4* dst = reinterpret_cast<uint4*>(Bs + nl * ld + gw * 32);
    dst[0] = make_uint4(c0.x, c0.y, c1.x, c1.y);
    dst[1] = make_uint4(c2.x, c2.y, c3.x, c3.y);
  }
}

// acc = Σ over this block's K-steps [first, first + count) of table x CW.
// With `part` null (one split) the block writes the epilogue itself; else
// it writes its int32 partial sums to part[blockIdx.z].
template <class C>
__global__ void __launch_bounds__(lut::kThreads, 2)
lut_mma_kernel(const int8_t* __restrict__ tv, const float* __restrict__ ts,
               const uint8_t* __restrict__ packed, const float* __restrict__ ws,
               float* __restrict__ out, int* __restrict__ part, int mp, int np,
               int gp, int k_group, int planes, int bg, int splits, int stages,
               int pchunk, lut::PlaneScales ps) {
  const int kt = bg << (k_group - 1), ld = kt + kPad;
  const int pbs = bg * planes * k_group / 8;
  const long long ge = static_cast<long long>(gp) << (k_group - 1);
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const int stage_bytes = C::BM * ld + C::BN * pbs;
  const int bg_shift = __ffs(bg) - 1;
  const bool w2k4 = k_group == 4 && planes == 2;
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* Bs = reinterpret_cast<int8_t*>(smem + stages * stage_bytes);
  uint2* byte_cw = reinterpret_cast<uint2*>(Bs + C::BN * ld);
  if (w2k4) build_byte_cw(byte_cw, ps);  // read after the loop's first barrier

  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN, z = blockIdx.z;
  const int steps = gp / bg, q = steps / splits, r = steps % splits;
  const int first = z * q + min(z, r), count = q + (z < r ? 1 : 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / C::WARPS_N) * C::WM, wn0 = (warp % C::WARPS_N) * C::WN;
  // ldmatrix.x4 row addresses: A as (rows 0-7 | 8-15) x (bytes 0-15 | 16-31),
  // B as (bytes 0-15 | 16-31) x (channels 0-7 | 8-15)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < count)
      load_stage<C>(smem + s * stage_bytes, tv, packed, ge, pb, m0, n0,
                    first + s, kt, ld, pbs, pchunk);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // step i has landed; step i-1's reads are done
    const int next = i + stages - 1;
    if (next < count)
      load_stage<C>(smem + (next % stages) * stage_bytes, tv, packed, ge, pb,
                    m0, n0, first + next, kt, ld, pbs, pchunk);
    cp_async_commit();
    const uint8_t* stage = smem + (i % stages) * stage_bytes;
    if (w2k4)
      decode_cw_w2k4(stage + C::BM * ld, pbs, Bs, ld, C::BN, bg_shift, byte_cw);
    else
      decode_cw(stage + C::BM * ld, pbs, Bs, ld, C::BN, bg_shift, planes,
                k_group, ps);
    __syncthreads();
    const int8_t* As = reinterpret_cast<const int8_t*>(stage);
#pragma unroll 4
    for (int kk = 0; kk < kt; kk += 32) {
      unsigned a[C::MT][4], b[C::NT][2];
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
        ldmatrix_x4(a[mi], As + (wm0 + mi * 16 + a_row) * ld + kk + a_col);
#pragma unroll
      for (int nj = 0; nj < C::NT; nj += 2) {
        unsigned t[4];
        ldmatrix_x4(t, Bs + (wn0 + nj * 8 + b_row) * ld + kk + b_col);
        b[nj][0] = t[0];
        b[nj][1] = t[1];
        b[nj + 1][0] = t[2];
        b[nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
        for (int nj = 0; nj < C::NT; ++nj) mma_s8(acc[mi][nj], a[mi], b[nj][0], b[nj][1]);
    }
  }

  // accumulator tile (mi, nj): c0, c1 at row lane/4, columns 2·(lane%4) + {0, 1};
  // c2, c3 eight rows below
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < C::MT; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + mi * 16 + g + h * 8;
#pragma unroll
      for (int nj = 0; nj < C::NT; ++nj) {
        const int n = n0 + wn0 + nj * 8 + t2;
        const int v0 = acc[mi][nj][2 * h], v1 = acc[mi][nj][2 * h + 1];
        if (part != nullptr) {
          *reinterpret_cast<int2*>(part + (static_cast<long long>(z) * mp + m) * np + n) =
              make_int2(v0, v1);
        } else {
          const float tm = ts[m];
          *reinterpret_cast<float2*>(out + static_cast<long long>(m) * np + n) =
              make_float2(__fmul_rn(__fmul_rn(__int2float_rn(v0), tm), ws[n]),
                          __fmul_rn(__fmul_rn(__int2float_rn(v1), tm), ws[n + 1]));
        }
      }
    }
}

// out = (float(Σ_z part[z]) · ts[m]) · ws[n], four outputs per thread.
__global__ void __launch_bounds__(lut::kThreads)
splitk_epilogue_kernel(const int* __restrict__ part, const float* __restrict__ ts,
                       const float* __restrict__ ws, float* __restrict__ out,
                       int mp, int np, int splits) {
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
    const int m = static_cast<int>(4 * i / np), n = static_cast<int>(4 * i % np);
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
               const lut::PlaneScales& ps, cudaStream_t stream) {
  const int kt = bg << (k_group - 1), ld = kt + kPad;
  const int pbs = bg * planes * k_group / 8;
  const long long pb = static_cast<long long>(gp / bg) * pbs;
  const uintptr_t pk = reinterpret_cast<uintptr_t>(packed);
  if (mp % C::BM || np % C::BN || kt % 32 || pbs % 4 || (bg & (bg - 1)) ||
      splits < 1 ||
      splits > gp / bg || (splits > 1) != (part != nullptr) ||
      reinterpret_cast<uintptr_t>(tv) % 16 || pk % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pchunk = (pbs % 16 == 0 && pb % 16 == 0 && pk % 16 == 0)  ? 16
                     : (pbs % 8 == 0 && pb % 8 == 0 && pk % 8 == 0) ? 8
                                                                     : 4;
  const size_t stage_bytes = static_cast<size_t>(C::BM) * ld + C::BN * pbs;
  const size_t cw_bytes = static_cast<size_t>(C::BN) * ld + 256 * sizeof(uint2);
  int stages = kMaxStages;
  while (stages > 2 && stages * stage_bytes + cw_bytes > kSmemLimit) --stages;
  const size_t smem = stages * stage_bytes + cw_bytes;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = lut_mma_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM, splits);
  kernel<<<grid, lut::kThreads, smem, stream>>>(tv, ts, packed, ws, out, part,
                                                mp, np, gp, k_group, planes,
                                                bg, splits, stages, pchunk, ps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long quads = static_cast<long long>(mp) * np / 4;
  const int blocks = static_cast<int>(
      std::min<long long>((quads + lut::kThreads - 1) / lut::kThreads, 132 * 8));
  splitk_epilogue_kernel<<<blocks, lut::kThreads, 0, stream>>>(part, ts, ws, out,
                                                               mp, np, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- f32 path

template <class C>
__global__ void __launch_bounds__(lut::kThreads)
lut_f32_kernel(const void* __restrict__ tv, const float* __restrict__ ts,
               const uint8_t* __restrict__ packed, const float* __restrict__ ws,
               float* __restrict__ out, int n_total, int gp, int k_group,
               int planes, int bg, int mode, lut::PlaneScales ps) {
  const int e_count = 1 << (k_group - 1);
  const int kt = bg * e_count;
  const int ld = lut::tile_ld<float>(kt);
  const long long ge = static_cast<long long>(gp) * e_count;   // table row
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
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0;

  for (int g0 = 0; g0 < gp; g0 += bg) {
    const long long col0 = static_cast<long long>(g0) * e_count;
    for (int p = threadIdx.x; p < C::BM * kt; p += lut::kThreads) {
      const int r = p / kt, k = p % kt;
      const long long at = (m0 + r) * ge + col0 + k;
      As[r * ld + k] =
          mode == lut::kPerGroup
              ? __fmul_rn(static_cast<float>(static_cast<const int8_t*>(tv)[at]),
                          ts[static_cast<long long>(m0 + r) * gp + g0 + k / e_count])
              : static_cast<const float*>(tv)[at];
    }
    lut::unpack_cw_tile<float, C>(packed, pb, n0, g0, bg, planes, k_group, ps, Bs);
    __syncthreads();
    lut::contract_f32<C>(As, Bs, kt, ty, tx, acc);
    __syncthreads();
  }
  lut::store_f32<C>(acc, ws, out, n_total, m0, n0, ty, tx);
}

template <class C>
int launch_f32(const void* tv, const float* ts, const uint8_t* packed,
               const float* ws, float* out, int mp, int np, int gp, int k_group,
               int planes, int bg, int mode, const lut::PlaneScales& ps,
               cudaStream_t stream) {
  if (mp % C::BM || np % C::BN) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lut::tile_smem_bytes<float, C>(bg << (k_group - 1));
  auto kernel = lut_f32_kernel<C>;
  cudaError_t err = lut::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(np / C::BN, mp / C::BM);
  kernel<<<grid, lut::kThreads, smem, stream>>>(tv, ts, packed, ws, out, np, gp,
                                                k_group, planes, bg, mode, ps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 f32 table, 1 int8 table + per-row scale ts [mp], 2 int8 table +
// per-group scale ts [mp, gp]. config: the tile; for mode 1 MmaSmall (0),
// MmaMid (1), MmaLarge (2), with `splits` K-ranges and, when splits > 1, an
// int32 workspace [splits, mp, np]; for modes 0 and 2 SmallTile (0) or
// LargeTile (1), splits 1 and no workspace. bg: groups per K-step
// (gp % bg == 0). plane_scales: host array of `planes` ints.
extern "C" int lut_mpgemm_launch(const void* tv, const float* ts,
                                 const uint8_t* packed, const float* ws,
                                 float* out, int* workspace, int mp, int np,
                                 int gp, int k_group, int planes,
                                 const int* plane_scales, int mode, int config,
                                 int bg, int splits, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || planes < 1 || planes > lut::kMaxPlanes ||
      bg < 1 || gp % bg || ((bg << (k_group - 1)) % 4) ||
      (bg * planes * k_group) % 8 || mode < lut::kFloat || mode > lut::kPerGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mp == 0 || np == 0) return static_cast<int>(cudaSuccess);
  lut::PlaneScales ps{};
  for (int b = 0; b < planes; ++b) ps.v[b] = plane_scales[b];
  if (mode == lut::kPerRow) {
    const int8_t* t8 = static_cast<const int8_t*>(tv);
    switch (config) {
      case 0:
        return launch_int<MmaSmall>(t8, ts, packed, ws, out, workspace, mp, np, gp,
                                    k_group, planes, bg, splits, ps, stream);
      case 1:
        return launch_int<MmaMid>(t8, ts, packed, ws, out, workspace, mp, np, gp,
                                  k_group, planes, bg, splits, ps, stream);
      case 2:
        return launch_int<MmaLarge>(t8, ts, packed, ws, out, workspace, mp, np, gp,
                                    k_group, planes, bg, splits, ps, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (splits != 1 || workspace != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (config == 0)
    return launch_f32<lut::SmallTile>(tv, ts, packed, ws, out, mp, np, gp, k_group,
                                      planes, bg, mode, ps, stream);
  if (config == 1)
    return launch_f32<lut::LargeTile>(tv, ts, packed, ws, out, mp, np, gp, k_group,
                                      planes, bg, mode, ps, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
