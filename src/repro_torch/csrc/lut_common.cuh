// Device code shared by the three LUT mpGEMM kernels (table_precompute.cu,
// lut_mpgemm.cu, fused_lut_mpgemm.cu): the half-table entry, INT8 table
// quantization, the packed-code unpack into CW entries, and the tiled
// table x CW contraction.
//
// Numerics are fixed to match core/table.py bit for bit: a group's entry
// sums k = 0..K-1 in order (the ±1 products are exact), the INT8 code is
// rint(entry / scale) with a true IEEE division, round half to even, and a
// clip to [-127, 127]. This file is compiled without --use_fast_math.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace lut {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr int kMaxKGroup = 8;

// Table-quant modes; the Python wrappers pass the same numbers.
enum Mode : int { kFloat = 0, kPerRow = 1, kPerGroup = 2 };

struct PlaneScales {
  int v[kMaxPlanes];
};

inline bool valid_k_group(int k) { return k == 1 || k == 2 || k == 4 || k == 8; }

// Entry e of the half-table of one K-group: Σ_{i<K-1} a_i σ_i(e) − a_{K-1}.
__device__ __forceinline__ float half_table_entry(const float (&a)[kMaxKGroup],
                                                  int k_group, int e) {
  float t = (k_group > 1 && (e & 1)) ? a[0] : -a[0];
#pragma unroll
  for (int i = 1; i < kMaxKGroup; ++i) {
    if (i < k_group) {
      const bool plus = (i < k_group - 1) && ((e >> i) & 1);
      t = plus ? __fadd_rn(t, a[i]) : __fsub_rn(t, a[i]);
    }
  }
  return t;
}

// Closed-form max_e |T[e]| = Σ_i |a_i|, summed in order.
__device__ __forceinline__ float group_abs_sum(const float (&a)[kMaxKGroup],
                                               int k_group) {
  float s = fabsf(a[0]);
#pragma unroll
  for (int i = 1; i < kMaxKGroup; ++i)
    if (i < k_group) s = __fadd_rn(s, fabsf(a[i]));
  return s;
}

__device__ __forceinline__ float per_group_scale(float abs_sum) {
  return __fdiv_rn(fmaxf(abs_sum, 1e-30f), 127.0f);
}

// INT8 code of a table entry, as a float holding an integer in [-127, 127].
__device__ __forceinline__ float quantize_entry(float t, float scale) {
  return fminf(fmaxf(rintf(__fdiv_rn(t, scale)), -127.0f), 127.0f);
}

__device__ __forceinline__ void load_group(const float* __restrict__ src,
                                           int k_group,
                                           float (&a)[kMaxKGroup]) {
#pragma unroll
  for (int i = 0; i < kMaxKGroup; ++i) a[i] = (i < k_group) ? src[i] : 0.0f;
}

// CW entries of one (channel, group): cw[e] = Σ_b ps_b (1 − 2 sign_b) [idx_b == e].
// `row` is the channel's packed byte row: fields (g, b) sit at position
// g*planes + b, k_group bits each, little-endian within a byte.
template <typename T>
__device__ __forceinline__ void unpack_cw_group(const uint8_t* __restrict__ row,
                                                int g, int planes, int k_group,
                                                const PlaneScales& ps, T* dst) {
  const int e_count = 1 << (k_group - 1);
  const int mask = (1 << k_group) - 1;
  int coef[kMaxPlanes], idx[kMaxPlanes];
#pragma unroll
  for (int b = 0; b < kMaxPlanes; ++b) {
    coef[b] = 0;
    idx[b] = -1;
    if (b < planes) {
      const int bit = (g * planes + b) * k_group;
      const int field = (row[bit >> 3] >> (bit & 7)) & mask;
      idx[b] = field & (e_count - 1);
      coef[b] = ps.v[b] * (1 - 2 * (field >> (k_group - 1)));
    }
  }
  for (int e = 0; e < e_count; ++e) {
    int v = 0;
#pragma unroll
    for (int b = 0; b < kMaxPlanes; ++b) v += (idx[b] == e) ? coef[b] : 0;
    dst[e] = static_cast<T>(v);
  }
}

// Output tile BM x BN; each of the 256 threads owns TM x TN outputs at rows
// ty + i*TY and columns tx + j*TX (strided, so a warp reads neighbouring
// shared-memory rows). KT_MIN is the least number of table entries per
// K-step; a K-step holds bg = max(1, KT_MIN / E) whole groups.
template <int BM_, int BN_, int TM_, int TN_, int KT_MIN_>
struct TileCfg {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KT_MIN = KT_MIN_;
  static constexpr int TY = BM / TM, TX = BN / TN;
  static_assert(TY * TX == kThreads, "one micro-tile per thread");
};

// Decode-sized M (<= 8 rows) and everything larger. The Python wrappers
// (kernels/lut_mpgemm.py: TILES) carry the same numbers. The small tile
// takes long K-steps (1024 entries, 128 groups at K=4): at decode the
// kernel waits on global loads, and fewer, wider steps put more loads in
// flight per barrier.
using SmallTile = TileCfg<8, 32, 1, 1, 1024>;
using LargeTile = TileCfg<64, 64, 4, 4, 128>;

// Row stride of a shared-memory tile: one spare 4-byte word per row keeps a
// warp's reads of neighbouring rows in distinct banks.
template <typename T>
__host__ __device__ constexpr int tile_ld(int kt) {
  return sizeof(T) == 1 ? kt + 4 : kt + 1;
}

template <typename T, class C>
size_t tile_smem_bytes(int kt) {
  return static_cast<size_t>(C::BM + C::BN) * tile_ld<T>(kt) * sizeof(T);
}

// acc[i][j] += Σ_k As[row i][k] · Bs[col j][k] over one K-step, int8 -> int32.
template <class C>
__device__ __forceinline__ void contract_int8(const int8_t* As, const int8_t* Bs,
                                              int kt, int ty, int tx,
                                              int (&acc)[C::TM][C::TN]) {
  const int ld = tile_ld<int8_t>(kt);
  for (int kk = 0; kk < kt; kk += 4) {
    int a[C::TM], b[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
      a[i] = *reinterpret_cast<const int*>(As + (ty + i * C::TY) * ld + kk);
#pragma unroll
    for (int j = 0; j < C::TN; ++j)
      b[j] = *reinterpret_cast<const int*>(Bs + (tx + j * C::TX) * ld + kk);
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// The same in IEEE fp32 (fused multiply-add, no TF32).
template <class C>
__device__ __forceinline__ void contract_f32(const float* As, const float* Bs,
                                             int kt, int ty, int tx,
                                             float (&acc)[C::TM][C::TN]) {
  const int ld = tile_ld<float>(kt);
  for (int kk = 0; kk < kt; ++kk) {
    float a[C::TM], b[C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i) a[i] = As[(ty + i * C::TY) * ld + kk];
#pragma unroll
    for (int j = 0; j < C::TN; ++j) b[j] = Bs[(tx + j * C::TX) * ld + kk];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Unpack the CW tile of channels n0.. n0+BN, groups g0 .. g0+bg into Bs.
template <typename T, class C>
__device__ __forceinline__ void unpack_cw_tile(const uint8_t* __restrict__ packed,
                                               int pb, int n0, int g0, int bg,
                                               int planes, int k_group,
                                               const PlaneScales& ps, T* Bs) {
  const int e_count = 1 << (k_group - 1);
  const int ld = tile_ld<T>(bg * e_count);
  for (int p = threadIdx.x; p < C::BN * bg; p += kThreads) {
    const int nl = p / bg, gl = p % bg;
    unpack_cw_group<T>(packed + static_cast<size_t>(n0 + nl) * pb, g0 + gl,
                       planes, k_group, ps, Bs + nl * ld + gl * e_count);
  }
}

// Epilogue: int path (acc · ts[m]) · ws[n], f32 path acc · ws[n].
template <class C>
__device__ __forceinline__ void store_int(const int (&acc)[C::TM][C::TN],
                                          const float* __restrict__ ts,
                                          const float* __restrict__ ws,
                                          float* __restrict__ out, int n_total,
                                          int m0, int n0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + ty + i * C::TY;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + tx + j * C::TX;
      out[static_cast<size_t>(m) * n_total + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), ts[m]), ws[n]);
    }
  }
}

template <class C>
__device__ __forceinline__ void store_f32(const float (&acc)[C::TM][C::TN],
                                          const float* __restrict__ ws,
                                          float* __restrict__ out, int n_total,
                                          int m0, int n0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int m = m0 + ty + i * C::TY;
#pragma unroll
    for (int j = 0; j < C::TN; ++j) {
      const int n = n0 + tx + j * C::TX;
      out[static_cast<size_t>(m) * n_total + n] = __fmul_rn(acc[i][j], ws[n]);
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lut
