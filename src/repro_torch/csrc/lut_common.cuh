// Device code shared by the mpGEMM kernels (table_precompute.cu,
// lut_mpgemm.cu, fused_lut_mpgemm.cu, dequant_mpgemm.cu): the half-table
// entry, INT8 table quantization, and the packed-code unpack into CW entries
// or reinterpreted weights (the tensor-core main loops are in lut_mma.cuh,
// int8, and bf16_mma.cuh, bf16).
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

// The k_group-bit field (sign << (K-1) | idx) of group g, plane b. `row` is
// the channel's packed byte row: fields (g, b) sit at position g*planes + b,
// k_group bits each, little-endian within a byte.
__device__ __forceinline__ int read_field(const uint8_t* __restrict__ row, int g,
                                          int b, int planes, int k_group) {
  const int bit = (g * planes + b) * k_group;
  return (row[bit >> 3] >> (bit & 7)) & ((1 << k_group) - 1);
}

// CW entries of one (channel, group): cw[e] = Σ_b ps_b (1 − 2 sign_b) [idx_b == e].
template <typename T>
__device__ __forceinline__ void unpack_cw_group(const uint8_t* __restrict__ row,
                                                int g, int planes, int k_group,
                                                const PlaneScales& ps, T* dst) {
  const int e_count = 1 << (k_group - 1);
  int coef[kMaxPlanes], idx[kMaxPlanes];
#pragma unroll
  for (int b = 0; b < kMaxPlanes; ++b) {
    coef[b] = 0;
    idx[b] = -1;
    if (b < planes) {
      const int field = read_field(row, g, b, planes, k_group);
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

// Reinterpreted weights of one (channel, group), the Eq. 6 unfold:
// q[i] = Σ_b ps_b (2 bit_i − 1) with bit_i = idx_i XOR sign for i < K-1 and
// bit_{K-1} = sign; q[i] = 0 for i >= K. Integers with |q| <= Σ|ps_b| <= 255.
__device__ __forceinline__ void qprime_group(const uint8_t* __restrict__ row, int g,
                                             int planes, int k_group,
                                             const PlaneScales& ps,
                                             int (&q)[kMaxKGroup]) {
#pragma unroll
  for (int i = 0; i < kMaxKGroup; ++i) q[i] = 0;
#pragma unroll
  for (int b = 0; b < kMaxPlanes; ++b) {
    if (b < planes) {
      const int field = read_field(row, g, b, planes, k_group);
      const int sign = field >> (k_group - 1);
#pragma unroll
      for (int i = 0; i < kMaxKGroup; ++i) {
        if (i < k_group) {
          const int bit = (i < k_group - 1) ? (((field >> i) & 1) ^ sign) : sign;
          q[i] += ps.v[b] * (2 * bit - 1);
        }
      }
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
