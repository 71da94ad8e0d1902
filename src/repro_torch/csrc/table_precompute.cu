// Table precompute: activations [M, G*K] f32 -> half-table [M, G*E], float
// or INT8, with the per_row row scale computed in the same launch.
//
// Replaces the TPU kernel kernels/table_precompute.py:table_precompute_pallas
// (_kernel) together with the row scale its wrapper computes before it
// (kernels/ops.py:_closed_form_row_scale: max over groups of Σ|a|, clamped
// at 1e-30, / 127). Modes: per_row quantizes with a given row scale or, when
// none is given, computes it and writes it [M]; per_group writes Σ|a|/127
// per group [M, G]; None stores the f32 entries. A second entry,
// row_scale_launch, computes the row scale alone: the fused kernel's per_row
// path quantizes its on-chip table with it.
//
// What bounds it on the H100: bytes, and at the serve path's sizes the
// launch. The entries are ±1 sums, a few adds each, with nothing for a
// tensor core to multiply; a 128-token chunk at K = 5632 reads 2.9 MB and
// writes 0.7 MB, about a microsecond at 3.35 TB/s, less than a launch. The
// design therefore does the whole operator in one launch and touches each
// byte once: a block owns whole rows (one block a row, 512 threads, so
// M = 128 fills 128 of the 132 SMs), reads a row's groups once with 16-byte
// loads (one K = 4 group is one float4, neighbouring threads on neighbouring
// groups), keeps them in registers, reduces the row's group sums to its
// scale (warp shuffles, then shared memory), then builds and quantizes the
// entries from the registers, storing a group's 8 codes as one 8-byte store
// (32 bytes as two float4 for None). Other k_groups, activations off a
// 16-byte boundary and rows of more than kMaxPer groups a thread take a
// scalar path with the same reduction (it reads a row twice when it
// computes the scale; the second read hits the cache).
//
// Numerics equal core/table.py bit for bit: a group's sum runs over k in
// order, a max is exact in any order, the division is IEEE (no fast math).
// Non-finite inputs: a scale is NaN where its row (per_row) or group
// (per_group) holds a NaN, and inf where it holds an inf and no NaN, as in
// the plain version (torch.amax and clamp_min propagate NaN; fmaxf would
// drop it). The codes of such a row are unspecified.
#include "lut_common.cuh"

namespace {

constexpr int kRowThreads = 512;
constexpr int kWarps = kRowThreads / 32;
// K = 4 groups a thread on the vector path: 1 (K <= 2048) or up to 8
// (K <= 16384: tinyllama's K = 5632 has 2.75, paper-bitnet-3b's K = 8640
// 4.2)
constexpr int kMaxPer = 8;

// max that keeps a NaN from either side, as torch.amax does
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// max(abs, 1e-30) / 127 with a NaN kept, as clamp_min and true_divide do
__device__ __forceinline__ float scale_of(float abs_max) {
  return __fdiv_rn(abs_max < 1e-30f ? 1e-30f : abs_max, 127.0f);
}

// The block's max of v (every thread passes one value); every thread gets it.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = max_nan(v, red[w]);
  __syncthreads();  // red is free for the next row
  return v;
}

// The row's scale: given, or reduced from the threads' partial maxes and
// written to scale[row] by thread 0.
__device__ __forceinline__ float row_scale_of(float partial, const float* row_scale,
                                              float* scale, int row, float* red) {
  if (row_scale != nullptr) return row_scale[row];
  const float s = scale_of(block_max(partial, red));
  if (threadIdx.x == 0) scale[row] = s;
  return s;
}

__device__ __forceinline__ void to_array(const float4& v, float (&x)[lut::kMaxKGroup]) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
#pragma unroll
  for (int i = 4; i < lut::kMaxKGroup; ++i) x[i] = 0.0f;
}

// One K = 4 group's entries (mode kFloat) or codes stored at pair p.
__device__ __forceinline__ void store_group4(const float (&x)[lut::kMaxKGroup], float s,
                                             void* values, long long p, int mode) {
  if (mode == lut::kFloat) {
    float t[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) t[e] = lut::half_table_entry(x, 4, e);
    float4* dst = reinterpret_cast<float4*>(values) + 2 * p;
    dst[0] = make_float4(t[0], t[1], t[2], t[3]);
    dst[1] = make_float4(t[4], t[5], t[6], t[7]);
    return;
  }
  unsigned word[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = static_cast<int>(lut::quantize_entry(lut::half_table_entry(x, 4, e), s));
    word[e >> 2] |= (static_cast<unsigned>(c) & 0xffu) << (8 * (e & 3));
  }
  reinterpret_cast<uint2*>(values)[p] = make_uint2(word[0], word[1]);
}

// K = 4, activations 16-byte aligned, G <= kPer * kRowThreads. values null:
// the row scale alone (mode kPerRow, no given scale).
template <int kPer>
__global__ void __launch_bounds__(kRowThreads)
precompute_k4_kernel(const float* __restrict__ a, const float* __restrict__ row_scale,
                     void* __restrict__ values, float* __restrict__ scale, int m, int g,
                     int mode) {
  __shared__ float red[kWarps];
  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    const float4* src = reinterpret_cast<const float4*>(a) + static_cast<long long>(row) * g;
    float4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int gi = threadIdx.x + i * kRowThreads;
      v[i] = gi < g ? __ldg(src + gi) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    float s = 0.0f;
    if (mode == lut::kPerRow) {
      float partial = 0.0f;
      if (row_scale == nullptr) {
        float x[lut::kMaxKGroup];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          to_array(v[i], x);
          partial = max_nan(partial, lut::group_abs_sum(x, 4));
        }
      }
      s = row_scale_of(partial, row_scale, scale, row, red);
    }
    if (values == nullptr) continue;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int gi = threadIdx.x + i * kRowThreads;
      if (gi >= g) break;
      float x[lut::kMaxKGroup];
      to_array(v[i], x);
      const long long p = static_cast<long long>(row) * g + gi;
      float sg = s;
      if (mode == lut::kPerGroup) {
        sg = scale_of(lut::group_abs_sum(x, 4));
        scale[p] = sg;
      }
      store_group4(x, sg, values, p, mode);
    }
  }
}

// Any valid k_group, any alignment, any G: scalar loads, one thread a group
// in turn. values null: the row scale alone.
__global__ void __launch_bounds__(kRowThreads)
precompute_scalar_kernel(const float* __restrict__ a, const float* __restrict__ row_scale,
                         void* __restrict__ values, float* __restrict__ scale, int m, int g,
                         int k_group, int mode) {
  __shared__ float red[kWarps];
  const int e_count = 1 << (k_group - 1);
  for (int row = blockIdx.x; row < m; row += gridDim.x) {
    const float* src = a + static_cast<long long>(row) * g * k_group;
    float s = 0.0f;
    if (mode == lut::kPerRow) {
      float partial = 0.0f;
      if (row_scale == nullptr) {
        for (int gi = threadIdx.x; gi < g; gi += kRowThreads) {
          float x[lut::kMaxKGroup];
          lut::load_group(src + gi * k_group, k_group, x);
          partial = max_nan(partial, lut::group_abs_sum(x, k_group));
        }
      }
      s = row_scale_of(partial, row_scale, scale, row, red);
    }
    if (values == nullptr) continue;
    for (int gi = threadIdx.x; gi < g; gi += kRowThreads) {
      float x[lut::kMaxKGroup];
      lut::load_group(src + gi * k_group, k_group, x);
      const long long p = static_cast<long long>(row) * g + gi;
      if (mode == lut::kFloat) {
        float* dst = static_cast<float*>(values) + p * e_count;
        for (int e = 0; e < e_count; ++e) dst[e] = lut::half_table_entry(x, k_group, e);
        continue;
      }
      float sg = s;
      if (mode == lut::kPerGroup) {
        sg = scale_of(lut::group_abs_sum(x, k_group));
        scale[p] = sg;
      }
      int8_t* dst = static_cast<int8_t*>(values) + p * e_count;
      for (int e = 0; e < e_count; ++e)
        dst[e] = static_cast<int8_t>(
            lut::quantize_entry(lut::half_table_entry(x, k_group, e), sg));
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(const float* a, const float* row_scale, void* values, float* scale, int m,
           int g, int k_group, int mode, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(m < 65535 ? m : 65535);
  const int per = (g + kRowThreads - 1) / kRowThreads;
  if (k_group == 4 && per <= kMaxPer && aligned16(a) && aligned16(values)) {
    if (per == 1)
      precompute_k4_kernel<1><<<blocks, kRowThreads, 0, stream>>>(a, row_scale, values,
                                                                   scale, m, g, mode);
    else
      precompute_k4_kernel<kMaxPer><<<blocks, kRowThreads, 0, stream>>>(
          a, row_scale, values, scale, m, g, mode);
  } else {
    precompute_scalar_kernel<<<blocks, kRowThreads, 0, stream>>>(
        a, row_scale, values, scale, m, g, k_group, mode);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// values: f32 (mode 0) or int8 (modes 1, 2), [m, g * 2^(k_group-1)].
// Mode 1 (per_row): row_scale [m] given, or null and the row scale is
// computed and written to scale [m]. Mode 2: scale [m, g] written.
extern "C" int table_precompute_launch(const float* a, const float* row_scale,
                                       void* values, float* scale, int m, int g,
                                       int k_group, int mode, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || mode < lut::kFloat || mode > lut::kPerGroup ||
      m < 0 || g < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || g == 0) return static_cast<int>(cudaSuccess);  // empty: null pointers
  if (values == nullptr ||
      (mode == lut::kPerRow && row_scale == nullptr && scale == nullptr) ||
      (mode == lut::kPerGroup && scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, row_scale, values, scale, m, g, k_group, mode, stream);
}

// The per_row row scale alone: activations [m, g * k_group] -> scale [m].
extern "C" int row_scale_launch(const float* a, float* scale, int m, int g, int k_group,
                                cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || m < 0 || g < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || g == 0) return static_cast<int>(cudaSuccess);  // empty: null pointers
  if (scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch(a, nullptr, nullptr, scale, m, g, k_group, lut::kPerRow, stream);
}
