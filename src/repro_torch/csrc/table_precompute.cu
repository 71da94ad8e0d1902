// Table precompute: activations [M, G*K] f32 -> half-table [M, G*E], float
// or INT8 (per_row with the wrapper's closed-form row scale, or per_group
// with the scale Σ|a|/127 written to [M, G]).
//
// Replaces the TPU kernel kernels/table_precompute.py:table_precompute_pallas
// (_kernel). What bounds it on the H100: bytes. Each (row, group) reads K
// floats and writes E entries with a handful of adds; at tinyllama's
// prefill shapes it moves well under a megabyte. The design gives one
// thread to each (row, group), so neighbouring threads read neighbouring
// groups (coalesced), and keeps the entry arithmetic in registers.
#include "lut_common.cuh"

namespace {

__global__ void __launch_bounds__(lut::kThreads)
table_precompute_kernel(const float* __restrict__ a,
                        const float* __restrict__ row_scale,
                        void* __restrict__ values, float* __restrict__ scale,
                        int m, int g, int k_group, int mode) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= static_cast<long long>(m) * g) return;
  const int e_count = 1 << (k_group - 1);
  float x[lut::kMaxKGroup];
  lut::load_group(a + p * k_group, k_group, x);
  if (mode == lut::kFloat) {
    float* dst = static_cast<float*>(values) + p * e_count;
    for (int e = 0; e < e_count; ++e) dst[e] = lut::half_table_entry(x, k_group, e);
    return;
  }
  float s;
  if (mode == lut::kPerRow) {
    s = row_scale[p / g];
  } else {
    s = lut::per_group_scale(lut::group_abs_sum(x, k_group));
    scale[p] = s;
  }
  int8_t* dst = static_cast<int8_t*>(values) + p * e_count;
  for (int e = 0; e < e_count; ++e)
    dst[e] = static_cast<int8_t>(lut::quantize_entry(lut::half_table_entry(x, k_group, e), s));
}

}  // namespace

// values: f32 (mode 0) or int8 (modes 1, 2), [m, g * 2^(k_group-1)];
// row_scale [m] for mode 1; scale [m, g] written for mode 2.
extern "C" int table_precompute_launch(const float* a, const float* row_scale,
                                       void* values, float* scale, int m, int g,
                                       int k_group, int mode, cudaStream_t stream) {
  if (!lut::valid_k_group(k_group) || mode < lut::kFloat || mode > lut::kPerGroup ||
      m < 0 || g < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long pairs = static_cast<long long>(m) * g;
  if (pairs == 0) return static_cast<int>(cudaSuccess);
  const unsigned blocks = static_cast<unsigned>((pairs + lut::kThreads - 1) / lut::kThreads);
  table_precompute_kernel<<<blocks, lut::kThreads, 0, stream>>>(
      a, row_scale, values, scale, m, g, k_group, mode);
  return static_cast<int>(cudaGetLastError());
}
