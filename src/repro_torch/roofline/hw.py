"""NVIDIA H100 SXM5 80GB constants for the roofline model.

Every rate is the card's published peak from NVIDIA's H100 Tensor Core
GPU datasheet (H100 SXM column; tensor-core rates dense, without the
2:4 sparsity that doubles them there). A card set below its 700 W limit
runs slower under load: chip runs print its limit beside every time.
"""

HBM_BW = 3.35e12              # B/s, HBM3 memory bandwidth (datasheet)
HBM_BYTES = 80e9              # B, device memory (datasheet: 80 GB)
PEAK_INT8_OPS = 1979e12       # op/s, INT8 tensor core, dense (datasheet
#                               3958 TOPS with sparsity)
PEAK_BF16_FLOPS = 989e12      # FLOP/s, BF16 tensor core, dense (1979
#                               with sparsity)
PEAK_F32_FLOPS = 67e12        # FLOP/s, FP32 on the CUDA cores (datasheet)
# peak rate by operation type: what ``cost.bound`` and ``analysis.analyze``
# divide counted operations by
PEAK_OPS = {"int8": PEAK_INT8_OPS, "bf16": PEAK_BF16_FLOPS,
            "f32": PEAK_F32_FLOPS}
# NVLink 4: 18 links of 50 GB/s, 900 GB/s aggregate a GPU (datasheet), the
# collective term's rate; one card moves nothing over it
NVLINK_BW = 900e9

# effective traffic multiplier by collective type (ring algorithms)
RING_FACTOR = {
    "all-reduce": 2.0,        # reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
