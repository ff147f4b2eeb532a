"""Hand-written CUDA kernels (sm_90a) for FLoCoRA's wire hot spots.

  quant_pack_rows  — fused per-row affine quantize + bit-pack (downlink
                     and uplink), ``csrc/quant_pack.cu``
  dequant_agg_rows — fused unpack + dequantize + weighted cohort reduce
                     of a flat-tree cohort (server), ``csrc/dequant_agg.cu``
  dequant_agg      — the same per packed leaf (the per-leaf wire), in the
                     same source
  multi_lora_matmul_packed, multi_lora_matmul
                   — the multi-tenant serving matmuls over packed
                     (fused dequant) and fp adapter slabs,
                     ``csrc/multi_lora_matmul.cu``
  lora_matmul      — single-adapter y = x@W + s*(x@a)@b in bf16 on the
                     tensor cores, ``csrc/lora_matmul.cu``

``build.py`` compiles them with ``nvcc`` at first use and binds them with
``ctypes``; ``ops.py`` holds the wrappers, ``ref.py`` the plain PyTorch
versions.
"""
from repro_torch.kernels.ops import dequant_agg, dequant_agg_rows, \
    from_channel_first_2d, lane_levels, lora_matmul, multi_lora_matmul, \
    multi_lora_matmul_packed, quant_pack, quant_pack_rows, \
    to_channel_first_2d
from repro_torch.kernels import ref
