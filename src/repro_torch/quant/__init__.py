"""Weight quantization for the ESPIM value planes (DESIGN.md section 9).

The paper stores narrow fixed-point cell *values* in DRAM, decoupled from
the cell *indices* (contribution 3) — the bytes/nnz crossing the pin is the
metric its architecture optimizes.  This package is that value-plane
discipline for the packed formats: ``calibrate`` turns a pack's fp value
plane into per-row-group scales + int8/int4 codes (indices, perms and SDDS
schedules untouched), ``qpack`` carries the quantized plane through
(de)quantization, serialization and bytes accounting.
"""
from repro_torch.quant.calibrate import (QuantSpec, default_spec, group_scales,
                                   quantize_codes)
from repro_torch.quant.qpack import (QuantizedValuePlane, dequantize_plane,
                               quantize_bucketed_stack, quantize_pack,
                               quantize_plane)

__all__ = [
    "QuantSpec",
    "default_spec",
    "group_scales",
    "quantize_codes",
    "QuantizedValuePlane",
    "quantize_plane",
    "quantize_pack",
    "quantize_bucketed_stack",
    "dequantize_plane",
]
