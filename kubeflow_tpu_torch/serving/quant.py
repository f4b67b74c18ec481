"""Quantized-serving config resolution (counterpart of
``kubeflow_tpu.serving.quant``), for the unquantized path only.

The serving slice serves bf16/f32 weights and KV. ``resolve_quant``
accepts no config, an all-"none" config and the exact-parity escape hatch
(all of which mean the unquantized program); any int8 or fp8 request
raises ``NotImplementedError`` naming the slice that brings it, rather
than serving at another dtype than the one asked for.
"""

from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.serving.scheduler import QuantConfig

QUANT_SLICE = ("quantized serving (int8/fp8 KV pools with the fused-dequant "
               "decode kernel, int8 weights) is a later slice of the "
               "PyTorch port")


def resolve_quant(quant: Optional[QuantConfig]) -> QuantConfig:
    """The effective config. Unlike the JAX package there is no downgrade
    list: an unsupported mode raises instead of falling back."""
    if quant is None:
        return QuantConfig()
    quant.validate()
    if quant.exact_parity:
        return QuantConfig(exact_parity=True)
    if quant.kv_dtype != "none" or quant.weight_dtype != "none":
        raise NotImplementedError(
            f"kv_dtype={quant.kv_dtype}, weight_dtype={quant.weight_dtype}: "
            + QUANT_SLICE)
    return QuantConfig()
