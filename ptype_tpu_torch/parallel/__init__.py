"""The port's data-plane package — for now the block-scaled int8 leaf
codec of :mod:`ptype_tpu_torch.parallel.collectives`, the KV wire's
``q8`` mode."""

from ptype_tpu_torch.parallel.collectives import (DEFAULT_QUANT_BLOCK,
                                                  dequantize_leaf,
                                                  quantize_leaf)

__all__ = ["DEFAULT_QUANT_BLOCK", "dequantize_leaf", "quantize_leaf"]
