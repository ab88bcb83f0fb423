"""The port's data plane on ``torch.distributed``: named-axis meshes
over a process group (:mod:`~ptype_tpu_torch.parallel.mesh`), the
topology descriptor (:mod:`~ptype_tpu_torch.parallel.topology`), the
collectives with the block-scaled int8 wire and the bucket planner
(:mod:`~ptype_tpu_torch.parallel.collectives`, which also holds the KV
wire's ``q8`` leaf codec, and the autograd collectives of the sharded
trainer), the ``TensorStore``
(:mod:`~ptype_tpu_torch.parallel.tensorstore`), the ZeRO ladder
(:mod:`~ptype_tpu_torch.parallel.zero`) and ring/Ulysses attention
(:mod:`~ptype_tpu_torch.parallel.ring_attention`)."""

from ptype_tpu_torch.parallel.collectives import (DEFAULT_QUANT_BLOCK,
                                                  dequantize_leaf,
                                                  quantize_leaf)

__all__ = ["DEFAULT_QUANT_BLOCK", "dequantize_leaf", "quantize_leaf"]
