"""The port's data plane on ``torch.distributed``: named-axis meshes
over a process group (:mod:`~ptype_tpu_torch.parallel.mesh`), the
topology descriptor (:mod:`~ptype_tpu_torch.parallel.topology`), the
collectives with the block-scaled int8 wire and the bucket planner
(:mod:`~ptype_tpu_torch.parallel.collectives`, which also holds the KV
wire's ``q8`` leaf codec and the param server's tree codec, and the
autograd collectives of the sharded trainer), the ``TensorStore``
(:mod:`~ptype_tpu_torch.parallel.tensorstore`), the ZeRO ladder
(:mod:`~ptype_tpu_torch.parallel.zero`), ring/Ulysses attention
(:mod:`~ptype_tpu_torch.parallel.ring_attention`) and the GPipe/1F1B
pipeline over the ``stage`` axis
(:mod:`~ptype_tpu_torch.parallel.pipeline`)."""

from ptype_tpu_torch.parallel.collectives import (DEFAULT_QUANT_BLOCK,
                                                  dequantize_leaf,
                                                  dequantize_tree,
                                                  is_quantized_tree,
                                                  quantize_leaf,
                                                  quantize_tree)

__all__ = ["DEFAULT_QUANT_BLOCK", "dequantize_leaf", "dequantize_tree",
           "is_quantized_tree", "quantize_leaf", "quantize_tree"]
