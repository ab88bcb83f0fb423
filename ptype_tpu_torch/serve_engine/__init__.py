"""Paged KV-cache serving engine of the port: the
:class:`BlockPool` (ref-counted, content-addressed KV blocks on the
device) and :class:`PagedGeneratorActor` (continuous batching with
chunked prefill, prefix reuse and, with a :class:`SpecConfig`,
speculative decoding)."""

from ptype_tpu_torch.serve_engine.blocks import (BlockPool, block_hashes,
                                                 fnv32a,
                                                 prefix_affinity_key)
from ptype_tpu_torch.serve_engine.engine import (PagedGeneratorActor,
                                                 SpecConfig)

__all__ = ["BlockPool", "block_hashes", "fnv32a", "prefix_affinity_key",
           "PagedGeneratorActor", "SpecConfig"]
