"""Paged KV-cache serving engine of the port: the
:class:`BlockPool` (ref-counted, content-addressed KV blocks on the
device), :class:`PagedGeneratorActor` (continuous batching with
chunked prefill, prefix reuse, the serving ledger, speculative decoding
with a :class:`SpecConfig`, and disaggregated prefill/decode) and the
KV wire (:class:`KVMigrator`)."""

from ptype_tpu_torch.serve_engine.blocks import (BlockPool, block_hashes,
                                                 fnv32a,
                                                 prefix_affinity_key)
from ptype_tpu_torch.serve_engine.engine import (SERVE_CLASS_CODES,
                                                 SERVE_CLASSES,
                                                 PagedGeneratorActor,
                                                 SpecConfig)
from ptype_tpu_torch.serve_engine.migrate import WIRE_MODES, KVMigrator

__all__ = ["BlockPool", "block_hashes", "fnv32a", "prefix_affinity_key",
           "PagedGeneratorActor", "SpecConfig", "SERVE_CLASSES",
           "SERVE_CLASS_CODES", "WIRE_MODES", "KVMigrator"]
