"""Multi-tenant adapter serving: the FLoCoRA read path.

  cache     — wire-format-at-rest adapter cache (LRU/clock) + per-rank-
              bucket host->device staging
  engine    — batched multi-adapter serving over the fused packed
              kernel (and the dequant-then-matmul baseline + merged
              dense oracle), plus the single-tenant LM ``generate()``
              loop
  simulator — continuous-batching Poisson/Zipf workload harness with
              measured requests/sec and p50/p99 latency
"""
from repro_torch.serve.cache import (AdapterCache, CacheEntry, PackedPair,
                                     StagedBucket, StagedLayer,
                                     extract_pairs, wire_bytes_of)
from repro_torch.serve.engine import AdapterServingEngine, generate
from repro_torch.serve.simulator import (AdapterStore, WorkloadConfig,
                                         make_store, simulate)
