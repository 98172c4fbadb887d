"""The chain-sharded data plane: block-cyclic Γ ownership.

The §3.1 broadcast plane ships every Γ segment to every process: the wire
carries O(hosts × chain) bytes and one host's disk holds the whole store.
Following Adamski & Brown (block-cyclic distributed MPS, PAPERS.md), the
chain itself is a third axis of parallelism beside DP over samples and TP
over the bond:

* :class:`ShardMap` — the ownership algebra: site ``i`` belongs to host
  ``(i // block) % n_hosts``;
* :class:`ShardedGammaStore` — a :class:`~repro_torch.data.gamma_store.
  GammaStore` view that refuses to read any site its host does not own,
  before it opens the file;
* :func:`materialize_shard` — one host's slice of a store, with the digest
  manifest that lets the slice answer for the whole store's digest;
* :mod:`repro_torch.shard.walk` — the wire codecs: the owner of segment k
  ships only the (N, χ) environment to the owner of k+1
  (``ClusterRuntime.send``/``recv``), and the hosts' sample blocks meet in
  one all-gather at the end.

The walk itself is ``engine.StreamingEngine(shard=...)``, reached through
the front door as ``SamplerConfig(shard=<block sites> | "auto")``.
"""
from repro_torch.shard.shardmap import ShardMap, chain_segments
from repro_torch.shard.store import (ShardedGammaStore, ShardViolation,
                                     materialize_shard)

__all__ = ["ShardMap", "ShardedGammaStore", "ShardViolation",
           "chain_segments", "materialize_shard"]
