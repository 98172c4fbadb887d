"""Block-cyclic site→owner assignment and its handoff algebra.

The whole sharded data plane reduces to one pure function::

    owner(site) = (site // block) % n_hosts

Everything else — which segments a host fetches, where the environment
crosses the wire, why every site is computed exactly once — is derived
from it here, in plain host-side arithmetic, so the invariants are
property-testable (tests/test_torch_shard.py holds it against the
JAX package's copy):

* every site has exactly one owner, and the owners' ``owned_sites`` sets
  partition the chain;
* a scheduled segment never straddles two owners
  (:meth:`ShardMap.segment_owner` raises otherwise — the planner checks
  this at resolve time, the engine re-checks against the *real* schedule);
* the handoff sequence follows chain order: boundaries are strictly
  increasing and each handoff's source is the owner on the left, its
  destination the owner on the right.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


def chain_segments(n_sites: int, segment_len: int,
                   stages: Optional[Sequence] = None) -> list[tuple]:
    """The streamed walk's segment boundaries: ``segment_len``-sized chunks
    that never cross a χ-stage boundary.

    This is THE schedule shape shared by the engine
    (``StreamingEngine._segment_schedule`` attaches each stage's χ) and the
    planner's shard validation — deriving it twice independently is how a
    plan-time "every segment is single-owner" proof could silently diverge
    from the walk the engine actually runs.  ``stages`` entries are
    ``(start, stop, chi)``; ``None`` means one fixed-χ stage."""
    if stages is None:
        stages = [(0, n_sites, None)]
    out = []
    for s0, s1, chi_s in stages:
        c = s0
        while c < s1:
            out.append((c, min(c + segment_len, s1), chi_s))
            c = min(c + segment_len, s1)
    return out


@dataclasses.dataclass(frozen=True)
class ShardMap:
    """Block-cyclic chain sharding: site ``i`` → host ``(i//block) % H``."""
    n_sites: int
    n_hosts: int
    block: int          # contiguous sites per ownership block

    def __post_init__(self):
        if self.n_sites < 1:
            raise ValueError(f"n_sites must be ≥ 1, got {self.n_sites}")
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be ≥ 1, got {self.n_hosts}")
        if self.block < 1:
            raise ValueError(f"block must be ≥ 1 site, got {self.block}")

    # -- ownership -----------------------------------------------------------
    def owner(self, site: int) -> int:
        if not 0 <= site < self.n_sites:
            raise IndexError(f"site {site} outside chain [0, {self.n_sites})")
        return (site // self.block) % self.n_hosts

    def owns(self, host: int, site: int) -> bool:
        return self.owner(site) == host

    def owned_sites(self, host: int) -> list[int]:
        if not 0 <= host < self.n_hosts:
            raise IndexError(f"host {host} outside [0, {self.n_hosts})")
        return [i for i in range(self.n_sites) if self.owner(i) == host]

    @property
    def n_blocks(self) -> int:
        return -(-self.n_sites // self.block)

    # -- schedule algebra ----------------------------------------------------
    def segment_owner(self, start: int, stop: int) -> int:
        """The single owner of sites [start, stop); raises if the segment
        straddles an ownership boundary (the walk contracts a segment on
        exactly one host — a split segment has no well-defined owner)."""
        if not 0 <= start < stop <= self.n_sites:
            raise IndexError(f"segment [{start}, {stop}) outside chain "
                             f"[0, {self.n_sites}]")
        own = self.owner(start)
        if self.n_hosts > 1 and self.owner(stop - 1) != own:
            raise ValueError(
                f"segment [{start}, {stop}) straddles an ownership boundary "
                f"(block={self.block}, hosts={self.n_hosts}): sites {start} "
                f"and {stop - 1} belong to hosts {own} and "
                f"{self.owner(stop - 1)} — align segment_len/χ-stage "
                f"boundaries to the shard block")
        return own

    def owners_for(self, schedule: Sequence) -> list[int]:
        """Per-segment owners for a ``chain_segments``-shaped schedule
        (extra tuple entries beyond (start, stop) are ignored)."""
        return [self.segment_owner(s[0], s[1]) for s in schedule]

    def handoffs(self, schedule: Sequence) -> list[tuple[int, int, int]]:
        """[(boundary_site, src_host, dst_host)] — the walk's wire plan:
        one (N, χ) env transfer wherever consecutive segments change owner.
        Chain order by construction (boundaries strictly increase)."""
        owners = self.owners_for(schedule)
        out = []
        for k in range(1, len(owners)):
            if owners[k] != owners[k - 1]:
                out.append((schedule[k][0], owners[k - 1], owners[k]))
        return out


__all__ = ["ShardMap", "chain_segments"]
