"""A GammaStore view that enforces block-cyclic site ownership.

The sharded plane's contract is "no host reads a Γ site it does not own".
The store refuses up front: :meth:`ShardedGammaStore._read_raw`, the one
place Γ payload bytes leave the disk (``get_raw``, ``get_segment``,
``get_segment_on_device``, ``get_segment_raw`` and the prefetch worker all
read through it), raises :class:`ShardViolation` for a foreign site before
it opens the file.  So the sharded walk cannot fall back to reading a
neighbour's sites, and the store's ``io_bytes``/``payload_reads`` count
owned traffic only.

Two deployments share the class:

* **shared root** (tests, one filer for the cluster): every site file is
  visible to every host and the view only restricts what this host may
  read.  The streaming engine wraps a plain store in this view when a
  shard map is active.
* **materialized slice** (:func:`materialize_shard`): each host's root
  holds only its owned files plus the digest manifest, so :meth:`digest`
  still gives the whole store's Merkle root (the key the gateway's
  result cache addresses results by).
"""
from __future__ import annotations

import json
import os
import shutil

import torch

from repro_torch.data.gamma_store import (MANIFEST_NAME, GammaStore,
                                          leaf_digest, merkle_root,
                                          site_filename)
from repro_torch.shard.shardmap import ShardMap


class ShardViolation(RuntimeError):
    """A host read or wrote a site it does not own."""


class ShardedGammaStore(GammaStore):
    """One host's ownership-scoped view of a (possibly sliced) store."""

    def __init__(self, root: str, shard: ShardMap, host: int,
                 storage_dtype: torch.dtype = torch.bfloat16,
                 compute_dtype: torch.dtype = torch.float32,
                 verify: bool = False):
        if not 0 <= host < shard.n_hosts:
            raise ValueError(f"host {host} outside the shard map's "
                             f"[0, {shard.n_hosts}) hosts")
        self.shard = shard
        self.host = int(host)
        super().__init__(root, storage_dtype=storage_dtype,
                         compute_dtype=compute_dtype, verify=verify)
        # the GLOBAL chain length: schedules and digests are chain-wide
        # even when this root holds a slice of the files
        self._n_sites = int(shard.n_sites)

    def _foreign(self, i: int, what: str) -> ShardViolation:
        return ShardViolation(
            f"host {self.host} tried to {what} Γ site {i}, owned by host "
            f"{self.shard.owner(i)} (block={self.shard.block}, "
            f"hosts={self.shard.n_hosts}) — only the (N, χ) env crosses "
            f"hosts, never Γ")

    # -- ownership --------------------------------------------------------------
    def _read_raw(self, i: int):
        if not self.shard.owns(self.host, i):
            raise self._foreign(i, "read")
        return super()._read_raw(i)

    def prefetch(self, i: int) -> None:
        # advisory: a "schedule the next segment" call may run past an
        # ownership boundary
        if self.shard.owns(self.host, i):
            super().prefetch(i)

    def put(self, i: int, gamma, lam) -> None:
        if not self.shard.owns(self.host, i):
            raise self._foreign(i, "write")
        super().put(i, gamma, lam)
        self._n_sites = int(self.shard.n_sites)

    def meta(self, i: int = 0) -> tuple[int, ...]:
        """The Γ shape (the npz header only).  A foreign site redirects to
        this host's first owned site: a chain streams one (χ, χ, d)
        shape, which is what callers probe for."""
        if not self.shard.owns(self.host, i):
            owned = self.shard.owned_sites(self.host)
            if not owned:
                raise ShardViolation(
                    f"host {self.host} owns no sites of the "
                    f"{self.shard.n_sites}-site chain "
                    f"(block={self.shard.block} × {self.shard.n_hosts} "
                    f"hosts) and cannot probe a site shape")
            i = owned[0]
        return super().meta(i)

    # -- the whole store's digest from a slice ----------------------------------
    def digest(self) -> str:
        """The whole store's Merkle root, from this host's owned leaves and
        the manifest's (or, on a shared root without one, by hashing the
        foreign files present: a metadata read, not a Γ payload read)."""
        if self._digest is None:
            owned_leaves = self.site_digests()
            manifest = {}
            mpath = os.path.join(self.root, MANIFEST_NAME)
            if os.path.exists(mpath):
                with open(mpath) as fh:
                    manifest = json.load(fh)
            leaves = {}
            for i in range(self.shard.n_sites):
                f = site_filename(i)
                if f in owned_leaves:
                    leaves[f] = owned_leaves[f]
                elif f in manifest:
                    leaves[f] = manifest[f]
                elif os.path.exists(os.path.join(self.root, f)):
                    leaves[f] = self._leaf_for(f)
                else:
                    raise FileNotFoundError(
                        f"sharded digest needs {MANIFEST_NAME} covering "
                        f"foreign site {i} (host {self.host} does not hold "
                        f"{f}) — materialize_shard writes the manifest")
            self._digest = merkle_root(leaves)
        return self._digest

    def site_digests(self) -> dict[str, str]:
        """Leaves of this host's owned files only."""
        leaves = {}
        for f in self._site_files():
            i = int(f[len("site_"):-len(".npz")])
            if self.shard.owns(self.host, i):
                leaves[f] = self._leaf_for(f)
        return leaves

    def verify_sites(self, sites=None) -> list[int]:
        """Verify this host's owned slice (the engine's pre-walk repair
        round), so a rotted site surfaces while a peer can still serve
        it."""
        if sites is None:
            sites = list(self.shard.owned_sites(self.host))
        return super().verify_sites(sites)


def materialize_shard(src_root: str, dst_root: str, shard: ShardMap,
                      host: int, link: bool = True) -> str:
    """Pack host ``host``'s slice of the store at ``src_root`` into
    ``dst_root``: the owned site files (hard-linked where the filesystem
    allows, else copied) and the whole digest manifest, so the slice still
    gives the store's digest.  A host's disk holds O(chain / hosts).

    A hard link shares the file with the source: rotting it rots every
    root that links it (copy a file before damaging it)."""
    os.makedirs(dst_root, exist_ok=True)
    leaves = {}
    for i in range(shard.n_sites):
        f = site_filename(i)
        src = os.path.join(src_root, f)
        with open(src, "rb") as fh:
            leaves[f] = leaf_digest(f, fh.read())
        if shard.owns(host, i):
            dst = os.path.join(dst_root, f)
            if os.path.exists(dst):
                os.remove(dst)
            if link:
                try:
                    os.link(src, dst)
                    continue
                except OSError:       # another device, or no hard links
                    pass
            shutil.copyfile(src, dst)
    mpath = os.path.join(dst_root, MANIFEST_NAME)
    tmp = mpath + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(leaves, fh, indent=0, sort_keys=True)
    os.replace(tmp, mpath)
    return dst_root


__all__ = ["ShardViolation", "ShardedGammaStore", "materialize_shard"]
