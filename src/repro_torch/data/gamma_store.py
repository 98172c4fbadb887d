"""Γ tensor store with a one-slot background prefetch (paper §3.1, §3.3.2).

The on-disk format is the JAX package's (``repro.data.gamma_store``), so a
store written by either package reads in the other with the same digest:

* one npz per site (:func:`site_filename`) holding ``gamma``, ``gshape``,
  ``lam`` and ``two_byte``;
* a bf16 store keeps Γ as the uint16 view of its bf16 values (the paper's
  16-bit storage, half the bytes of fp32 and a quarter of fp64); other
  storage dtypes keep Γ as it is;
* Merkle digests: a leaf per site file (:func:`leaf_digest`), the store's
  :meth:`GammaStore.digest` over the leaves, an optional ``digests.json``
  manifest that verified reads and :meth:`GammaStore.verify_sites` check.

Rounding to bf16 (:func:`bf16_bits`) is the JAX package's cast bit for
bit: through fp32, with the fp32 results that are tiny flushed to zero
(XLA's CPU backend runs with flush-to-zero); ``Tensor.to(torch.bfloat16)``
keeps those as subnormals.

Reading.  A site's bytes are read once, by a worker thread that the walk
keeps one step ahead (:meth:`GammaStore.get` never reads a site twice).
The file goes straight into a host buffer — pinned memory when the store
feeds a CUDA device (:attr:`GammaStore.pin_memory`) — and Γ's bytes are
located inside it (the zip member and the ``.npy`` header) and checked
against the member's CRC-32; a torn file or a failed check raises
:class:`CorruptSegment` after one re-read, and the file is quarantined.
On an H100 machine's host an 800 MB bf16 site reads this way at 1.5 GB/s
from the page cache, against 0.7 GB/s for ``np.load`` followed by
``pin_memory()`` (``scripts/read_path.py``).

:meth:`GammaStore.get_segment_on_device` is the card's path: the packed
bytes go from the pinned buffers to the device on a separate CUDA stream
(``non_blocking``), in the storage format, and are upcast there
(``.view(torch.bfloat16).to(compute dtype)``: exact, so bit for bit what
the host decode gives).  The caller's stream waits on the returned event.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import queue
import struct
import threading
import time
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.mps import site_tile
from repro_torch.runtime.faults import CorruptSegment, Fault

#: per-store digest manifest: site file name → leaf digest
MANIFEST_NAME = "digests.json"

_STORAGE = (torch.bfloat16, torch.float32, torch.float64, torch.complex64,
            torch.complex128)
_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128}
_TORCH = {np.dtype(v): k for k, v in _NUMPY.items()}
# elements per chunk of the bf16 rounding (bounds its temporaries)
_ROUND_CHUNK = 2 ** 25
# fp64 magnitudes whose fp32 rounding is tiny: XLA flushes those to zero
_FLUSH_BELOW = 2.0 ** -126 * (1 - 2.0 ** -25)


def site_filename(i: int) -> str:
    """Canonical site-file name (the JAX package's)."""
    return f"site_{i:06d}.npz"


def leaf_digest(fname: str, data) -> str:
    """Merkle leaf: sha256 over the site file's name and bytes."""
    h = hashlib.sha256()
    h.update(fname.encode())
    h.update(data)
    return h.hexdigest()


def merkle_root(leaves: dict[str, str]) -> str:
    """The store digest: sha256 over the sorted ``name:leaf`` lines."""
    h = hashlib.sha256()
    for f in sorted(leaves):
        h.update(f"{f}:{leaves[f]}\n".encode())
    return h.hexdigest()


def bf16_bits(x) -> torch.Tensor:
    """Round a real tensor (or array) to bf16 as the JAX package's cast of
    fp64 does (XLA on the CPU): to fp32 by round-to-nearest-even, a result
    that is tiny after rounding (below 2⁻¹²⁶ at fp32's precision with an
    unbounded exponent, so below 2⁻¹²⁶·(1 − 2⁻²⁵)) flushed to a zero of
    its sign, then to bf16 by round-to-nearest-even.  On the tensor's
    device; returns the bf16 values' bits as int16 (``.view(torch.
    bfloat16)`` reads them).  fp32 inputs round once, subnormals kept, as
    there."""
    t = torch.as_tensor(x)
    if t.is_complex():
        raise ValueError("bf16 storage is real: a complex Γ would lose its "
                         "imaginary part (use the identity storage dtype)")
    flat = t.reshape(-1)
    out = torch.empty(flat.shape, dtype=torch.int16, device=flat.device)
    for o in range(0, flat.numel(), _ROUND_CHUNK):
        part = flat[o:o + _ROUND_CHUNK]
        r = part.to(torch.float32)
        if part.dtype == torch.float64:
            r = torch.where(part.abs() < _FLUSH_BELOW, r * 0, r)
        out[o:o + _ROUND_CHUNK] = r.to(torch.bfloat16).view(torch.int16)
    return out.reshape(t.shape)


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class RawSite:
    """One site in storage format: Γ's bytes inside ``buf`` (a uint8
    tensor, pinned when the store pins) from ``offset``, and its
    metadata."""
    buf: torch.Tensor
    offset: int
    nbytes: int
    dtype: np.dtype          # the stored array's dtype (uint16 for bf16)
    gshape: tuple
    lam: np.ndarray
    two_byte: bool

    def view(self) -> np.ndarray:
        """Γ as a numpy array of its stored dtype (no copy; may be
        unaligned)."""
        return np.frombuffer(self.buf.numpy(), dtype=self.dtype,
                             count=self.nbytes // self.dtype.itemsize,
                             offset=self.offset).reshape(self.gshape)


class _BufferFile(io.RawIOBase):
    """A read-only file over a memoryview, so ``zipfile`` parses the
    headers of an archive already in memory without copying it."""

    def __init__(self, mv: memoryview):
        self._mv, self._pos = mv, 0

    def readable(self) -> bool:
        return True

    def seekable(self) -> bool:
        return True

    def tell(self) -> int:
        return self._pos

    def seek(self, off: int, whence: int = 0) -> int:
        base = (0, self._pos, len(self._mv))[whence]
        self._pos = max(0, base + off)
        return self._pos

    def readinto(self, b) -> int:
        n = max(0, min(len(b), len(self._mv) - self._pos))
        b[:n] = self._mv[self._pos:self._pos + n]
        self._pos += n
        return n


def _small_member(zf: zipfile.ZipFile, name: str) -> np.ndarray:
    with zf.open(name + ".npy") as fh:
        return np.lib.format.read_array(fh)


def _parse_site(buf: torch.Tensor) -> RawSite:
    """Locate Γ in a site file's bytes; raises on any structural fault."""
    mv = memoryview(buf.numpy())
    zf = zipfile.ZipFile(_BufferFile(mv))
    info = zf.getinfo("gamma.npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError("gamma.npy is compressed")
    head = bytes(mv[info.header_offset:info.header_offset + 30])
    if len(head) < 30 or head[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile("bad local header of gamma.npy")
    n_name, n_extra = struct.unpack("<HH", head[26:30])
    start = info.header_offset + 30 + n_name + n_extra
    member = mv[start:start + info.file_size]
    if len(member) != info.file_size:
        raise EOFError("gamma.npy is truncated")
    if zlib.crc32(member) != info.CRC:
        raise zipfile.BadZipFile("bad CRC-32 for gamma.npy")
    npy = _BufferFile(member)
    version = np.lib.format.read_magic(npy)
    read_header = {(1, 0): np.lib.format.read_array_header_1_0,
                   (2, 0): np.lib.format.read_array_header_2_0}[version]
    shape, fortran, dtype = read_header(npy)
    if fortran:
        raise ValueError("gamma.npy is Fortran-ordered")
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if npy.tell() + nbytes != info.file_size:
        raise ValueError("gamma.npy's size disagrees with its header")
    gshape = tuple(int(x) for x in _small_member(zf, "gshape"))
    lam = _small_member(zf, "lam")
    two_byte = bool(_small_member(zf, "two_byte"))
    return RawSite(buf, start + npy.tell(), nbytes, dtype, gshape, lam,
                   two_byte)


def decode_gamma(raw: np.ndarray, gshape: tuple, two_byte: bool,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Storage-format Γ (an array, a leading stack axis allowed) → a
    compute-dtype tensor on the host.  bf16 upcasts are exact."""
    lead = raw.shape[:max(0, raw.ndim - len(gshape))]
    if two_byte:
        g = torch.from_numpy(np.ascontiguousarray(raw).view(np.int16))
        g = g.view(torch.bfloat16).reshape(lead + tuple(gshape))
    else:
        g = torch.from_numpy(np.ascontiguousarray(raw))
    return g.to(compute_dtype)


def _bytes_of(a: np.ndarray) -> memoryview:
    """An array's bytes, without the copy ``tobytes`` makes."""
    return memoryview(np.ascontiguousarray(a)).cast("B")


def segment_checksum(gamma: np.ndarray, lam: np.ndarray) -> int:
    """CRC-32 over a segment payload's packed Γ and Λ bytes."""
    return zlib.crc32(_bytes_of(lam), zlib.crc32(_bytes_of(gamma)))


def _check_crc(payload: dict) -> None:
    """Raise :class:`CorruptSegment` if a payload's ``crc`` does not match
    its bytes (a payload without one passes)."""
    if payload.get("crc") is not None:
        want = int(np.asarray(payload["crc"]))
        got = segment_checksum(payload["gamma"], payload["lam"])
        if got != want:
            start = int(np.asarray(payload.get("start", -1)))
            raise CorruptSegment(Fault(
                kind="corruption", site=start,
                message=f"segment payload at site {start} failed its "
                        f"checksum (crc {got:#010x} != {want:#010x}) — "
                        f"rejected at decode, not sampled from"))


def decode_segment(payload: dict, compute_dtype: Optional[torch.dtype] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """A segment payload (:meth:`GammaStore.get_segment_raw`) → stacked
    (gammas (L, χ, χ, d), lambdas (L, χ)) host tensors; a payload whose
    ``crc`` does not match raises :class:`CorruptSegment`."""
    _check_crc(payload)
    compute = payload["compute_dtype"] if compute_dtype is None \
        else compute_dtype
    g = decode_gamma(payload["gamma"], tuple(payload["gshape"]),
                     bool(payload["two_byte"]), compute)
    return g, torch.from_numpy(np.ascontiguousarray(payload["lam"]))


def payload_on_device(payload: dict, device: torch.device, *,
                      chi: Optional[int] = None,
                      compute_dtype: Optional[torch.dtype] = None,
                      stream=None, tile: Optional[tuple] = None) -> dict:
    """A segment payload (a store's :meth:`GammaStore.get_segment_raw`, or
    one a runtime broadcast) on ``device``, both bonds cut to ``chi`` and,
    with ``tile``, each Γ to a rank's tile, in
    :meth:`GammaStore.get_segment_on_device`'s form.  The ``crc`` is
    checked first, over the whole payload.  On the card the storage-format
    bytes are copied on ``stream`` and upcast there; on the CPU they are
    decoded on the host."""
    _check_crc(payload)
    raw = np.asarray(payload["gamma"])
    gshape = tuple(int(x) for x in payload["gshape"])
    c = gshape[0] if chi is None else chi
    compute = payload["compute_dtype"] if compute_dtype is None \
        else compute_dtype
    lam = torch.from_numpy(np.ascontiguousarray(
        np.asarray(payload["lam"])[:, :c]))
    device = torch.device(device)
    start = int(np.asarray(payload.get("start", 0)))
    blocks = _site_blocks(list(raw), c, tile, start)
    whole = None
    if device.type == "cuda" and (tile is None or tile[1] == 1):
        whole = [torch.from_numpy(np.ascontiguousarray(raw[:, :c, :c, :])
                                  .reshape(-1).view(np.uint8))]
    stored = torch.bfloat16 if payload["two_byte"] else _TORCH[raw.dtype]
    return _blocks_to_device(blocks, whole, stored, compute, lam, device,
                             stream, _pairs(tile))


def _site_blocks(views: list, c: int, tile: Optional[tuple],
                 start: int) -> list:
    """Each site's stored Γ (χ, χ, d) cut to the χ-stage ``c`` and, with
    ``tile`` = (scheme, p₂, rank), to that rank's tile of it
    (``core.mps.site_tile``; site ``start + i``): numpy views."""
    out = []
    for i, v in enumerate(views):
        v = v[:c, :c, :]
        out.append(v if tile is None else site_tile(v, *tile, start + i))
    return out


def _pairs(tile: Optional[tuple]) -> bool:
    return tile is not None and tile[0] == "tp_double"


def _split_sites(g: torch.Tensor, shapes: list, pairs: bool) -> dict:
    """A flat buffer of the sites' Γ blocks, in order, as the segment's
    ``gammas`` (L, …) or, with ``pairs`` (a tp_double tile), ``gammas`` of
    the sites 2j and ``gammas_right`` of the sites 2j + 1, each (L/2, …)."""
    n = len(shapes)
    if not pairs:
        return {"gammas": g.view(n, *shapes[0]), "gammas_right": None}
    two = g.view(n // 2, 2, -1)
    return {"gammas": two[:, 0].view(n // 2, *shapes[0]),
            "gammas_right": two[:, 1].view(n // 2, *shapes[1])}


def _blocks_to_device(blocks: list, whole: Optional[list],
                      stored: torch.dtype, compute: torch.dtype,
                      lam: torch.Tensor, device: torch.device, stream,
                      pairs: bool) -> dict:
    """The sites' storage-format Γ blocks (numpy) on ``device`` in
    ``compute``: decoded on the host for the CPU; on the card one buffer
    filled on ``stream`` and upcast there, from ``whole`` (uint8 host
    tensors that already hold the blocks' bytes in order) or else from a
    pinned copy of each block made here; ``pairs`` as
    :func:`_split_sites`'."""
    shapes = [tuple(b.shape) for b in blocks]
    two_byte = stored == torch.bfloat16
    if device.type != "cuda":
        g = torch.cat([decode_gamma(b, b.shape, two_byte, compute).reshape(-1)
                       for b in blocks])
        return {**_split_sites(g, shapes, pairs), "lambdas": lam.to(device),
                "ready": None, "copy": None, "bytes": 0}
    chunks = whole
    if chunks is None:
        chunks = []
        for b in blocks:
            part = torch.empty(b.size * b.dtype.itemsize, dtype=torch.uint8,
                               pin_memory=True)
            part.numpy().view(b.dtype).reshape(b.shape)[...] = b
            chunks.append(part)
    return _segment_to_device(chunks, shapes, stored, compute, lam, device,
                              stream, pairs)


def _segment_to_device(chunks: list, shapes: list, stored: torch.dtype,
                       compute: torch.dtype, lam: torch.Tensor,
                       device: torch.device, stream, pairs: bool) -> dict:
    """Host storage-format bytes (uint8 tensors, pinned for an asynchronous
    copy) → one device buffer on ``stream``, viewed as ``stored``, upcast to
    ``compute`` there and split into the sites' ``shapes``
    (:func:`_split_sites`): the card's half of
    :meth:`GammaStore.get_segment_on_device` and :func:`payload_on_device`.
    """
    h2d0 = torch.cuda.Event(enable_timing=True)
    h2d1 = torch.cuda.Event(enable_timing=True)
    ready = torch.cuda.Event()
    with torch.cuda.stream(stream):
        dev = torch.empty(sum(ch.numel() for ch in chunks),
                          dtype=torch.uint8, device=device)
        h2d0.record(stream)
        o = 0
        for ch in chunks:
            dev[o:o + ch.numel()].copy_(ch, non_blocking=True)
            o += ch.numel()
        h2d1.record(stream)
        g = dev.view(stored)
        g = g.to(compute) if g.dtype != compute else g
        lam_d = lam.to(device)
        del dev
        ready.record(stream)
    return {**_split_sites(g, shapes, pairs), "lambdas": lam_d,
            "ready": ready,
            "copy": (h2d0, h2d1),
            "bytes": o + lam.numel() * lam.element_size()}


class GammaStore:
    """A chain's Γ and Λ on disk, one npz per site (see module docstring).

    ``storage_dtype`` is how :meth:`put` writes Γ (bf16, or the identity
    dtypes fp32/fp64/complex64/complex128); ``compute_dtype`` what reads
    decode to.  ``pin_memory`` makes reads land in pinned host memory (the
    streaming engine turns it on when it walks on a CUDA device)."""

    def __init__(self, root: str, storage_dtype: torch.dtype = torch.bfloat16,
                 compute_dtype: torch.dtype = torch.float32,
                 verify: bool = False):
        if storage_dtype not in _STORAGE:
            raise ValueError(f"storage dtype {storage_dtype} is not one of "
                             f"{_STORAGE}")
        self.root = str(root)
        self.storage_dtype = storage_dtype
        self.compute_dtype = compute_dtype
        self.verify = verify
        self.pin_memory = False
        os.makedirs(self.root, exist_ok=True)
        self._prefetched: dict[int, object] = {}
        self._inflight: set[int] = set()
        self._lock = threading.Lock()
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._results: "queue.Queue[tuple[int, object]]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        self._streams: dict = {}          # device → its copy stream
        self.io_bytes = 0          # Γ + Λ payload bytes read
        self.io_seconds = 0.0      # read wall time (worker and callers)
        self.payload_reads = 0     # site payload reads (meta() excluded)
        self.verified_reads = 0    # payload reads checked against a manifest
        self.quarantined_sites = 0
        self.repaired_sites = 0    # sites restored from a peer's copy
        self.repair_read_bytes = 0  # bytes read to serve a peer's repair
        self._digest: Optional[str] = None
        self._sigleaves: dict[str, tuple[tuple, str]] = {}
        self._manifest: Optional[tuple[tuple, dict]] = None
        self._n_sites = sum(1 for f in os.listdir(self.root)
                            if f.startswith("site_") and f.endswith(".npz"))

    # -- write path ---------------------------------------------------------
    def put(self, i: int, gamma, lam) -> None:
        """Write site i; Γ (a tensor on any device, or an array) is rounded
        to the storage dtype on its own device."""
        fresh = not os.path.exists(self._path(i))
        shape = tuple(gamma.shape)
        if self.storage_dtype == torch.bfloat16:
            g = _as_numpy(bf16_bits(gamma)).view(np.uint16)
        else:
            g = _as_numpy(gamma).astype(_NUMPY[self.storage_dtype])
        np.savez(self._path(i), gamma=g, gshape=np.array(shape),
                 lam=_as_numpy(lam), two_byte=np.array(g.dtype.itemsize == 2))
        if fresh:
            self._n_sites += 1
        self._digest = None
        self._sigleaves.pop(site_filename(i), None)

    def write_mps(self, mps) -> None:
        for i in range(mps.n_sites):
            self.put(i, mps.gammas[i], mps.lambdas[i])

    # -- metadata and digests -----------------------------------------------
    def _path(self, i: int) -> str:
        return os.path.join(self.root, site_filename(i))

    @property
    def n_sites(self) -> int:
        return self._n_sites

    def _site_files(self) -> list[str]:
        return sorted(f for f in os.listdir(self.root)
                      if f.startswith("site_") and f.endswith(".npz"))

    def _stat_sig(self, path: str) -> tuple:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def _leaf_for(self, f: str) -> str:
        """Leaf digest of one site file, cached per stat signature."""
        path = os.path.join(self.root, f)
        sig = self._stat_sig(path)
        cached = self._sigleaves.get(f)
        if cached is not None and cached[0] == sig:
            return cached[1]
        with open(path, "rb") as fh:
            leaf = leaf_digest(f, fh.read())
        self._sigleaves[f] = (sig, leaf)
        return leaf

    def site_digests(self) -> dict[str, str]:
        return {f: self._leaf_for(f) for f in self._site_files()}

    def digest(self) -> str:
        """The Merkle root over the site files' leaves (cached; a
        :meth:`put` invalidates it)."""
        if self._digest is None:
            self._digest = merkle_root(self.site_digests())
        return self._digest

    def write_digest_manifest(self) -> str:
        """Persist the leaves as ``digests.json`` (atomically)."""
        path = os.path.join(self.root, MANIFEST_NAME)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.site_digests(), fh, indent=0, sort_keys=True)
        os.replace(tmp, path)
        self._manifest = None
        return path

    def manifest_leaves(self) -> dict[str, str]:
        """The manifest's leaves (``{}`` without one), cached per stat."""
        path = os.path.join(self.root, MANIFEST_NAME)
        try:
            sig = self._stat_sig(path)
        except OSError:
            self._manifest = None
            return {}
        if self._manifest is not None and self._manifest[0] == sig:
            return self._manifest[1]
        with open(path) as fh:
            data = json.load(fh)
        self._manifest = (sig, data)
        return data

    def meta(self, i: int = 0) -> tuple[int, ...]:
        """Γ shape of site i from the npz, without reading Γ."""
        with np.load(self._path(i)) as z:
            return tuple(int(x) for x in z["gshape"])

    def quarantine_site(self, i: int) -> Optional[str]:
        """Move a corrupt site file aside (``*.quarantine``)."""
        path = self._path(i)
        qpath = path + ".quarantine"
        try:
            os.replace(path, qpath)
        except OSError:
            return None
        with self._lock:
            self.quarantined_sites += 1
        self._sigleaves.pop(site_filename(i), None)
        self._digest = None
        return qpath

    def verify_sites(self, sites=None) -> list[int]:
        """Check site files against the manifest; quarantine and return the
        ones that fail (sites without a file or a manifest entry are
        skipped)."""
        manifest = self.manifest_leaves()
        if sites is None:
            sites = [int(f[len("site_"):-len(".npz")])
                     for f in self._site_files()]
        bad = []
        for i in sites:
            f = site_filename(i)
            expected = manifest.get(f)
            if expected is None or not os.path.exists(
                    os.path.join(self.root, f)):
                continue
            try:
                ok = self._leaf_for(f) == expected
            except OSError:
                ok = False
            if not ok:
                self.quarantine_site(i)
                bad.append(i)
        return bad

    # -- peer repair (the sharded plane's pre-walk round) --------------------
    def has_healthy_copy(self, i: int) -> bool:
        """Does this root hold site i's file with the manifest's bytes?  A
        metadata read, never a Γ payload read."""
        f = site_filename(i)
        if not os.path.exists(os.path.join(self.root, f)):
            return False
        expected = self.manifest_leaves().get(f)
        if expected is None:
            return False
        try:
            return self._leaf_for(f) == expected
        except OSError:
            return False

    def read_repair_bytes(self, i: int) -> bytes:
        """Site i's file bytes for a peer's repair, checked against the
        manifest before they leave this host (rot is never shipped).  It
        bypasses shard ownership on purpose (a healthy copy of a foreign
        site is what a repair needs) and counts apart from payload reads
        (:attr:`repair_read_bytes`)."""
        f = site_filename(i)
        with open(os.path.join(self.root, f), "rb") as fh:
            data = fh.read()
        expected = self.manifest_leaves().get(f)
        if expected is not None and leaf_digest(f, data) != expected:
            raise CorruptSegment(Fault(
                kind="corruption", site=i, store=self.root,
                message=f"repair source for Γ site {i} is itself corrupt"))
        with self._lock:
            self.repair_read_bytes += len(data)
        return data

    def restore_site(self, i: int, data: bytes) -> None:
        """Write site i from repair bytes atomically (checked against the
        manifest when there is one) and drop a quarantined copy: the
        receiving end of a peer repair."""
        f = site_filename(i)
        expected = self.manifest_leaves().get(f)
        if expected is not None and leaf_digest(f, data) != expected:
            raise CorruptSegment(Fault(
                kind="corruption", site=i, store=self.root,
                message=f"repair payload for Γ site {i} failed "
                        f"verification — refusing to install it"))
        path = self._path(i)
        tmp = path + ".repair_tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        try:
            os.unlink(path + ".quarantine")
        except OSError:
            pass
        self._sigleaves.pop(f, None)
        self._digest = None
        with self._lock:
            self.repaired_sites += 1

    # -- read path ----------------------------------------------------------
    def _read_raw(self, i: int) -> RawSite:
        """Site i's file, read once into a host buffer and located (see
        module docstring).  The only place payload bytes leave the disk."""
        t0 = time.perf_counter()
        path, fname = self._path(i), site_filename(i)
        fault, checked, raw = None, False, None
        for _attempt in range(2):
            fault = None
            with open(path, "rb") as fh:     # FileNotFoundError propagates
                size = os.fstat(fh.fileno()).st_size
                buf = torch.empty(size, dtype=torch.uint8,
                                  pin_memory=self.pin_memory)
                got = fh.readinto(memoryview(buf.numpy()))
            if self.verify:
                expected = self.manifest_leaves().get(fname)
                if expected is not None:
                    checked = True
                    if leaf_digest(fname, memoryview(buf.numpy())[:got]) \
                            != expected:
                        fault = Fault(
                            kind="corruption", site=i, store=self.root,
                            message=f"Γ site {i} failed digest verification "
                                    f"against {MANIFEST_NAME} in {self.root}")
                        continue
            try:
                if got != size:
                    raise EOFError(f"read {got} of {size} bytes")
                raw = _parse_site(buf)
            except (zipfile.BadZipFile, ValueError, KeyError, EOFError,
                    OSError, struct.error) as e:
                fault = Fault(
                    kind="corruption", site=i, store=self.root,
                    message=f"Γ site {i} is structurally corrupt "
                            f"({type(e).__name__}: {e})")
                continue
            break
        if fault is not None:
            self.quarantine_site(i)
            raise CorruptSegment(fault)
        with self._lock:
            self.io_bytes += raw.nbytes + raw.lam.nbytes
            self.io_seconds += time.perf_counter() - t0
            self.payload_reads += 1
            if checked:
                self.verified_reads += 1
        return raw

    def _worker(self):
        while True:
            i = self._queue.get()
            if i is None:
                return
            try:
                self._results.put((i, self._read_raw(i)))
            except Exception as e:          # surfaced on the consumer side
                self._results.put((i, e))

    def prefetch(self, i: int) -> None:
        with self._lock:
            if i in self._inflight or i in self._prefetched:
                return
            self._inflight.add(i)
        self._queue.put(i)

    def prefetch_segment(self, start: int, length: int) -> None:
        """Schedule sites [start, start+length) on the worker thread."""
        for i in range(start, min(start + length, self.n_sites)):
            self.prefetch(i)

    def _drain(self, block: bool) -> bool:
        """Move one worker result into ``_prefetched``; True if one came."""
        try:
            j, payload = self._results.get(block=block,
                                           timeout=600.0 if block else None)
        except queue.Empty:
            if block:
                raise TimeoutError("prefetch worker stalled >600 s")
            return False
        with self._lock:
            self._inflight.discard(j)
            self._prefetched[j] = payload
        return True

    def get_raw(self, i: int, prefetch_next: bool = True) -> RawSite:
        """Site i in storage format, from the prefetch slot when the worker
        has it or is reading it (never a second read); schedules i+1."""
        while True:
            with self._lock:
                hit = self._prefetched.pop(i, None)
                wait = i in self._inflight
            if hit is not None:
                break
            if wait:
                self._drain(block=True)
                continue
            if not self._drain(block=False):
                hit = self._read_raw(i)
                break
        if isinstance(hit, Exception):
            raise hit
        if prefetch_next and os.path.exists(self._path(i + 1)):
            self.prefetch(i + 1)
        return hit

    def get(self, i: int, prefetch_next: bool = True
            ) -> tuple[torch.Tensor, torch.Tensor]:
        """Site i decoded to the compute dtype on the host: (Γ, Λ)."""
        raw = self.get_raw(i, prefetch_next)
        return (decode_gamma(raw.view(), raw.gshape, raw.two_byte,
                             self.compute_dtype),
                torch.from_numpy(np.ascontiguousarray(raw.lam)))

    def _raw_segment(self, start: int, length: int,
                     prefetch_next_segment: bool) -> list[RawSite]:
        stop = min(start + length, self.n_sites)
        self.prefetch_segment(start, stop - start)
        if prefetch_next_segment:
            self.prefetch_segment(stop, length)
        return [self.get_raw(i, prefetch_next=False)
                for i in range(start, stop)]

    def get_segment(self, start: int, length: int,
                    prefetch_next_segment: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sites [start, start+length) decoded on the host: (gammas
        (L, χ, χ, d), lambdas (L, χ)).  Schedules the next segment on the
        worker before collecting this one."""
        raws = self._raw_segment(start, length, prefetch_next_segment)
        g = torch.stack([decode_gamma(r.view(), r.gshape, r.two_byte,
                                      self.compute_dtype) for r in raws])
        lam = torch.from_numpy(np.stack([r.lam for r in raws]))
        return g, lam

    def copy_stream(self, device: torch.device):
        """The store's CUDA stream for host→device copies on ``device``."""
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def get_segment_on_device(self, start: int, length: int,
                              device: torch.device, *,
                              chi: Optional[int] = None,
                              prefetch_next_segment: bool = True,
                              tile: Optional[tuple] = None) -> dict:
        """Sites [start, start+length) on ``device``, both bonds cut to
        ``chi`` (the χ-stage; None: the stored χ) and, with ``tile`` =
        (scheme, p₂, rank), each Γ to that rank's tile
        (``core.mps.site_tile``).  Returns ``{"gammas", "gammas_right",
        "lambdas", "ready", "copy", "bytes"}`` (``gammas_right``: a
        tp_double tile's right-bond blocks of the sites start + 2j + 1,
        ``gammas`` then holds the others; None otherwise); on a CUDA
        device ``ready`` is the event the consuming stream must wait on,
        ``copy`` the pair of events around the host→device copies and
        ``bytes`` what they moved; on the CPU the events are None and
        nothing is copied.

        On the card: the storage-format bytes of each site (pinned; a
        χ-stage's or a tile's block copied to pinned memory on the host
        first) are copied on the store's copy stream with
        ``non_blocking=True`` into one device buffer, which is upcast there
        to the compute dtype.  Tensors made on the copy stream are handed
        to the consumer, who must ``record_stream`` them on the stream that
        uses them."""
        device = torch.device(device)
        raws = self._raw_segment(start, length, prefetch_next_segment)
        gshape = raws[0].gshape
        c = gshape[0] if chi is None else chi
        lam = torch.from_numpy(np.ascontiguousarray(
            np.stack([r.lam for r in raws])[:, :c]))
        blocks = _site_blocks([r.view() for r in raws], c, tile, start)
        whole = None
        if device.type == "cuda" and c == gshape[0] and (
                tile is None or tile[1] == 1):      # whole sites, in order
            whole = [r.buf[r.offset:r.offset + r.nbytes] for r in raws]
        stored = torch.bfloat16 if raws[0].two_byte else \
            _TORCH[raws[0].dtype]
        return _blocks_to_device(
            blocks, whole, stored, self.compute_dtype, lam, device,
            self.copy_stream(device) if device.type == "cuda" else None,
            _pairs(tile))

    def get_segment_raw(self, start: int, length: int) -> dict:
        """Storage-format payload for sites [start, start+length), stamped
        with :func:`segment_checksum` (see :func:`decode_segment`)."""
        stop = min(start + length, self.n_sites)
        raws = [self._read_raw(i) for i in range(start, stop)]
        gamma = np.stack([r.view() for r in raws])
        lam = np.stack([r.lam for r in raws])
        return {"start": start, "gamma": gamma, "lam": lam,
                "gshape": raws[0].gshape, "two_byte": raws[0].two_byte,
                "storage_dtype": self.storage_dtype,
                "compute_dtype": self.compute_dtype,
                "crc": np.uint32(segment_checksum(gamma, lam))}

    def close(self):
        self._queue.put(None)
        self._thread.join()

    def __enter__(self) -> "GammaStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
