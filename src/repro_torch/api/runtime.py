"""`ClusterRuntime` — where the processes live and how bytes move.

Execution has two orthogonal axes:

* the **data plane** (``repro_torch.api.backends``): how a resolved
  :class:`SessionPlan` walks the chain — in memory or segment-streamed;
* the **runtime** (this module): where the participating processes live
  and how host bytes move between them — ``local`` (one process, the
  collectives are no-ops), ``multihost`` (the paper's §3.1: process 0
  reads each Γ segment once and broadcasts it), ``remote`` (a serialized
  config dispatched to a worker process, ``repro_torch.api.remote``).

Every runtime implements one small protocol::

    runtime.process_index / runtime.process_count / runtime.is_root
    runtime.mesh(model_parallel)       # the ("data", "model") device mesh
    runtime.broadcast_segment(payload) # root sends, everyone returns it
    runtime.barrier()                  # line the processes up
    runtime.allreduce_min(value)       # the resume agreement
    runtime.send(dst, payload, tag) / runtime.recv(src, tag)
    runtime.observe_handoff(src, tag)  # a bystander of a handoff
    runtime.allgather_payloads(payload)
    runtime.io_counters()              # interconnect / dispatch bytes
    runtime.submit(payload)            # remote dispatch (see remote.py)

so ``streamed × multihost`` is a config cell,
``SamplerConfig(backend="streamed", runtime="multihost")``.

The wire format of :meth:`broadcast_segment` is the Γ store's *storage
format* (bf16 Γ stays two bytes on the wire), and every process, the root
included, checks it and moves it to its device through
``gamma_store.payload_on_device``, so a multi-process walk gives the
single-process samples bit for bit.

Two multi-process transports:

* :func:`emulated_cluster` — N :class:`MultiHostRuntime` members wired
  through an in-process interconnect (one thread per member), the same
  engine code a real launch runs;
* ``runtime="multihost"`` — :class:`TorchMultiHostRuntime`, one member per
  ``torch.distributed`` rank over a **gloo** group of its own: the Γ bytes
  arrive in host memory, and NCCL cannot put two ranks on one card.  The
  variable-size payload crosses in two rounds, its length and then its
  npz-framed bytes as a uint8 tensor, as the JAX package's
  ``JaxMultiHostRuntime`` sends them.

The sharded data plane (``repro_torch.shard``) adds point-to-point
traffic: :meth:`ClusterRuntime.send`/:meth:`~ClusterRuntime.recv` of a
dict of host arrays (the env handoff and the peer repair, tagged by
boundary site or by ``("repair", site)``), and
:meth:`~ClusterRuntime.allgather_payloads` (the sample-block gather).  On
the emulated fabric they run on queues of their own; on gloo they are true
``dist.send``/``dist.recv`` (so :meth:`~ClusterRuntime.observe_handoff`,
the bystander's hook for a transport built on broadcasts, does nothing).
"""
from __future__ import annotations

import contextlib
import io
import json
import queue as queue_mod
import threading
from typing import Callable, Optional

import numpy as np
import torch

AUTO = "auto"

_RUNTIME_REGISTRY: dict[str, Callable[[], "ClusterRuntime"]] = {}


def register_runtime(name: str):
    """Decorator: register a zero-argument runtime factory under
    ``name``."""
    def deco(factory):
        _RUNTIME_REGISTRY[name] = factory
        return factory
    return deco


def available_runtimes() -> list[str]:
    return sorted(_RUNTIME_REGISTRY)


def get_runtime(name: str) -> "ClusterRuntime":
    try:
        factory = _RUNTIME_REGISTRY[name]
    except KeyError:
        raise ValueError(f"no runtime {name!r} registered; "
                         f"have {available_runtimes()}") from None
    return factory()


def resolve_runtime(spec) -> "ClusterRuntime":
    """AUTO → local; a name → the registry; an instance → itself (tests
    and emulated deployments pass instances, configs on disk names)."""
    if spec is None or spec == AUTO:
        return get_runtime("local")
    if isinstance(spec, ClusterRuntime):
        return spec
    if isinstance(spec, str):
        return get_runtime(spec)
    raise TypeError(f"runtime must be a name, a ClusterRuntime instance, or "
                    f"AUTO — got {type(spec).__name__}")


def dtype_name(dt) -> str:
    """A torch or numpy dtype (or its name) → the name both packages use
    on the wire (``bfloat16``, ``float64``, ``complex128``, ...)."""
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    if isinstance(dt, str):
        return dt
    return np.dtype(dt).name


def dtype_from_name(name: str) -> torch.dtype:
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def _payload_nbytes(payload) -> int:
    if payload is None:
        return 0
    return sum(int(v.nbytes) for v in payload.values()
               if isinstance(v, np.ndarray))


def _frame(bio: io.BytesIO) -> np.ndarray:
    """The bytes written to ``bio`` as a writable uint8 array (a view of
    the buffer, no copy)."""
    return np.frombuffer(bio.getbuffer(), dtype=np.uint8)


def payload_to_bytes(payload: dict) -> np.ndarray:
    """A segment payload → one flat uint8 buffer (npz framing).

    The Γ bytes stay in storage format; dtypes ride as names; the store's
    segment checksum (``crc``) rides along, so a corrupt wire buffer is
    rejected when it is decoded.  A root-side read fault crosses the wire
    too (every process must fail the same round rather than wait in a
    collective): a payload with an ``error`` string (and an optional
    ``fault`` dict) becomes a small error frame."""
    bio = io.BytesIO()
    if payload.get("error") is not None:
        np.savez(bio,
                 error=np.frombuffer(str(payload["error"]).encode(),
                                     dtype=np.uint8),
                 fault=np.frombuffer(
                     json.dumps(payload.get("fault") or {}).encode(),
                     dtype=np.uint8),
                 start=np.asarray(int(payload.get("start", -1)),
                                  dtype=np.int64))
        return _frame(bio)
    crc = payload.get("crc")
    np.savez(bio, gamma=payload["gamma"], lam=payload["lam"],
             gshape=np.asarray(payload["gshape"], dtype=np.int64),
             two_byte=np.asarray(bool(payload["two_byte"])),
             start=np.asarray(int(payload["start"]), dtype=np.int64),
             storage_dtype=np.asarray(dtype_name(payload["storage_dtype"])),
             compute_dtype=np.asarray(dtype_name(payload["compute_dtype"])),
             crc=np.asarray(-1 if crc is None else int(crc), dtype=np.int64))
    return _frame(bio)


def payload_from_bytes(buf) -> dict:
    """Inverse of :func:`payload_to_bytes` (dtypes come back as torch
    dtypes)."""
    with np.load(io.BytesIO(np.asarray(buf, dtype=np.uint8).tobytes())) as z:
        if "error" in z.files:
            return {"error": z["error"].tobytes().decode(),
                    "fault": json.loads(z["fault"].tobytes().decode()),
                    "start": int(z["start"])}
        crc = int(z["crc"]) if "crc" in z.files else -1
        return {"gamma": z["gamma"], "lam": z["lam"],
                "gshape": tuple(int(x) for x in z["gshape"]),
                "two_byte": bool(z["two_byte"]),
                "start": int(z["start"]),
                "storage_dtype": dtype_from_name(str(z["storage_dtype"])),
                "compute_dtype": dtype_from_name(str(z["compute_dtype"])),
                "crc": None if crc < 0 else crc}


def dict_to_bytes(payload: dict) -> np.ndarray:
    """A dict of arrays → one flat uint8 buffer (npz framing), for the
    two-round collective transports (length, then bytes)."""
    bio = io.BytesIO()
    np.savez(bio, **{k: np.asarray(v) for k, v in payload.items()})
    return _frame(bio)


def dict_from_bytes(buf) -> dict:
    """Inverse of :func:`dict_to_bytes`."""
    with np.load(io.BytesIO(np.asarray(buf, dtype=np.uint8).tobytes())) as z:
        return {k: z[k] for k in z.files}


class ClusterRuntime:
    """Where the processes live and how bytes move between them."""
    name = "abstract"

    # -- topology -------------------------------------------------------------
    @property
    def process_index(self) -> int:
        return 0

    @property
    def process_count(self) -> int:
        return 1

    @property
    def is_root(self) -> bool:
        return self.process_index == 0

    def mesh(self, model_parallel: int = 1, device=None):
        """The ("data", "model") mesh over every rank of the job
        (``launch.mesh.make_host_mesh``)."""
        from repro_torch.launch.mesh import make_host_mesh
        return make_host_mesh(model=model_parallel, device=device)

    # -- collectives (host side, one segment at a time) ----------------------
    def broadcast_segment(self, payload: Optional[dict], root: int = 0
                          ) -> dict:
        """The root sends ``payload`` (host arrays and metadata) to every
        process; every caller, the root included, returns it.  With one
        process it passes through."""
        if payload is None:
            raise ValueError(f"runtime {self.name!r} has one process — "
                             f"broadcast_segment needs the payload on it")
        return payload

    def barrier(self) -> None:
        """Line the processes up (nothing to wait for with one)."""

    def allreduce_min(self, value: int) -> int:
        """The minimum of one int per process (the resume agreement)."""
        return int(value)

    # -- point-to-point (the sharded plane, repro_torch.shard) ---------------
    def send(self, dst: int, payload: dict, tag=None) -> None:
        """Ship a dict of host arrays to process ``dst`` (the env handoff);
        ``tag`` tells streams between one pair apart (the walk tags by
        boundary site)."""
        raise NotImplementedError(f"runtime {self.name!r} has no "
                                  f"point-to-point transport")

    def recv(self, src: int, tag=None) -> dict:
        """Blocking receive of the matching :meth:`send` from ``src``."""
        raise NotImplementedError(f"runtime {self.name!r} has no "
                                  f"point-to-point transport")

    def observe_handoff(self, src: int, tag=None) -> None:
        """Called by every process that is neither end of a handoff: a
        transport built on broadcasts needs every process in every
        transfer; a true point-to-point one does nothing."""

    def allgather_payloads(self, payload: dict) -> list[dict]:
        """Every process gives one dict of arrays and gets all of them, in
        rank order (the sharded walk's sample-block gather)."""
        return [payload]

    def compute_lock(self):
        """Held around one segment's device work: a no-op except on the
        emulated cluster, whose members share one process and one card and
        walk their segments one at a time (the broadcasts still overlap
        the walks)."""
        return contextlib.nullcontext()

    # -- counters -------------------------------------------------------------
    def io_counters(self) -> dict:
        """Monotonic counters of what this runtime moved between processes
        or dispatched to a worker; engines report per-walk deltas."""
        return {"broadcast_send_bytes": 0, "broadcast_recv_bytes": 0,
                "broadcast_segments": 0, "broadcast_s": 0.0,
                "dispatch_bytes": 0, "p2p_send_bytes": 0,
                "p2p_recv_bytes": 0, "p2p_msgs": 0}

    # -- remote dispatch ------------------------------------------------------
    def submit(self, payload: dict, device=None) -> np.ndarray:
        """Execute one serialized sampling request (``repro_torch.api.
        remote``'s payload) wherever this runtime's workers live;
        ``device`` is the submitting session's."""
        raise NotImplementedError(f"runtime {self.name!r} has no dispatch "
                                  f"transport")

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        """Release transport state (worker processes, groups).  Sessions
        close the runtimes they resolved from a name; an instance passed
        in stays the caller's."""


@register_runtime("local")
class LocalRuntime(ClusterRuntime):
    """One process; the collectives do nothing.  ``submit`` runs the
    serialized request in this process (the loopback transport), so the
    dispatch path is exercised without any worker."""
    name = "local"

    def __init__(self):
        self._dispatch_bytes = 0
        self._dispatches = 0

    def io_counters(self) -> dict:
        out = super().io_counters()
        out.update(dispatch_bytes=self._dispatch_bytes,
                   dispatches=self._dispatches)
        return out

    def submit(self, payload: dict, device=None) -> np.ndarray:
        from repro_torch.api.remote import execute_payload
        self._dispatch_bytes += len(json.dumps(payload).encode())
        self._dispatches += 1
        return execute_payload(payload, device=device)


class _Interconnect:
    """The in-process stand-in for a cluster's fabric: one queue per
    member and a shared barrier.  The queues are unbounded, so the root
    may run ahead of slow receivers (each engine still holds at most two
    segments on its device)."""

    def __init__(self, n_processes: int, timeout: float = 120.0):
        self.n = n_processes
        self.timeout = timeout
        self.queues = [queue_mod.Queue() for _ in range(n_processes)]
        # point-to-point traffic has queues of its own: a handoff must not
        # dequeue a broadcast segment another plan left in flight
        self.p2p_queues = [queue_mod.Queue() for _ in range(n_processes)]
        self.barrier = threading.Barrier(n_processes)
        # allreduce scratch: each member writes its own slot before the
        # first barrier and reads between the two, so rounds never clear it
        self.reduce_slots = [0] * n_processes
        # the members share one card: their segment walks take turns
        self.compute = threading.Lock()

    def send(self, dst: int, msg) -> None:
        self.queues[dst].put(msg)

    def recv(self, dst: int):
        try:
            return self.queues[dst].get(timeout=self.timeout)
        except queue_mod.Empty:
            raise TimeoutError(
                f"process {dst} waited >{self.timeout}s for a broadcast — "
                f"is the root walking the same segment schedule?") from None

    def send_p2p(self, dst: int, msg) -> None:
        self.p2p_queues[dst].put(msg)

    def recv_p2p(self, dst: int):
        try:
            return self.p2p_queues[dst].get(timeout=self.timeout)
        except queue_mod.Empty:
            raise TimeoutError(
                f"process {dst} waited >{self.timeout}s for a point-to-point "
                f"payload — is the predecessor owner still walking?") from None


class MultiHostRuntime(ClusterRuntime):
    """Paper §3.1: process 0 reads each Γ segment once and broadcasts it.

    One instance per process.  :func:`emulated_cluster` wires N of them
    through an in-process :class:`_Interconnect`;
    :class:`TorchMultiHostRuntime` runs the same protocol over a
    ``torch.distributed`` gloo group."""
    name = "multihost"

    def __init__(self, process_index: int, process_count: int,
                 fabric: Optional[_Interconnect]):
        self._index = process_index
        self._count = process_count
        self._fabric = fabric
        self._send_bytes = 0
        self._recv_bytes = 0
        self._segments = 0
        self._bcast_s = 0.0
        self._p2p_send = 0
        self._p2p_recv = 0
        self._p2p_msgs = 0
        # messages that arrived while waiting for another (src, tag)
        self._p2p_buf: dict = {}

    @property
    def process_index(self) -> int:
        return self._index

    @property
    def process_count(self) -> int:
        return self._count

    def _check_root(self, payload, root: int) -> None:
        if self._index == root and payload is None:
            raise ValueError("the root process must supply the payload")
        if self._index != root and payload is not None:
            raise ValueError(
                f"process {self._index} is not the broadcast root ({root}) "
                f"but supplied a payload — only the root may touch the "
                f"GammaStore")

    def broadcast_segment(self, payload: Optional[dict], root: int = 0
                          ) -> dict:
        import time
        self._check_root(payload, root)
        t0 = time.perf_counter()
        if self._index == root:
            for dst in range(self._count):
                if dst != root:
                    self._fabric.send(dst, payload)
            self._send_bytes += _payload_nbytes(payload) * (self._count - 1)
        else:
            payload = self._fabric.recv(self._index)
            self._recv_bytes += _payload_nbytes(payload)
        self._bcast_s += time.perf_counter() - t0
        self._segments += 1
        return payload

    def barrier(self) -> None:
        self._fabric.barrier.wait(timeout=self._fabric.timeout)

    def allreduce_min(self, value: int) -> int:
        f = self._fabric
        f.reduce_slots[self._index] = int(value)
        f.barrier.wait(timeout=f.timeout)
        out = min(f.reduce_slots)
        f.barrier.wait(timeout=f.timeout)
        return out

    # -- point-to-point (the sharded plane) ----------------------------------
    def _check_dst(self, dst: int) -> None:
        if not 0 <= dst < self._count:
            raise ValueError(f"send dst {dst} outside [0, {self._count})")
        if dst == self._index:
            raise ValueError(f"process {self._index} sending to itself — "
                             f"an owner handoff never loops back")

    def send(self, dst: int, payload: dict, tag=None) -> None:
        self._check_dst(dst)
        self._fabric.send_p2p(dst, (self._index, tag, payload))
        self._p2p_send += _payload_nbytes(payload)
        self._p2p_msgs += 1

    def recv(self, src: int, tag=None) -> dict:
        want, buf = (src, tag), self._p2p_buf
        while not buf.get(want):
            s, t, payload = self._fabric.recv_p2p(self._index)
            # counted on arrival, buffered or not
            self._p2p_recv += _payload_nbytes(payload)
            self._p2p_msgs += 1
            buf.setdefault((s, t), []).append(payload)
        return buf[want].pop(0)

    def allgather_payloads(self, payload: dict) -> list[dict]:
        # rank-ordered rounds; a send never blocks (unbounded queues), so
        # each process sends in its own round and receives in the others'
        out = []
        for r in range(self._count):
            if r == self._index:
                for dst in range(self._count):
                    if dst != self._index:
                        self.send(dst, payload, tag=("allgather", r))
                out.append(payload)
            else:
                out.append(self.recv(r, tag=("allgather", r)))
        return out

    def compute_lock(self):
        if self._fabric is not None:
            return self._fabric.compute
        return contextlib.nullcontext()

    def io_counters(self) -> dict:
        out = super().io_counters()
        out.update(broadcast_send_bytes=self._send_bytes,
                   broadcast_recv_bytes=self._recv_bytes,
                   broadcast_segments=self._segments,
                   broadcast_s=self._bcast_s,
                   p2p_send_bytes=self._p2p_send,
                   p2p_recv_bytes=self._p2p_recv,
                   p2p_msgs=self._p2p_msgs)
        return out


def emulated_cluster(n_processes: int, timeout: float = 120.0
                     ) -> list[MultiHostRuntime]:
    """N multihost runtimes on one in-process interconnect.  Drive one
    session or engine per member, each in its own thread: the root alone
    reads the store and every member returns the same samples."""
    if n_processes < 2:
        raise ValueError(f"an emulated cluster needs ≥ 2 processes, got "
                         f"{n_processes}")
    fabric = _Interconnect(n_processes, timeout=timeout)
    return [MultiHostRuntime(i, n_processes, fabric)
            for i in range(n_processes)]


class TorchMultiHostRuntime(MultiHostRuntime):
    """The broadcast over a ``torch.distributed`` job, one instance per
    rank (``dist.init_process_group`` already called, world ≥ 2).

    It makes two gloo groups of its own (every rank constructs the runtime
    in the same order), one for each thread that issues its collectives:
    the streamed engine broadcasts segments on its prefetch thread, while
    :meth:`barrier` and :meth:`allreduce_min` run on the walk thread, and a
    gang-scheduled fetch of the next macro batch's first segment may still
    be broadcasting when the walk reaches its barrier.  Gloo matches a
    group's collectives by the order each rank issues them, so two threads
    must never share one group (nor the default group, where the walk may
    run collectives of its own).  A segment crosses in two rounds, a (1,)
    int64 length and then the npz-framed bytes (:func:`payload_to_bytes`)
    as a uint8 tensor.

    The sharded plane's traffic runs on the walk thread, so on
    ``_sync_group``: :meth:`send`/:meth:`recv` are gloo's true
    ``dist.send``/``dist.recv`` (a (1,) int64 length, then the
    :func:`dict_to_bytes` bytes, both under the message's int tag,
    :func:`wire_tag`), and :meth:`allgather_payloads` two all-gathers
    (the lengths, then the bytes padded to the longest).  Gloo pairs a
    send with its receive, so between two ranks messages are received in
    the order they were sent (the walk and the repair round keep that
    order; the emulated fabric also buffers messages that come early)."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() < 2:
            raise ValueError(
                "runtime='multihost' needs a torch.distributed job with ≥ 2 "
                "processes (world size "
                f"{dist.get_world_size() if dist.is_initialized() else 0}); "
                "for one machine pass an emulated_cluster(n) member as "
                "SamplerConfig(runtime=<instance>)")
        super().__init__(dist.get_rank(), dist.get_world_size(), fabric=None)
        self._group = dist.new_group(backend="gloo")     # prefetch thread
        self._sync_group = dist.new_group(backend="gloo")  # walk thread

    def _bcast_bytes(self, blob: Optional[np.ndarray], src: int
                     ) -> np.ndarray:
        """Round 1 the length, round 2 the bytes, from rank ``src``."""
        import torch.distributed as dist

        mine = self._index == src
        length = torch.tensor([blob.size if mine else 0], dtype=torch.int64)
        dist.broadcast(length, src=src, group=self._group)
        buf = (torch.from_numpy(blob) if mine else
               torch.empty(int(length[0]), dtype=torch.uint8))
        dist.broadcast(buf, src=src, group=self._group)
        return buf.numpy()

    def broadcast_segment(self, payload: Optional[dict], root: int = 0
                          ) -> dict:
        import time
        self._check_root(payload, root)
        t0 = time.perf_counter()
        if self._index == root:
            blob = self._bcast_bytes(payload_to_bytes(payload), root)
            self._send_bytes += int(blob.size) * (self._count - 1)
        else:
            blob = self._bcast_bytes(None, root)
            payload = payload_from_bytes(blob)
            self._recv_bytes += int(blob.size)
        self._bcast_s += time.perf_counter() - t0
        self._segments += 1
        return payload

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self._sync_group)

    def send(self, dst: int, payload: dict, tag=None) -> None:
        import torch.distributed as dist
        self._check_dst(dst)
        blob = torch.from_numpy(dict_to_bytes(payload))
        t = wire_tag(tag)
        dist.send(torch.tensor([blob.numel()], dtype=torch.int64), dst=dst,
                  group=self._sync_group, tag=t)
        dist.send(blob, dst=dst, group=self._sync_group, tag=t)
        self._p2p_send += _payload_nbytes(payload)
        self._p2p_msgs += 1

    def recv(self, src: int, tag=None) -> dict:
        import torch.distributed as dist
        t = wire_tag(tag)
        length = torch.zeros(1, dtype=torch.int64)
        dist.recv(length, src=src, group=self._sync_group, tag=t)
        blob = torch.empty(int(length[0]), dtype=torch.uint8)
        dist.recv(blob, src=src, group=self._sync_group, tag=t)
        payload = dict_from_bytes(blob.numpy())
        self._p2p_recv += _payload_nbytes(payload)
        self._p2p_msgs += 1
        return payload

    def allgather_payloads(self, payload: dict) -> list[dict]:
        import torch.distributed as dist
        blob = torch.from_numpy(dict_to_bytes(payload))
        lengths = [torch.zeros(1, dtype=torch.int64)
                   for _ in range(self._count)]
        dist.all_gather(lengths, torch.tensor([blob.numel()],
                                              dtype=torch.int64),
                        group=self._sync_group)
        size = max(int(n[0]) for n in lengths)
        mine = torch.zeros(size, dtype=torch.uint8)
        mine[:blob.numel()] = blob
        bufs = [torch.empty(size, dtype=torch.uint8)
                for _ in range(self._count)]
        dist.all_gather(bufs, mine, group=self._sync_group)
        out = [payload if r == self._index else
               dict_from_bytes(bufs[r][:int(lengths[r][0])].numpy())
               for r in range(self._count)]
        n_in = sum(_payload_nbytes(p) for r, p in enumerate(out)
                   if r != self._index)
        self._p2p_send += _payload_nbytes(payload) * (self._count - 1)
        self._p2p_recv += n_in
        self._p2p_msgs += 2 * (self._count - 1)
        return out

    def allreduce_min(self, value: int) -> int:
        import torch.distributed as dist
        t = torch.tensor([int(value)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._sync_group)
        return int(t[0])

    def compute_lock(self):
        return contextlib.nullcontext()

    def close(self) -> None:
        import torch.distributed as dist
        if self._group is not None and dist.is_initialized():
            dist.destroy_process_group(self._group)
            dist.destroy_process_group(self._sync_group)
        self._group = self._sync_group = None


_TAG_SPACE = 1 << 27     # boundary sites; each tuple kind has a range above


def wire_tag(tag) -> int:
    """A message tag as gloo's int: None → 0, a boundary site → itself,
    ``("repair", site)`` and ``("allgather", rank)`` → disjoint ranges
    above every site."""
    if tag is None:
        return 0
    if isinstance(tag, (int, np.integer)):
        if not 0 <= int(tag) < _TAG_SPACE:
            raise ValueError(f"tag {tag} outside [0, {_TAG_SPACE})")
        return int(tag)
    kinds = {"repair": 1, "allgather": 2}
    if (isinstance(tag, tuple) and len(tag) == 2 and tag[0] in kinds
            and 0 <= int(tag[1]) < _TAG_SPACE):
        return kinds[tag[0]] * _TAG_SPACE + int(tag[1])
    raise ValueError(f"tag {tag!r} has no wire form (an int site, or "
                     f"('repair' | 'allgather', int))")


@register_runtime("multihost")
def torch_multihost_runtime() -> MultiHostRuntime:
    """The real multi-process entry: a ``torch.distributed`` job of ≥ 2
    ranks, each of which resolves ``runtime="multihost"``."""
    return TorchMultiHostRuntime()


__all__ = [
    "AUTO", "ClusterRuntime", "LocalRuntime", "MultiHostRuntime",
    "TorchMultiHostRuntime", "available_runtimes", "dict_from_bytes",
    "dict_to_bytes", "dtype_from_name", "dtype_name", "emulated_cluster",
    "get_runtime", "payload_from_bytes", "payload_to_bytes",
    "register_runtime", "resolve_runtime", "wire_tag",
]
