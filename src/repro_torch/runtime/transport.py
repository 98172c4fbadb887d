"""Persistent worker-process RPC transport for the fleet.

Worker processes stay alive and stream job-batch results back over a
framed pipe protocol, so a worker pays for its interpreter, its CUDA
context and its kernels' loading once and keeps its sessions and engines
warm across every batch it runs (a batch is an independent, restart-exact
unit, so long-lived workers may claim batches in any order).

Layers, bottom up:

* **frames** — length-prefixed messages: an 8-byte big-endian length and
  a 4-byte CRC32 of the body, then the body (a corrupt frame is rejected
  as a lane fault, never parsed).  A request is one JSON frame; a response
  is a JSON header (``{"kind": "result" | "error", ...}``) and, for a
  result, one ``.npy`` frame.  The request is ``repro_torch.api.remote``'s
  v2 job-batch payload.  The result header also carries the worker's
  kernel launches for the batch (``launches``) and its walk's stats.
* :class:`WorkerProcess` — one ``python -m repro_torch.runtime.transport``
  child driven synchronously: ``call(payload)`` writes the request and
  waits (with a deadline) for the result.  The worker caches its sessions
  per (store, config) cell.  It walks on the card unless started with
  ``--device cpu``.
* :class:`WorkerPool` — named workers spawned and reaped on demand (the
  service's fleet lanes), with **chaos injectors**: hooks that delay a
  batch, drop a result, deliver a payload twice or kill a worker, so the
  fault-tolerance claims are exercised.
* :class:`LaneHealth` — respawn backoff and the crash-loop window.

Any transport fault (worker death, dropped result, deadline) raises
:class:`TransportError`; the service treats it as a lane fault: the batch
requeues, the worker respawns, and the recomputation is bit for bit the
same (batch = f(seed, id)).
"""
from __future__ import annotations

import io
import json
import os
import random
import select
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Optional

import numpy as np

#: frame header: 8-byte big-endian body length + 4-byte CRC32 of the body
_HDR = struct.Struct(">QI")
SHUTDOWN = {"kind": "shutdown"}


class TransportError(RuntimeError):
    """A transport fault (worker death, drop, deadline, corrupt frame).
    The batch is not lost: callers requeue it and recompute it."""


class WorkerDied(TransportError):
    """The worker process exited (or was killed) mid-conversation."""


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def write_frame(stream, body: bytes) -> None:
    stream.write(_HDR.pack(len(body), zlib.crc32(body)))
    stream.write(body)
    stream.flush()


def read_frame(stream) -> bytes:
    """Blocking read of one frame; :class:`WorkerDied` on EOF,
    :class:`TransportError` on a checksum mismatch."""
    head = stream.read(_HDR.size)
    if len(head) != _HDR.size:
        raise WorkerDied("stream closed mid-frame")
    n, crc = _HDR.unpack(head)
    parts, got = [], 0
    while got < n:
        chunk = stream.read(n - got)
        if not chunk:
            raise WorkerDied("stream closed mid-frame")
        parts.append(chunk)
        got += len(chunk)
    body = b"".join(parts)
    if zlib.crc32(body) != crc:
        raise TransportError(
            f"frame checksum mismatch ({zlib.crc32(body):#010x} != "
            f"{crc:#010x}) — corrupt frame rejected at decode")
    return body


def write_json(stream, obj: dict) -> None:
    write_frame(stream, json.dumps(obj).encode())


def read_json(stream) -> dict:
    return json.loads(read_frame(stream).decode())


def array_to_frame(arr: np.ndarray) -> bytes:
    bio = io.BytesIO()
    np.save(bio, np.asarray(arr), allow_pickle=False)
    return bio.getvalue()


def array_from_frame(body: bytes) -> np.ndarray:
    return np.load(io.BytesIO(body), allow_pickle=False)


def json_safe(stats: dict) -> dict:
    """A walk's stats as JSON values (arrays become lists)."""
    out = {}
    for k, v in stats.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
        elif isinstance(v, (int, float, str, bool, type(None))):
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# the client side: one persistent worker
# ---------------------------------------------------------------------------

def _src_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def worker_env(env: Optional[dict] = None) -> dict:
    """A worker's environment: ``env`` (default this process's) with the
    port's source tree first on ``PYTHONPATH``."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = _src_root() + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class WorkerProcess:
    """One long-lived ``python -m repro_torch.runtime.transport`` child.

    One call in flight at a time (a lane drives one worker).  ``call``
    enforces ``timeout`` with a select() deadline on the response pipe and
    kills the worker on overrun, so a hung worker cannot wedge its lane.
    ``device`` is passed to the worker as ``--device`` (None: the card).
    ``launches`` sums the kernel launches the worker reported over its
    results; ``last_stats`` is its last walk's stats."""

    def __init__(self, name: str, python: Optional[str] = None,
                 env: Optional[dict] = None, timeout: float = 600.0,
                 device: Optional[str] = None):
        self.name = name
        self.timeout = timeout
        self.batches = 0                  # results streamed back
        self.dispatch_bytes = 0
        self.launches: dict[str, int] = {}
        self.last_launches: dict[str, int] = {}
        self.last_stats: dict = {}
        # stderr goes to a file, never a pipe: a chatty worker must not
        # fill a pipe buffer and block mid-batch; its tail is read on fault
        fd, self._stderr_path = tempfile.mkstemp(
            prefix=f"fastmps_worker_{name}_", suffix=".log")
        cmd = [python or sys.executable, "-m", "repro_torch.runtime.transport"]
        if device is not None:
            cmd += ["--device", str(device)]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                      stdout=subprocess.PIPE, stderr=fd,
                                      env=worker_env(env))
        os.close(fd)

    @property
    def pid(self) -> int:
        return self._proc.pid

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def _drain_stderr(self) -> str:
        try:
            with open(self._stderr_path, "rb") as f:
                return f.read()[-2000:].decode(errors="replace")
        except OSError:
            return ""

    def _read_frame_deadline(self, deadline: float) -> bytes:
        """``read_frame`` with a wall deadline enforced by select()."""
        fd = self._proc.stdout.fileno()
        parts: list[bytes] = []
        got, need = 0, _HDR.size
        body_len = body_crc = None
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the response stream is out of step now (a late frame would
                # be read as the next call's): the worker dies here
                pid = self.pid
                self.kill()
                raise TransportError(
                    f"worker {self.name!r} (pid {pid}) exceeded the "
                    f"{self.timeout}s deadline")
            ready, _, _ = select.select([fd], [], [], min(remaining, 1.0))
            if not ready:
                if not self.alive:
                    raise WorkerDied(
                        f"worker {self.name!r} died (rc="
                        f"{self._proc.returncode}):\n{self._drain_stderr()}")
                continue
            chunk = os.read(fd, min(need - got, 1 << 24))
            if not chunk:
                raise WorkerDied(
                    f"worker {self.name!r} closed its pipe (rc="
                    f"{self._proc.poll()}):\n{self._drain_stderr()}")
            parts.append(chunk)
            got += len(chunk)
            if got < need:
                continue
            buf = b"".join(parts)
            parts, got = [], 0
            if body_len is None:
                body_len, body_crc = _HDR.unpack(buf)
                need = body_len
                if body_len:
                    continue
                buf = b""
            if zlib.crc32(buf) != body_crc:
                raise TransportError(
                    f"worker {self.name!r} sent a corrupt frame "
                    f"(crc {zlib.crc32(buf):#010x} != {body_crc:#010x}) — "
                    f"rejected at decode")
            return buf

    def call(self, payload: dict) -> np.ndarray:
        """Dispatch one job-batch payload; wait for its result."""
        if not self.alive:
            raise WorkerDied(f"worker {self.name!r} is not running (rc="
                             f"{self._proc.returncode})")
        blob = json.dumps({"kind": "batch", "payload": payload}).encode()
        self.dispatch_bytes += len(blob)
        try:
            write_frame(self._proc.stdin, blob)
        except (BrokenPipeError, OSError) as e:
            raise WorkerDied(f"worker {self.name!r} pipe broke on dispatch: "
                             f"{e}\n{self._drain_stderr()}") from None
        deadline = time.monotonic() + self.timeout
        head = json.loads(self._read_frame_deadline(deadline).decode())
        if head.get("kind") == "error":
            # the payload failed on a healthy worker: a job error, not a
            # transport fault
            raise RuntimeError(
                f"worker {self.name!r} batch failed: {head.get('error')}")
        if head.get("kind") != "result":
            raise TransportError(f"worker {self.name!r} sent unknown frame "
                                 f"{head.get('kind')!r}")
        out = array_from_frame(self._read_frame_deadline(deadline))
        self.batches += 1
        self.last_launches = dict(head.get("launches") or {})
        for k, v in self.last_launches.items():
            self.launches[k] = self.launches.get(k, 0) + v
        self.last_stats = dict(head.get("stats") or {})
        return out

    def kill(self) -> None:
        """Hard kill (chaos, deadline): no shutdown handshake."""
        if self.alive:
            self._proc.kill()
        self._close_pipes()
        self._proc.wait(timeout=30)

    def close(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: the handshake, then wait; kill on overrun."""
        if self.alive:
            try:
                write_json(self._proc.stdin, SHUTDOWN)
                self._proc.stdin.close()
                self._proc.wait(timeout=timeout)
            except (BrokenPipeError, OSError, subprocess.TimeoutExpired):
                self._proc.kill()
                self._proc.wait(timeout=30)
        self._close_pipes()

    def _close_pipes(self) -> None:
        for pipe in (self._proc.stdin, self._proc.stdout):
            try:
                if pipe is not None:
                    pipe.close()
            except OSError:
                pass
        try:
            os.unlink(self._stderr_path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# lane health and the pool
# ---------------------------------------------------------------------------

class LaneHealth:
    """Per-lane fault accounting: exponential respawn backoff with jitter,
    and a sliding fault window that turns a crash-looping lane into a
    :class:`~repro_torch.runtime.faults.CrashLoopLane` instead of a hot
    respawn.  Shared by :class:`WorkerPool` and in-process stand-ins."""

    def __init__(self, backoff_base: float = 0.05, backoff_max: float = 2.0,
                 fault_window_s: float = 30.0,
                 max_faults_per_window: int = 5):
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.fault_window_s = fault_window_s
        self.max_faults_per_window = max_faults_per_window
        self._faults: dict[str, list[float]] = {}
        self._streak: dict[str, int] = {}     # consecutive respawns per lane
        self.backoff_seconds = 0.0            # total backoff slept

    def record_fault(self, name: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._faults.setdefault(name, []).append(now)

    def record_success(self, name: str) -> None:
        self._streak.pop(name, None)

    def forgive(self, name: str) -> None:
        """Clear a lane's window and streak (on quarantine: the cooldown
        is the penalty, and the readmitted lane starts clean)."""
        self._faults.pop(name, None)
        self._streak.pop(name, None)

    def window_faults(self, name: str, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        kept = [t for t in self._faults.get(name, ())
                if now - t <= self.fault_window_s]
        if kept:
            self._faults[name] = kept
        else:
            self._faults.pop(name, None)
        return len(kept)

    def check_respawn(self, name: str, now: Optional[float] = None) -> float:
        """Gate one respawn of ``name``: raises ``CrashLoopLane`` when the
        lane's window is full, else returns the delay to sleep first
        (exponential in the respawn streak, ±50 % jitter)."""
        from repro_torch.runtime.faults import CrashLoopLane, Fault
        n_window = self.window_faults(name, now)
        if n_window >= self.max_faults_per_window:
            raise CrashLoopLane(Fault(
                kind="transport", lane=name,
                message=f"lane {name!r} crash-looping: {n_window} faults "
                        f"inside {self.fault_window_s}s — quarantine it "
                        f"(cooldown readmit) instead of respawning hot"))
        streak = self._streak.get(name, 0)
        self._streak[name] = streak + 1
        if streak == 0:
            return 0.0
        delay = min(self.backoff_base * (2 ** (streak - 1)), self.backoff_max)
        delay *= 0.5 + random.random()
        self.backoff_seconds += delay
        return delay

    def stats(self) -> dict:
        now = time.monotonic()
        return {"lane_window_faults": {n: self.window_faults(n, now)
                                       for n in sorted(self._faults)},
                "backoff_seconds": self.backoff_seconds}


class WorkerPool:
    """Named persistent workers, spawned and reaped on demand.

    The service's fleet lanes map one to one onto pool workers.
    ``injectors`` is the chaos seam: each may implement ``before(worker,
    payload) -> None | "drop" | "duplicate"`` and ``after(worker, payload,
    result) -> None | "drop"``: a sleep inside models a delay, ``"drop"``
    raises :class:`TransportError` (before: without running; after:
    discarding a computed result), ``"duplicate"`` delivers the payload
    twice and checks both results agree bit for bit.  ``device`` is passed
    to every worker (None: the card).  ``observer`` is the telemetry seam:
    ``observer(event, ...)`` for ``transport_{spawn,reap,fault,dispatch,
    result}``, its errors swallowed."""

    def __init__(self, python: Optional[str] = None,
                 env: Optional[dict] = None, timeout: float = 600.0,
                 observer=None, health: Optional[LaneHealth] = None,
                 device: Optional[str] = None):
        self.python = python
        self.env = env
        self.timeout = timeout
        self.device = device
        self.workers: dict[str, WorkerProcess] = {}
        self.injectors: list = []
        self.spawned = 0
        self.reaped = 0
        self.faults = 0               # TransportErrors surfaced to callers
        self.health = LaneHealth() if health is None else health
        self.observer = observer

    def _emit(self, event: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(event, **fields)
            except Exception:          # noqa: BLE001 — see docstring
                pass

    def spawn(self, name: str) -> WorkerProcess:
        if name in self.workers and self.workers[name].alive:
            raise ValueError(f"worker {name!r} already running")
        w = WorkerProcess(name, python=self.python, env=self.env,
                          timeout=self.timeout, device=self.device)
        self.workers[name] = w
        self.spawned += 1
        self._emit("transport_spawn", worker=name)
        return w

    def reap(self, name: str, kill: bool = False) -> None:
        w = self.workers.pop(name, None)
        if w is None:
            return
        (w.kill if kill else w.close)()
        self.reaped += 1
        self._emit("transport_reap", worker=name)

    def respawn(self, name: str) -> WorkerProcess:
        """Replace a dead or hung worker under its lane name, gated by
        :class:`LaneHealth` (backoff; ``CrashLoopLane`` when the lane's
        window is full)."""
        delay = self.health.check_respawn(name)
        if delay > 0:
            time.sleep(delay)
        self.reap(name, kill=True)
        return self.spawn(name)

    def call(self, name: str, payload: dict) -> np.ndarray:
        w = self.workers.get(name)
        if w is None:
            raise WorkerDied(f"no worker {name!r} in the pool")
        try:
            actions = [inj.before(name, payload) for inj in self.injectors
                       if hasattr(inj, "before")]
            if "drop" in actions:
                raise TransportError(
                    f"payload to {name!r} dropped by injector")
            self._emit("transport_dispatch", worker=name,
                       nbytes=len(json.dumps(payload)))
            out = w.call(payload)
            if "duplicate" in actions:
                again = w.call(payload)
                if not np.array_equal(out, again):
                    raise TransportError(
                        f"worker {name!r} is not idempotent: duplicate "
                        f"delivery produced different bits")
            for inj in self.injectors:
                if hasattr(inj, "after"):
                    if inj.after(name, payload, out) == "drop":
                        raise TransportError(
                            f"result from {name!r} dropped by injector")
            self._emit("transport_result", worker=name, nbytes=out.nbytes)
            self.health.record_success(name)
            return out
        except TransportError:
            self.faults += 1
            self.health.record_fault(name)
            self._emit("transport_fault", worker=name)
            raise

    def stats(self) -> dict:
        out = {"workers": len(self.workers),
               "spawned": self.spawned, "reaped": self.reaped,
               "faults": self.faults,
               "batches": {n: w.batches for n, w in self.workers.items()},
               "dispatch_bytes": sum(w.dispatch_bytes
                                     for w in self.workers.values())}
        out.update(self.health.stats())
        return out

    def close(self) -> None:
        for name in list(self.workers):
            self.reap(name)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# the worker side (``python -m repro_torch.runtime.transport``)
# ---------------------------------------------------------------------------

def serve(stdin, stdout, device: Optional[str] = None) -> int:
    """The worker loop: frames in, results out, until shutdown or EOF.
    Sessions are cached per (store, config) cell across batches."""
    from repro_torch.api.remote import execute_payload_with_stats
    from repro_torch.kernels import ops

    cache: dict = {}
    try:
        while True:
            try:
                msg = read_json(stdin)
            except WorkerDied:            # the parent went away
                return 0
            kind = msg.get("kind")
            if kind == "shutdown":
                return 0
            if kind != "batch":
                write_json(stdout, {"kind": "error",
                                    "error": f"unknown frame {kind!r}"})
                continue
            before = ops.launch_counts()
            try:
                out, stats = execute_payload_with_stats(
                    msg["payload"], cache=cache, device=device)
            except BaseException as e:    # noqa: BLE001 — sent to the caller
                write_json(stdout, {"kind": "error",
                                    "error": f"{type(e).__name__}: {e}"})
                continue
            launches = {k: v - before.get(k, 0)
                        for k, v in ops.launch_counts().items()
                        if v - before.get(k, 0)}
            write_json(stdout, {"kind": "result", "launches": launches,
                                "stats": json_safe(stats)})
            write_frame(stdout, array_to_frame(out))
    finally:
        for sess in cache.values():
            try:
                sess.close()
            except Exception:             # noqa: BLE001 — shutdown path
                pass


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="A fleet worker process.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU the first "
                         "call fails")
    args = ap.parse_args(argv)
    # claim the protocol stream before anything can print: the real stdout
    # becomes the frames' alone, and fd 1 (and sys.stdout) is pointed at
    # stderr, so a stray print can never corrupt a frame
    protocol_out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    return serve(sys.stdin.buffer, protocol_out, device=args.device)


if __name__ == "__main__":
    sys.exit(_main())
