"""Per-device cost counter of the dry run: the port's counterpart of the JAX
package's ``launch/hloanalysis.py``.

The JAX dry run lowers a jitted step, parses the per-device HLO text and
recovers each ``while`` loop's trip count, because ``cost_analysis()``
visits a loop body once.  Torch emits no HLO, so there is no text to parse
and no trip count to recover: the port's models and its sampler loop over
layers and sites in Python.  The dry run instead runs the step once on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage) as rank 0 of a
fake process group, under :class:`CostCounter`, a ``TorchDispatchMode``
that sees every aten op and every ``c10d`` collective the rank issues,
every site included.  Per device it counts

  * dot FLOPs: 2 · |result| · Π contracting dims (×4 for complex operands)
    over ``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``mv`` and ``dot`` (what
    ``einsum`` and ``matmul`` decompose to);
  * collective wire bytes, with the JAX package's ring formulas
    (:func:`_wire_bytes`; b = result bytes, g = group size):
        all-reduce 2·b·(g−1)/g, all-gather b·(g−1)/g (b = the gathered
        result), reduce-scatter b·(g−1) (b = the scattered shard),
        all-to-all b·(g−1)/g, collective-permute (a send) b;
    a receive is its sender's permute and adds no wire of its own;
  * a memory-traffic proxy: the result bytes of every op that
    materialises a tensor (a view or an allocation moves nothing; an
    in-place op writes its target; a collective writes its output), plus
    the dot operands' reads.  Like the JAX package's, it is a proxy: the
    card's true traffic depends on what the kernels fuse and cache;
  * live bytes, the stand-in for XLA's ``memory_analysis()``: arguments,
    outputs, temporaries and the peak of live fake storage (tracked with
    weak references on storages); nothing is aliased.

Only fake tensors are counted: a real tensor under the mode is host-side
(the PRNG keys, ``core/prng.py``).  The JAX package's ``upcast_bytes`` and
its ``t_memory_tpu_adj_s`` are left out: they remove a TPU/XLA-CPU lowering
artefact (whole-array bf16 → fp32 converts) and carry a TPU figure.

The roofline constants are those of one NVIDIA H100 80GB HBM3 (SXM) at its
700 W power limit, from NVIDIA's data sheet (dense rates).
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 80GB HBM3 (SXM) at 700 W, data sheet, dense
DEVICE_NAME = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700
PEAK_FLOPS = 989e12          # bf16 tensor cores
PEAK_FP64_FLOPS = 67e12      # fp64 tensor cores
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # NVLink 4 bytes/s each way, inside one node
NETWORK_BW = 50e9            # one 400 Gb/s InfiniBand NIC a GPU, across nodes
GPUS_PER_NODE = 8            # ranks lie row-major, 8 to a node

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
_DOTS = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
# c10d op → its kind; its first argument is the tensor (list) it writes
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce",
    "_allgather_base_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "recv",
}
# ops that allocate or relabel and write nothing
_NO_TRAFFIC = {"empty", "empty_strided", "new_empty", "new_empty_strided",
               "empty_like", "detach", "alias", "lift_fresh",
               "_local_scalar_dense"}


def _wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-device ring-algorithm wire bytes (the JAX package's formulas)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (g - 1) / g
    if kind == "all-gather":
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(result_bytes) * (g - 1)
    if kind == "all-to-all":
        return result_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _dot_flops(func, args, out: torch.Tensor) -> float:
    a = args[1] if func in (_aten.addmm.default,
                            _aten.baddbmm.default) else args[0]
    flops = 2.0 * out.numel() * a.shape[-1]
    return 4.0 * flops if a.is_complex() else flops


@dataclasses.dataclass
class Collective:
    kind: str
    result_bytes: int
    group_size: int
    link: str                  # "nvlink" (one node) | "network"
    wire_bytes: float


@dataclasses.dataclass
class Cost:
    """The per-device counts of one run (the fields of the JAX package's
    ``HLOCost``, less ``upcast_bytes``, plus the live bytes)."""
    flops: float = 0.0
    memory_bytes: float = 0.0            # traffic proxy
    collective_wire_bytes: float = 0.0   # ring model
    collective_raw_bytes: float = 0.0    # Σ result sizes
    per_collective: dict = dataclasses.field(default_factory=dict)
    n_collectives: dict = dataclasses.field(default_factory=dict)
    wire_bytes_by_link: dict = dataclasses.field(
        default_factory=lambda: {"nvlink": 0.0, "network": 0.0})
    collectives: list = dataclasses.field(default_factory=list)
    arguments: int = 0
    outputs: int = 0
    peak_live: int = 0

    @property
    def temps(self) -> int:
        return max(0, self.peak_live - self.arguments - self.outputs)

    def bytes_per_device(self) -> dict:
        return {"arguments": self.arguments, "outputs": self.outputs,
                "temps": self.temps, "aliased": 0,
                "peak_estimate": self.arguments + self.outputs + self.temps}


class CostCounter(TorchDispatchMode):
    """Counts what one rank's program costs, used under ``FakeTensorMode``:

        with FakeTensorMode(), CostCounter() as counter:
            x = torch.empty(...)          # made inside: fake
            counter.arguments(x)
            out = step(x)
            counter.outputs(out)
        counter.cost                      # a :class:`Cost`
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self._live: dict[int, int] = {}      # storage id → bytes
        self._live_bytes = 0
        self._groups: dict[str, tuple[int, str]] = {}

    # -- live bytes --------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        sid = st._cdata
        if sid in self._live:
            return
        self._live[sid] = st.nbytes()
        self._live_bytes += st.nbytes()
        self.cost.peak_live = max(self.cost.peak_live, self._live_bytes)
        weakref.finalize(st, self._free, sid).atexit = False

    def _free(self, sid: int) -> None:
        self._live_bytes -= self._live.pop(sid, 0)

    def arguments(self, *tensors) -> None:
        """Mark the step's inputs (made before it runs) as arguments."""
        for t in _tensors(tensors):
            self._track(t)
            self.cost.arguments += _nbytes(t)

    def outputs(self, *tensors) -> None:
        """Mark what the step returned as its outputs."""
        self.cost.outputs += sum(_nbytes(t) for t in _tensors(tensors))

    # -- collectives -------------------------------------------------------
    def _group(self, pg) -> tuple[int, str]:
        """(size, link) of the process group a ``c10d`` op was given (a
        ``ScriptObject``, unboxed to the ``ProcessGroup``)."""
        group = dist.ProcessGroup.unbox(pg)
        name = group.group_name
        if name not in self._groups:
            ranks = dist.get_process_group_ranks(group)
            nodes = {r // GPUS_PER_NODE for r in ranks}
            self._groups[name] = (group.size(),
                                  "nvlink" if len(nodes) == 1 else "network")
        return self._groups[name]

    def _collective(self, kind: str, written, args) -> None:
        pg = next(a for a in args if isinstance(a, torch.ScriptObject))
        g, link = self._group(pg)
        b = sum(_nbytes(t) for t in _tensors(written))
        c = self.cost
        c.memory_bytes += b
        if kind == "recv":
            return
        w = _wire_bytes(kind, b, g)
        c.collectives.append(Collective(kind, b, g, link, w))
        c.collective_wire_bytes += w
        c.collective_raw_bytes += b
        c.wire_bytes_by_link[link] += w
        c.per_collective[kind] = c.per_collective.get(kind, 0.0) + w
        c.n_collectives[kind] = c.n_collectives.get(kind, 0) + 1

    # -- every op ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            kind = _COLLECTIVE_OPS.get(func.__name__.split(".")[0])
            if kind is not None and any(isinstance(t, FakeTensor)
                                        for t in _tensors(args)):
                self._collective(kind, args[0], args)
            return out
        inputs = _tensors((args, kwargs))
        results = [t for t in _tensors(out) if isinstance(t, FakeTensor)]
        if not results and not any(isinstance(t, FakeTensor) for t in inputs):
            return out
        c = self.cost
        if func in _DOTS:
            c.flops += _dot_flops(func, args, out)
            c.memory_bytes += sum(_nbytes(t) for t in _tensors(args[-2:]))
        for t in results:
            self._track(t)
        if func.is_view or func.__name__.split(".")[0] in _NO_TRAFFIC:
            return out
        if func._schema.is_mutable:
            written = [v for a, v in zip(func._schema.arguments, args)
                       if a.alias_info is not None and a.alias_info.is_write]
            written += [v for a in func._schema.arguments
                        if a.alias_info is not None and a.alias_info.is_write
                        and (v := kwargs.get(a.name)) is not None]
            c.memory_bytes += sum(_nbytes(t) for t in _tensors(written))
            return out
        seen = {t.untyped_storage()._cdata for t in inputs}
        c.memory_bytes += sum(_nbytes(t) for t in results
                              if t.untyped_storage()._cdata not in seen)
        return out


# ---------------------------------------------------------------------------
# Roofline terms: NVIDIA H100 80GB HBM3 constants
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Roofline:
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    hlo_flops: float                # per-device × chips = total
    useful_ratio: float             # MODEL_FLOPS / counted FLOPs

    def table_row(self) -> dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
        }


def roofline(cost: Cost, n_chips: int, model_flops: float,
             peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
             nvlink_bw: float = NVLINK_BW,
             network_bw: float = NETWORK_BW) -> Roofline:
    """``cost`` is the per-device program; totals scale by ``n_chips``.  A
    collective's wire bytes move at NVLink's rate when its group lies in
    one node, else at the network's."""
    total_flops = cost.flops * n_chips
    t_comp = total_flops / (n_chips * peak_flops)
    t_mem = cost.memory_bytes / hbm_bw
    t_coll = (cost.wire_bytes_by_link["nvlink"] / nvlink_bw
              + cost.wire_bytes_by_link["network"] / network_bw)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bott = max(terms, key=terms.get)
    useful = model_flops / total_flops if total_flops else 0.0
    return Roofline(t_comp, t_mem, t_coll, bott, model_flops, total_flops,
                    useful)
