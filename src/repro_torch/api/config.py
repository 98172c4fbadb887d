"""Config schema and resolution for the sampling front door.

:class:`SamplerConfig` keeps the JAX package's field names
(``repro.api.config``).  The port resolves the runtimes ``local``,
``multihost`` (a ``torch.distributed`` job of ≥ 2 ranks), ``remote`` (a
worker process) or a runtime instance (``api.runtime``), the data planes
``inmem`` (the whole chain on the device), ``streamed`` (a
:class:`~repro_torch.data.gamma_store.GammaStore` walked segment by segment
by ``engine.StreamingEngine``) and ``remote`` (the request dispatched
through the runtime; AUTO on a remote runtime), and the schemes ``seq``,
``dp``,
``tp_single``, ``tp_double`` and ``baseline19`` over a session's mesh (with
``wire_dtype`` and ``measure_first``).  ``auto`` resolves to ``seq``
without a mesh (or on a 1×1 mesh), to ``dp`` when the mesh has no model
axis, and with p₂ > 1 to the TP schedule of the lower Eq. 7 overhead
(``core/perfmodel.choose_tp_scheme``).  ``chi_profile`` (§3.4.2) splits the
walk into χ-stages; ``micro_batch="auto"`` takes Eq. 3's pick and
``segment_len="auto"`` the streaming planner's, both against
``hardware`` (an H100 by default) or ``device_budget``.  ``clamp``
(conditional sampling, ``workloads.clamp``) is normalised when the config
is made (``None``/``{}`` plan the unchanged unclamped path) and checked
against the chain and batch at plan time; a clamped plan walks
``core/clamped.py`` under every scheme but ``baseline19`` and returns the
per-sample ``log_prob`` in ``session.stats``.  A runtime of more than one
process needs the ``streamed`` plane (the §3.1 broadcast), and
``backend="remote"`` takes no mesh, no scheme but seq and no
``checkpoint_dir``, as the JAX package refuses them.  ``shard`` turns on
the sharded plane (``repro_torch.shard``): an int block of sites (block-
cyclic site → host ownership, a whole number of segments) or AUTO (one
segment a block), streamed backend only; the plan's ``shard_block`` is
checked against the engine's real schedule (every segment one owner), and
the host count binds to the executing runtime (a lone remote worker walks
the 1-host map).  A mesh with more data axes than one (the JAX package's
("pod", "data", "model")) splits the batch over all of them, pod-major.

``kernels``: ``"cuda"`` (the Hopper kernels), ``"torch"`` (the plain
PyTorch cells) or AUTO (cuda on the card, torch on the CPU).

``compute_dtype``: None or ``torch.bfloat16`` — bf16 GEMM inputs with fp32
sums, on an fp32 chain (the ``mxu_bf16`` tier) or a bf16-stored Γ
(``store_bf16``).  It applies to linear chains; the Born seq and dp walks
ignore it, as the JAX package's do, and the Born TP schemes refuse it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.api.runtime import ClusterRuntime, resolve_runtime
from repro_torch.core.dynamic_bond import stages_from_profile
from repro_torch.core.parallel import ParallelConfig
from repro_torch.core.perfmodel import H100, Hardware, Workload, \
    choose_tp_scheme
from repro_torch.core.sampler import SamplerConfig as CoreSamplerConfig
from repro_torch.kernels.dispatch import resolve_kernels
from repro_torch.kernels.site_step import check_compute_dtype
from repro_torch.workloads.clamp import normalize_clamp, validate_clamp

AUTO = "auto"

_SCHEMES = ("seq", "dp", "tp_single", "tp_double", "baseline19")
_SCALINGS = ("none", "global", "per_sample")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Session-level sampling configuration (see module docstring)."""
    semantics: str = AUTO              # "linear" | "born" | AUTO (from MPS)
    scaling: str = "per_sample"
    kernels: str = AUTO                # "cuda" | "torch" | AUTO
    compute_dtype: Optional[Any] = None
    wire_dtype: Optional[Any] = None
    measure_first: bool = False
    scheme: str = AUTO
    backend: str = AUTO
    runtime: Union[str, ClusterRuntime] = AUTO
    micro_batch: Union[int, str, None] = None      # N₂ per data shard
    chi_profile: Optional[tuple[int, ...]] = None  # bucketed χ per site
    segment_len: Union[int, str] = AUTO            # streamed: sites/segment
    shard: Union[int, str, None] = None
    clamp: Optional[Any] = None
    store_root: Optional[str] = None       # where a streamed MPS is written
    checkpoint_dir: Optional[str] = None   # streamed: per-segment checkpoints
    checkpoint_every: int = 1              # segments between checkpoints
    hardware: Hardware = H100              # what the AUTO fields plan for
    device_budget: Optional[float] = None  # device bytes, overrides hardware

    def __post_init__(self):
        # the canonical hashable spec; a malformed one raises ValueError
        object.__setattr__(self, "clamp", normalize_clamp(self.clamp))


@dataclasses.dataclass(frozen=True)
class SessionPlan:
    """Fully-resolved execution record for one ``session.sample(n, key)``."""
    backend: str                       # "inmem" | "streamed" | "remote"
    runtime: str                       # the runtime's name
    scheme: str                        # "seq" | "dp" | "tp_*" | "baseline19"
    semantics: str
    kernels: str                       # resolved dispatch: "cuda" | "torch"
    n_samples: int
    p1: int                            # data-parallel shards
    p2: int                            # tensor-parallel ranks per shard
    micro_batch: Optional[int]
    sampler_config: CoreSamplerConfig  # the kernel-level config
    pconfig: Optional[ParallelConfig]  # the DP × TP placement (dp, tp_*)
    device: str
    segment_len: Optional[int] = None  # streamed backend only
    chi_profile: Optional[tuple[int, ...]] = None
    stages: Optional[tuple[tuple[int, int, int], ...]] = None  # (s0, s1, χ)
    checkpoint_every: int = 1
    shard_block: Optional[int] = None  # sites per ownership block; None: off
    clamp: Optional[tuple] = None      # the normalised spec; None: unclamped

    @property
    def cell(self) -> tuple[str, str, str, str, str]:
        """backend × runtime × scheme × semantics × kernels: the config
        cell the service coalesces jobs on."""
        return (self.backend, self.runtime, self.scheme, self.semantics,
                self.kernels)


def _mesh_sizes(mesh) -> tuple[int, int]:
    if mesh is None:
        return 1, 1
    shape = dict(mesh.shape)
    p2 = shape.get("model", 1)
    p1 = 1
    for ax, size in shape.items():
        if ax != "model":
            p1 *= size
    return p1, p2


def _auto_micro_batch(n_local: int, chi: int, d: int, budget: float,
                      bytes_per_elt: int = 8) -> Optional[int]:
    """Eq. 3's pick: the largest divisor of the local batch whose
    unmeasured (N₂, χ, d) intermediate stays under 10 % of the budget."""
    target = max(1, int(0.1 * budget // (chi * d * bytes_per_elt)))
    if target >= n_local:
        return None                     # the whole shard fits
    for k in range(target, 0, -1):
        if n_local % k == 0:
            return k
    return None


def _check_cell(runtime: ClusterRuntime, backend: str, config: SamplerConfig,
                mesh) -> None:
    """The runtime × data-plane cells the JAX package refuses."""
    if runtime.process_count > 1 and backend != "streamed":
        raise ValueError(
            f"runtime {runtime.name!r} spans {runtime.process_count} "
            f"processes — the §3.1 Γ broadcast needs the 'streamed' data "
            f"plane (got backend={backend!r})")
    if runtime.name == "remote" and backend != "remote":
        raise ValueError(
            f"a remote runtime dispatches serialized configs — use "
            f"backend='remote' (or AUTO), not {backend!r}")
    if backend != "remote":
        return
    if config.scheme not in (AUTO, "seq"):
        raise ValueError(
            f"backend='remote' resolves placement on the worker — scheme "
            f"must stay AUTO/'seq' on the dispatching side (got "
            f"{config.scheme!r})")
    if mesh is not None:
        raise ValueError("backend='remote' takes no local mesh — the worker "
                         "builds its own from its runtime")
    if config.checkpoint_dir is not None:
        raise ValueError(
            "backend='remote' does not ship checkpoint_dir — the worker's "
            "checkpoints would be local to it and resume could not find "
            "them; rely on idempotent macro batches (run_queue) for remote "
            "fault tolerance")


def _stages(chi_profile, n_sites: int, chi: int, scheme: str, p2: int):
    """The χ-stages of a profile, checked against the chain and scheme."""
    chi_profile = tuple(int(c) for c in chi_profile)
    if len(chi_profile) != n_sites:
        raise ValueError(f"chi_profile covers {len(chi_profile)} of "
                         f"{n_sites} sites")
    if max(chi_profile) > chi:
        raise ValueError(f"chi_profile exceeds the chain's χ "
                         f"({max(chi_profile)} > {chi})")
    if scheme == "baseline19":
        raise ValueError("dynamic χ does not compose with the [19] pipeline "
                         "baseline")
    stages = tuple((st.start, st.stop, st.chi) for st in
                   stages_from_profile(np.asarray(chi_profile)))
    if scheme in ("tp_single", "tp_double"):
        for _, _, chi_s in stages:
            if chi_s % p2:
                raise ValueError(f"χ bucket {chi_s} does not divide over "
                                 f"p₂={p2} tensor-parallel workers")
    if scheme == "tp_double":
        for s0, s1, _ in stages:
            if s0 % 2 or s1 % 2:
                raise ValueError("tp_double pairs sites (2j, 2j+1): χ-stage "
                                 f"boundaries must be even (got [{s0}, {s1}))")
    return chi_profile, stages


def resolve_plan(config: SamplerConfig, *, n_samples: int, n_sites: int,
                 chi: int, d: int, source_semantics: Optional[str] = None,
                 device: torch.device, mesh=None,
                 backend_hint: str = "inmem",
                 elt_bytes: int = 8,
                 runtime: Optional[ClusterRuntime] = None) -> SessionPlan:
    """Resolve every AUTO field of ``config`` into a :class:`SessionPlan`;
    raises ``ValueError`` for malformed requests.  ``backend_hint`` is the
    source's natural data plane (``streamed`` for a store), ``elt_bytes``
    the bytes of one of its Γ elements as walked, ``runtime`` the session's
    resolved runtime (None: resolve ``config.runtime`` here)."""
    from repro_torch.api.backends import available_backends

    if runtime is None:
        runtime = resolve_runtime(config.runtime)
    backend = config.backend
    if backend == AUTO:
        # a remote runtime runs only dispatched payloads: the worker picks
        # the data plane on its side
        backend = "remote" if runtime.name == "remote" else backend_hint
    if backend not in available_backends():
        raise ValueError(f"unknown backend {backend!r}; have "
                         f"{available_backends()}")
    _check_cell(runtime, backend, config, mesh)
    if config.scheme not in (AUTO,) + _SCHEMES:
        raise ValueError(f"unknown scheme {config.scheme!r}; have {_SCHEMES}")
    if config.scaling not in _SCALINGS:
        raise ValueError(f"unknown scaling {config.scaling!r}; "
                         f"have {_SCALINGS}")
    if n_samples < 1 or n_sites < 1 or chi < 1 or d < 1:
        raise ValueError(f"empty request: n_samples={n_samples}, "
                         f"(M, χ, d)=({n_sites}, {chi}, {d})")
    semantics = (config.semantics if config.semantics != AUTO
                 else (source_semantics or "linear"))
    if semantics not in ("linear", "born"):
        raise ValueError(f"unknown semantics {semantics!r}")
    kernels = resolve_kernels(config.kernels, device)
    check_compute_dtype(config.compute_dtype, "SamplerConfig")

    p1, p2 = _mesh_sizes(mesh)
    hw = config.hardware
    budget = config.device_budget if config.device_budget else \
        hw.mem_capacity
    scheme = config.scheme
    if scheme == AUTO:
        if mesh is None or (p1 == 1 and p2 == 1):
            scheme = "seq"
        elif p2 > 1:
            w_probe = Workload(n_samples=n_samples, n_sites=n_sites, chi=chi,
                               d=d, macro_batch=n_samples,
                               micro_batch=max(1, n_samples // p1))
            scheme = "tp_" + choose_tp_scheme(w_probe, hw, p2)
        else:
            scheme = "dp"
    if scheme != "seq" and mesh is None:
        raise ValueError(f"scheme {scheme!r} needs a mesh")
    if scheme != "seq" and mesh.device.type != device.type:
        raise ValueError(f"the mesh runs on {mesh.device.type}, the "
                         f"session on {device.type}")
    sharded = scheme in ("dp", "tp_single", "tp_double")   # the batch on p₁
    if sharded and n_samples % p1:
        raise ValueError(f"n_samples={n_samples} must divide over the "
                         f"p₁={p1} data shards")
    if scheme in ("tp_single", "tp_double") and chi % p2:
        raise ValueError(f"χ={chi} does not divide over p₂={p2} "
                         f"tensor-parallel workers")
    if (config.compute_dtype is not None and semantics == "born"
            and scheme in ("tp_single", "tp_double")):
        raise ValueError("compute_dtype applies to linear chains: the Born "
                         "TP schedules would round complex amplitudes to a "
                         "real bf16, dropping their imaginary part")
    if scheme == "tp_double" and n_sites % 2:
        raise ValueError("tp_double pairs sites (2j, 2j+1): the chain needs "
                         f"an even site count, got {n_sites}")
    if scheme == "baseline19" and backend != "inmem":
        raise ValueError("the [19] pipeline exists for comparison only and "
                         "has no streamed backend")
    n_local = n_samples // p1 if sharded else n_samples

    chi_profile = stages = None
    if config.chi_profile is not None:
        chi_profile, stages = _stages(config.chi_profile, n_sites, chi,
                                      scheme, p2)

    micro = config.micro_batch
    micro_was_auto = micro == AUTO
    if micro_was_auto:
        micro = (None if scheme == "baseline19" else
                 _auto_micro_batch(n_local, chi, d, budget, elt_bytes))
    if micro is not None:
        micro = int(micro)
        if micro <= 0 or n_local % micro != 0:
            raise ValueError(f"micro_batch={micro} must divide the local "
                             f"batch {n_local}")
        if micro == n_local and micro_was_auto:
            micro = None
        if scheme == "baseline19":
            raise ValueError("micro batching does not compose with the [19] "
                             "pipeline baseline")

    segment_len = None
    if backend == "streamed":
        if config.segment_len == AUTO:
            from repro_torch.engine.planner import plan_stream
            w = Workload(n_samples=n_samples, n_sites=n_sites, chi=chi, d=d,
                         macro_batch=n_samples,
                         micro_batch=(micro * p1 if micro else n_samples))
            segment_len = plan_stream(
                w, hw, p1=p1, p2=p2, compute_bytes=elt_bytes,
                device_budget=config.device_budget).segment_len
        else:
            segment_len = int(config.segment_len)
            if segment_len < 1:
                raise ValueError(f"segment_len must be ≥ 1, got "
                                 f"{segment_len}")
        if scheme == "tp_double" and segment_len % 2:
            segment_len += 1            # pairs never straddle segments

    shard_block = None
    if config.shard is not None and backend != "remote":
        # a remote payload carries the shard untouched: the worker
        # resolves it against its own runtime
        if backend != "streamed":
            raise ValueError(
                f"chain sharding distributes the streamed Γ walk — it needs "
                f"backend='streamed', got {backend!r}")
        shard_block = (segment_len if config.shard == AUTO
                       else int(config.shard))
        if shard_block < 1:
            raise ValueError(f"shard block must be ≥ 1 site, got "
                             f"{shard_block}")
        if shard_block % segment_len:
            raise ValueError(
                f"shard block ({shard_block} sites) must be a whole number "
                f"of segments (segment_len={segment_len}) — a segment "
                f"walked on one host cannot straddle two owners")
        # single ownership, proved on the engine's real schedule
        from repro_torch.shard.shardmap import ShardMap, chain_segments
        smap = ShardMap(n_sites=n_sites,
                        n_hosts=max(1, runtime.process_count),
                        block=shard_block)
        smap.owners_for(chain_segments(n_sites, segment_len, stages))

    clamp = config.clamp                # normalised by __post_init__
    if clamp is not None:
        if backend != "remote":         # the worker checks it against its
            validate_clamp(clamp, n_sites=n_sites, d=d,        # store
                           n_samples=n_samples)
        if scheme == "baseline19":
            raise ValueError("clamped sampling does not compose with the "
                             "[19] pipeline baseline")
        if config.compute_dtype is not None and semantics == "born":
            raise ValueError("compute_dtype applies to linear chains: the "
                             "clamped Born walk would round complex "
                             "amplitudes to a real bf16")

    pconfig = None
    if sharded:
        data_axes = tuple(ax for ax in mesh.axis_names if ax != "model")
        pconfig = ParallelConfig(scheme=scheme, data_axes=data_axes,
                                 wire_dtype=config.wire_dtype,
                                 measure_first=config.measure_first,
                                 micro_batch=micro)
    sampler_config = CoreSamplerConfig(semantics=semantics,
                                       scaling=config.scaling,
                                       compute_dtype=config.compute_dtype,
                                       kernels=kernels)
    return SessionPlan(backend=backend, runtime=runtime.name, scheme=scheme,
                       semantics=semantics, kernels=kernels,
                       n_samples=n_samples, p1=p1, p2=p2, micro_batch=micro,
                       sampler_config=sampler_config, pconfig=pconfig,
                       device=str(device), segment_len=segment_len,
                       chi_profile=chi_profile, stages=stages,
                       checkpoint_every=config.checkpoint_every,
                       shard_block=shard_block, clamp=clamp)
