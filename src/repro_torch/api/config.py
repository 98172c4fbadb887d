"""Config schema and resolution for the sampling front door.

:class:`SamplerConfig` keeps the JAX package's field names
(``repro.api.config``).  This slice of the port resolves the in-memory walk:
backend ``inmem``, runtime ``local``, a static χ, an explicit
``micro_batch``, and the schemes ``seq``, ``dp``, ``tp_single``,
``tp_double`` and ``baseline19`` over a session's mesh (with ``wire_dtype``
and ``measure_first``).  ``auto`` resolves to ``seq`` without a mesh (or on
a 1×1 mesh) and to ``dp`` when the mesh has no model axis; with p₂ > 1 the
JAX package picks a TP schedule by its Eq. 7 model, which is not ported yet.
Every other value raises ``NotImplementedError`` naming the ROADMAP.md row
that ports it.

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

import torch

from repro_torch.core.parallel import ParallelConfig
from repro_torch.core.sampler import SamplerConfig as CoreSamplerConfig
from repro_torch.kernels.dispatch import resolve_kernels
from repro_torch.kernels.site_step import check_compute_dtype

AUTO = "auto"

_SCHEMES = ("seq", "dp", "tp_single", "tp_double", "baseline19")
_SCALINGS = ("none", "global", "per_sample")


def unported(what: str, row: int, topic: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet "
        f"(ROADMAP.md §1 row {row}: {topic})")


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
    runtime: str = AUTO
    micro_batch: Union[int, str, None] = None
    chi_profile: Optional[tuple[int, ...]] = None
    shard: Union[int, str, None] = None
    clamp: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class SessionPlan:
    """Fully-resolved execution record for one ``session.sample(n, key)``."""
    backend: str                       # "inmem"
    runtime: str                       # "local"
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


def _check_unported(config: SamplerConfig) -> None:
    if config.backend in ("streamed", "remote"):
        raise unported(f"backend={config.backend!r}", 9 if
                       config.backend == "streamed" else 10,
                       "GammaStore + streaming engine" if
                       config.backend == "streamed" else
                       "service and cluster layers")
    if config.runtime not in (AUTO, "local"):
        raise unported(f"runtime={config.runtime!r}", 10,
                       "service and cluster layers")
    if config.shard is not None:
        raise unported("chain sharding (shard=...)", 10,
                       "service and cluster layers")
    if config.chi_profile is not None:
        raise unported("chi_profile (dynamic χ)", 8, "core/dynamic_bond.py")
    if config.clamp:
        raise unported("clamp (conditional sampling)", 12,
                       "core/clamped.py + workloads")
    if config.micro_batch == AUTO:
        raise unported("micro_batch='auto' (memory-model pick)", 9,
                       "perfmodel + planner")


def resolve_plan(config: SamplerConfig, *, n_samples: int, n_sites: int,
                 chi: int, d: int, source_semantics: Optional[str] = None,
                 device: torch.device, mesh=None) -> SessionPlan:
    """Resolve every AUTO field of ``config`` into a :class:`SessionPlan`;
    raises ``ValueError`` for malformed requests and ``NotImplementedError``
    for values this slice of the port does not carry."""
    _check_unported(config)
    if config.backend not in (AUTO, "inmem"):
        raise ValueError(f"unknown backend {config.backend!r}")
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
    scheme = config.scheme
    if scheme == AUTO:
        if mesh is None or (p1 == 1 and p2 == 1):
            scheme = "seq"
        elif p2 > 1:
            raise unported("scheme='auto' on a mesh with a model axis (the "
                           "Eq. 7 TP selector)", 9,
                           "core/perfmodel.py choose_tp_scheme")
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
    n_local = n_samples // p1 if sharded else n_samples

    micro = config.micro_batch
    if micro is not None:
        micro = int(micro)
        if micro <= 0 or n_local % micro != 0:
            raise ValueError(f"micro_batch={micro} must divide the local "
                             f"batch {n_local}")
        if scheme == "baseline19":
            raise ValueError("micro batching does not compose with the [19] "
                             "pipeline baseline")

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
    return SessionPlan(backend="inmem", runtime="local", scheme=scheme,
                       semantics=semantics, kernels=kernels,
                       n_samples=n_samples, p1=p1, p2=p2, micro_batch=micro,
                       sampler_config=sampler_config, pconfig=pconfig,
                       device=str(device))
