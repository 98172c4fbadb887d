"""Perfmodel-driven streaming plans (paper Eqs. 2, 3, 7 composed).

Maps (:class:`Hardware`, :class:`Workload`, placement) onto a
:class:`StreamPlan`, as the JAX package's ``repro.engine.planner`` does:

* **segment length** — the largest even L whose *two* device buffers fit
  beside the resident macro environment and the micro-batch intermediate
  of Eq. 3, inside the device memory budget;
* **micro batch** — the workload's N₂ when it subdivides N₁;
* **scheme** — dp when only p₁ > 1; in a TP group the Eq. 7 selector picks
  single- or double-site (§4.3).

:func:`explain_plan` gives the §3.1 overlap accounting (per-site compute
against the Γ read time, and the smallest macro batch that hides the
read).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import perfmodel as PM
from repro_torch.core.perfmodel import Hardware, Workload
from repro_torch.engine.streaming import StreamPlan


def plan_stream(w: Workload, hw: Hardware, *, n_sites: Optional[int] = None,
                p1: int = 1, p2: int = 1, compute_bytes: int = 4,
                device_budget: Optional[float] = None,
                checkpoint_every: int = 0, safety: float = 0.9) -> StreamPlan:
    """(segment length, N₂, scheme) for a streamed walk.  Every term is per
    device: DP shards the batch p₁ ways, TP the bond p₂ ways."""
    M = n_sites if n_sites is not None else w.n_sites
    budget = device_budget if device_budget is not None else hw.mem_capacity
    n1_local = max(1, w.macro_batch // p1)
    site_bytes = w.chi * (w.chi // p2) * w.d * compute_bytes
    env_bytes = n1_local * (w.chi // p2) * compute_bytes       # Eq. 3 resident
    micro = w.micro_batch if 0 < w.micro_batch < w.macro_batch else None
    # the unmeasured (N₂, χ, d) intermediate spans the full bond under every
    # scheme (TP's split-K partial is (N_local, χ, d))
    inter_bytes = ((micro or w.macro_batch) // p1 * w.chi
                   * w.d * compute_bytes)
    avail = safety * budget - env_bytes - inter_bytes
    if avail < 2 * site_bytes:
        raise ValueError(
            f"budget {budget:.2e} B cannot hold two Γ sites beside the "
            f"N₁={w.macro_batch} environment — shrink the macro batch")
    seg = int(avail // (2 * site_bytes))      # two live buffers at all times
    seg = max(2, min(seg, M))
    seg -= seg % 2                            # even: tp_double composes

    if p2 > 1:
        scheme = "tp_" + PM.choose_tp_scheme(w, hw, p2)
    elif p1 > 1:
        scheme = "dp"
    else:
        scheme = "inmem"
    # under DP/TP the per-shard micro batch must subdivide the local batch
    if micro is not None and scheme != "inmem":
        micro_local = micro // p1
        micro = (micro_local if micro % p1 == 0 and micro_local > 0
                 and n1_local % micro_local == 0 else None)
    return StreamPlan(segment_len=seg, scheme=scheme, micro_batch=micro,
                      checkpoint_every=checkpoint_every)


def explain_plan(plan: StreamPlan, w: Workload, hw: Hardware, *,
                 storage_bytes: int = 2, compute_bytes: int = 4,
                 efficiency: float = 0.5) -> dict:
    """The §3.1 overlap accounting behind a plan, as printable numbers."""
    t_comp = PM.t_site_compute(w, hw, w.macro_batch, efficiency)
    t_io = PM.t_gamma_io(w, hw, storage_bytes)
    seg_bytes = plan.segment_len * w.chi * w.chi * w.d * compute_bytes
    return {
        "segment_len": plan.segment_len,
        "scheme": plan.scheme,
        "micro_batch": plan.micro_batch,
        "t_compute_per_site_s": t_comp,
        "t_io_per_site_s": t_io,
        "io_overlapped": t_comp >= t_io,
        "min_macro_batch_for_overlap": PM.min_macro_batch_for_overlap(
            w, hw, efficiency, storage_bytes),
        "segment_bytes": seg_bytes,
        "device_resident_bytes": 2 * seg_bytes + PM.eq3_memory(
            w, compute_bytes),
        "admission": PM.job_admission_cost(w, hw, efficiency=efficiency),
    }
