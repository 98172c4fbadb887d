"""Executable performance models (paper Eqs. 1, 2, 3, 4, 7).

A copy of the JAX package's ``repro.core.perfmodel``, function for
function, with an NVIDIA H100 preset as the default hardware.  They drive
the scheme selector (single- vs double-site TP, Eq. 7), macro and micro
batch sizing against memory and overlap (Eqs. 2-3) and the streaming
planner (``engine/planner.py``).  Times in seconds, sizes in bytes, rates
in units per second.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Per-card capabilities.  Defaults: NVIDIA H100 SXM5 80GB, from its
    data sheet: 989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of
    HBM3, NVLink 4 at 900 GB/s in both directions (450 GB/s each way), and
    80 GB.  ``io_bw`` is the paper's 5 GB/s NVMe read, a figure of the
    storage, not of the card."""
    peak_flops: float = 989e12          # bf16 tensor cores, dense
    hbm_bw: float = 3.35e12             # bytes/s
    ici_bw: float = 450e9               # bytes/s per direction (NVLink)
    io_bw: float = 5e9                  # storage read (paper's NVMe figure)
    mem_capacity: float = 80e9          # HBM bytes
    allreduce_bw: float | None = None   # measured override (Eq. 7 selector)
    reducescatter_bw: float | None = None

    @property
    def b_allreduce(self) -> float:
        return self.allreduce_bw or self.ici_bw

    @property
    def b_reducescatter(self) -> float:
        return self.reducescatter_bw or self.ici_bw


H100 = Hardware()
# the JAX package's presets, kept for comparisons
A100 = Hardware(peak_flops=156e12, hbm_bw=2039e9, ici_bw=300e9, io_bw=5e9,
                mem_capacity=80e9)
TPU_V5E = Hardware(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9, io_bw=5e9,
                   mem_capacity=16e9)


@dataclasses.dataclass(frozen=True)
class Workload:
    n_samples: int          # N
    n_sites: int            # M
    chi: int                # bond dimension
    d: int = 3              # physical dimension
    macro_batch: int = 20_000   # N₁
    micro_batch: int = 5_000    # N₂
    bytes_per_elt: int = 8      # fp64 real / complex64; the paper uses 16

    @property
    def n_macro(self) -> int:           # n₁
        return max(1, self.n_samples // self.macro_batch)


def t_site_compute(w: Workload, hw: Hardware, n: int | None = None,
                   efficiency: float = 0.5) -> float:
    """T_{i,N}: one site's contraction and measurement for n samples,
    2·N·χ²·d + 2·N·χ·d FLOPs at ``efficiency`` × peak."""
    n = w.macro_batch if n is None else n
    flops = 2.0 * n * w.chi * w.chi * w.d + 2.0 * n * w.chi * w.d
    return flops / (hw.peak_flops * efficiency)


def t_gamma_io(w: Workload, hw: Hardware,
               storage_bytes: int | None = None) -> float:
    """Read one Γ (χ²·d elements) from storage."""
    b = storage_bytes if storage_bytes is not None else w.bytes_per_elt
    return (w.chi * w.chi * w.d * b) / hw.io_bw


def eq1_model_parallel(w: Workload, hw: Hardware, efficiency: float = 0.5,
                       imbalance: float = 0.1) -> float:
    """Eq. 1 — the [19] pipeline, one process per site:
    T = T_read + n₁·max_i T_{i,N₁} + Σ_i (T_{i,N₁} + T_comm)."""
    t_comp = t_site_compute(w, hw, w.macro_batch, efficiency)
    t_comm = (w.macro_batch * w.chi * w.bytes_per_elt) / hw.ici_bw
    t_read = t_gamma_io(w, hw)
    return (t_read + w.n_macro * t_comp * (1 + imbalance)
            + w.n_sites * (t_comp + t_comm))


def eq2_data_parallel(w: Workload, hw: Hardware, p: int,
                      efficiency: float = 0.5,
                      overlapped: bool = True,
                      storage_bytes: int | None = None) -> float:
    """Eq. 2 — data parallel with I/O and broadcast behind compute:
    T = T_read + T_bcast + (n₁/p)·Σ_i T_{i,N₁} while T_comp ≥ T_IO a site;
    otherwise the I/O leaks into the critical path."""
    t_comp = t_site_compute(w, hw, w.macro_batch, efficiency)
    t_io = t_gamma_io(w, hw, storage_bytes)
    t_bcast = ((w.chi * w.chi * w.d * (storage_bytes or w.bytes_per_elt))
               / hw.ici_bw)
    per_site = (t_comp if (overlapped and t_comp >= t_io)
                else t_comp + (t_io - t_comp if overlapped else t_io))
    n_rounds = max(1.0, w.n_macro / p)
    return t_io + t_bcast + n_rounds * w.n_sites * per_site


def eq3_memory(w: Workload, bytes_per_elt: int | None = None) -> float:
    """Eq. 3 — resident bytes: the left environment (N₁·χ), Γ (χ²·d) and
    the unmeasured micro-batch intermediate (N₂·χ·d)."""
    b = bytes_per_elt or w.bytes_per_elt
    return (w.macro_batch * w.chi + w.chi * w.chi * w.d
            + w.micro_batch * w.chi * w.d) * b


def site_hbm_bytes(n: int, chi: int, d: int, bytes_per_elt: int = 8,
                   fused: bool = False) -> float:
    """Modelled per-site HBM traffic of the hot loop: unfused, the
    (N, χ, d) temp makes three trips (written by the contraction, read by
    the measurement and by the collapse); fused, only env, Γ and u go in
    and env', samples and dlog come out."""
    operands = n * chi + chi * chi * d            # env read + Γ read
    env_out = n * chi                             # env' write
    if fused:
        return (operands + env_out + 3 * n) * bytes_per_elt
    temp = 3 * n * chi * d                        # write + 2 reads
    probs = 2 * n * d                             # write + read for the draw
    return (operands + env_out + temp + probs) * bytes_per_elt


def site_fusion_byte_reduction(n: int, chi: int, d: int,
                               bytes_per_elt: int = 8) -> float:
    """HBM bytes unfused over fused, for one site."""
    return (site_hbm_bytes(n, chi, d, bytes_per_elt, fused=False)
            / site_hbm_bytes(n, chi, d, bytes_per_elt, fused=True))


def eq4_tp_site(w: Workload, hw: Hardware, p2: int, scheme: str,
                efficiency: float = 0.5,
                t_measure: float | None = None) -> float:
    """Eq. 4 — one TP site step: GEMM + measure + comm volume / bandwidth."""
    n2 = w.micro_batch
    gemm_flops = 2.0 * n2 * w.chi * (w.chi / p2) * w.d
    t_gemm = gemm_flops / (hw.peak_flops * efficiency)
    t_meas = t_measure if t_measure is not None else (
        2.0 * n2 * w.chi * w.d) / (hw.hbm_bw)      # bandwidth-bound reduction
    if scheme == "single":
        vol = n2 * (w.chi / p2) * (p2 - 1) / p2 * w.bytes_per_elt * p2
        t_comm = vol / hw.b_reducescatter
        t_meas = t_meas * p2                        # replicated measurement
    elif scheme == "double":
        vol = 2 * n2 * w.chi * w.d * (p2 - 1) / p2 * w.bytes_per_elt
        t_comm = vol / hw.b_allreduce / 2.0         # amortized per site
    else:
        raise ValueError(scheme)
    return t_gemm + t_meas + t_comm


def eq7_tp_overhead(w: Workload, hw: Hardware, p2: int, scheme: str,
                    efficiency: float = 0.5) -> float:
    """Eq. 7 — Overhead = (CommVolume/B + η·T_measure) / T_{i,N₂}: single
    ships the measured (N₂, χ) env by ReduceScatter with η = p₂; double
    ships the unmeasured (N₂, χ, d) by AllReduce every two sites, η = 1."""
    n2 = w.micro_batch
    t_meas = (2.0 * n2 * w.chi * w.d) / hw.hbm_bw
    if scheme == "double":
        eta = 1.0
        comm = (n2 * w.chi * w.d * w.bytes_per_elt / 2.0) / hw.b_allreduce
    else:
        eta = float(p2)
        comm = (n2 * w.chi * w.bytes_per_elt) / hw.b_reducescatter
    t_site = t_site_compute(w, hw, n2, efficiency) / p2
    return (comm + eta * t_meas) / t_site


def choose_tp_scheme(w: Workload, hw: Hardware, p2: int) -> str:
    """Paper §4.3: the scheme with the lower Eq. 7 overhead."""
    od = eq7_tp_overhead(w, hw, p2, "double")
    os_ = eq7_tp_overhead(w, hw, p2, "single")
    return "double" if od <= os_ else "single"


def min_macro_batch_for_overlap(w: Workload, hw: Hardware,
                                efficiency: float = 0.5,
                                storage_bytes: int | None = None) -> int:
    """Smallest N₁ with T_comp ≥ T_IO (§3.1: the computation-I/O ratio is
    N₁)."""
    t_io = t_gamma_io(w, hw, storage_bytes)
    per_sample_flops = 2.0 * w.chi * w.chi * w.d
    per_sample_t = per_sample_flops / (hw.peak_flops * efficiency)
    return int(t_io / per_sample_t) + 1


def shard_wire_bytes(w: Workload, hosts: int, *, block: int,
                     storage_bytes: int = 2, env_bytes: int = 8,
                     sample_bytes: int = 4) -> dict:
    """Interconnect bytes of a full chain walk: the §3.1 broadcast of every
    Γ segment to hosts−1 peers, against the chain-sharded plane that hands
    the (N, χ) env across each block boundary and gathers the samples
    once."""
    gamma_site = w.chi * w.chi * w.d * storage_bytes
    broadcast = (hosts - 1) * w.n_sites * gamma_site
    n_blocks = -(-w.n_sites // block)
    boundaries = n_blocks - 1 if hosts > 1 else 0
    handoff = boundaries * w.n_samples * w.chi * env_bytes
    gather = ((hosts - 1) * w.n_samples * w.n_sites * sample_bytes
              if hosts > 1 else 0)
    return {
        "broadcast_bytes": broadcast,
        "handoff_bytes": handoff,
        "gather_bytes": gather,
        "sharded_bytes": handoff + gather,
    }


def job_admission_cost(w: Workload, hw: Hardware, n_batches: int = 1,
                       efficiency: float = 0.5) -> dict:
    """Modelled footprint of one job for admission control: Eq. 3's
    resident bytes of one live macro batch, and the modelled walk seconds
    over its batches."""
    return {
        "resident_bytes": eq3_memory(w),
        "compute_s": n_batches * w.n_sites * t_site_compute(
            w, hw, w.macro_batch, efficiency),
    }
