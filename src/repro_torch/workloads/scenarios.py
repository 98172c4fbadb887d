"""Scenario runner: end-to-end workloads as self-scoring harnesses
(``repro.workloads.scenarios``).

A *scenario* is a named build → sample → score pipeline: build a model
MPS with the port's builders (the reference's chain for the same key),
sample it through the port's public session, and score the output against
an exact oracle or a task metric.  Each run makes one trajectory record
with the reference's schema (``bench``, ``utc``, ``config``, then the
result), appended to ``json_path`` when one is given.

Shipped scenarios
-----------------
``gbs``
    A GBS-like linear MPS; empirical per-site marginals against
    :func:`repro_torch.core.mps.exact_site_marginals`.
``conditional_marginals``
    Clamp one site, estimate the conditional marginals of the other sites
    with the per-sample ``log_prob`` weights, and compare them with the
    conditionals of the exact joint restricted to the clamped branch.
``mnist_classify_generate``
    4×4 binary digit prototypes: one product-form MPS per class (pixel
    flip noise 0.1), samples from each, each sample classified by its
    per-class log-likelihood.

The sessions run on ``ScenarioConfig.device`` (the card unless ``"cpu"``
is asked for); the ``dp`` scheme runs on a mesh over the job's ranks (a
one-rank group, made for the call and destroyed after it, when no group
exists), as the sampling CLI makes one.  Register new scenarios with the
:func:`scenario` decorator; ``python -m repro_torch.launch.scenarios``
picks them up from the registry.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["ScenarioConfig", "ScenarioResult", "available_scenarios",
           "run_scenario", "scenario"]


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """Runner knobs shared by every scenario (scenario-specific sizes are
    fixed by the scenario itself so scores stay comparable across runs)."""

    n_samples: int = 4000
    seed: int = 0
    backend: str = "inmem"        # "inmem" | "streamed"
    scheme: str = "seq"           # "seq" | "dp"
    json_path: Optional[str] = None   # trajectory file (None/"" = no append)
    device: Optional[str] = None      # None: the CUDA card; "cpu" on request


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    name: str
    passed: bool
    score: float                  # scenario-native quality number
    threshold: float              # pass bar (direction is per-metric)
    wall_s: float
    metrics: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- registry -----------------------------------------------------------------

_REGISTRY: dict[str, Callable] = {}


def scenario(name: str, summary: str):
    """Register ``fn(cfg: ScenarioConfig) -> (passed, score, threshold,
    metrics)`` under ``name``."""
    def deco(fn):
        fn.scenario_name = name
        fn.summary = summary
        _REGISTRY[name] = fn
        return fn
    return deco


def available_scenarios() -> dict[str, str]:
    """{name: one-line summary} for the CLI and docs."""
    return {n: f.summary for n, f in sorted(_REGISTRY.items())}


def _append_record(json_path: Optional[str], bench: str, config: dict,
                   **payload) -> dict:
    """One trajectory record, the reference's schema; appended to
    ``json_path`` when one is given."""
    record = {
        "bench": bench,
        "utc": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "config": config,
        **payload,
    }
    if not json_path:
        return record
    trajectory = []
    if os.path.exists(json_path):
        with open(json_path) as f:
            trajectory = json.load(f)
    trajectory.append(record)
    with open(json_path, "w") as f:
        json.dump(trajectory, f, indent=1)
    return record


def run_scenario(name: str, cfg: Optional[ScenarioConfig] = None
                 ) -> ScenarioResult:
    """Run one registered scenario and append its trajectory row."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; available: "
                       f"{sorted(_REGISTRY)}")
    cfg = cfg or ScenarioConfig()
    t0 = time.perf_counter()
    passed, score, threshold, metrics = _REGISTRY[name](cfg)
    wall = time.perf_counter() - t0
    result = ScenarioResult(name=name, passed=bool(passed),
                            score=float(score), threshold=float(threshold),
                            wall_s=wall, metrics=metrics)
    _append_record(
        cfg.json_path, "scenario",
        {"scenario": name, "n_samples": cfg.n_samples, "seed": cfg.seed,
         "backend": cfg.backend, "scheme": cfg.scheme},
        passed=result.passed, score=result.score,
        threshold=result.threshold, wall_s=round(wall, 4), metrics=metrics)
    return result


# -- shared sampling helper ---------------------------------------------------

@contextmanager
def _mesh(cfg: ScenarioConfig, device: torch.device):
    """The ``dp`` scheme's mesh over the job's ranks (a one-rank group when
    there is none, destroyed on exit); None for ``seq``."""
    if cfg.scheme != "dp":
        yield None
        return
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    created = init_distributed(device)
    try:
        yield make_mesh(1, device)
    finally:
        if created:
            dist.destroy_process_group()


def _sample(mps, n: int, cfg: ScenarioConfig, clamp=None):
    """One session run through the PUBLIC API → (samples (N, M), stats).

    ``backend="streamed"`` round-trips the MPS through a temporary
    full-precision GammaStore, so the scenario drives the segment walker
    and the digest-manifest path rather than the in-memory walk.
    """
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.device import resolve_device

    device = resolve_device(cfg.device)
    mps = mps.to(device)
    config = api.SamplerConfig(scheme=cfg.scheme, backend=cfg.backend,
                               clamp=clamp)
    key = prng.key(cfg.seed + 1)
    with _mesh(cfg, device) as mesh:
        if cfg.backend == "streamed":
            dt = mps.gammas.dtype
            with tempfile.TemporaryDirectory(prefix="scenario_store_") as tmp:
                with GammaStore(os.path.join(tmp, "store"), storage_dtype=dt,
                                compute_dtype=dt) as store:
                    store.write_mps(mps)
                    store.write_digest_manifest()
                    with api.SamplingSession(store, config, device=device,
                                             mesh=mesh) as session:
                        out = session.sample(n, key)
                        return np.asarray(out), dict(session.stats)
        with api.SamplingSession(mps, config, device=device,
                                 mesh=mesh) as session:
            out = session.sample(n, key)
            return np.asarray(out), dict(session.stats)


# -- scenarios ----------------------------------------------------------------

@scenario("gbs", "GBS workload: empirical site marginals vs exact oracle")
def _gbs(cfg: ScenarioConfig):
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    sites, chi, d = 8, 4, 3
    mps = M.gbs_like_mps(prng.key(cfg.seed), sites, chi, d, device="cpu")
    samples, _ = _sample(mps, cfg.n_samples, cfg)
    exact = M.exact_site_marginals(mps)
    emp = np.stack([(samples == s).mean(axis=0) for s in range(d)], axis=1)
    err = float(np.abs(emp - exact).max())
    threshold = 0.05   # ~4.5σ at N=4000 for a worst-case p=0.5 cell
    return err < threshold, err, threshold, {
        "sites": sites, "chi": chi, "d": d,
        "mean_photons": float(samples.mean())}


@scenario("conditional_marginals",
          "clamped sampling vs exact conditionals (the tentpole gate)")
def _conditional_marginals(cfg: ScenarioConfig):
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    sites, chi, d = 6, 4, 3
    clamp_site, clamp_val = 2, 1
    mps = M.random_linear_mps(prng.key(cfg.seed), sites, chi, d,
                              device="cpu")
    samples, stats = _sample(mps, cfg.n_samples, cfg,
                             clamp={clamp_site: clamp_val})
    if not np.all(samples[:, clamp_site] == clamp_val):
        return False, float("inf"), 0.0, {"error": "clamp not enforced"}
    lp = np.asarray(stats["log_prob"], dtype=np.float64)
    w = np.exp(lp)

    # oracle: restrict the exact joint to the clamped branch, renormalize
    joint = M.enumerate_probabilities(mps)
    outs = np.array(list(itertools.product(range(d), repeat=sites)))
    sel = outs[:, clamp_site] == clamp_val
    cond = joint[sel] / joint[sel].sum()
    outs_c = outs[sel]

    # estimator: self-normalized importance weights.  w = P(branch) per
    # sample, identical across samples for a scalar clamp, so this reduces
    # to plain frequencies — but the weighted form is what generalizes to
    # per-sample clamps, so score THAT path.
    err = 0.0
    for i in range(sites):
        if i == clamp_site:
            continue
        for s in range(d):
            est = float(w[samples[:, i] == s].sum() / w.sum())
            exact = float(cond[outs_c[:, i] == s].sum())
            err = max(err, abs(est - exact))
    # the branch-marginal estimate: E[w] = P(clamp); w varies only through
    # the sampled prefix s_{<clamp}, so the MC error is tiny but not zero
    p_branch = float(joint[sel].sum())
    branch_err = abs(float(w.mean()) - p_branch)
    threshold = 0.05
    return (err < threshold and branch_err < 5e-3), err, threshold, {
        "clamp": {str(clamp_site): clamp_val},
        "p_branch_exact": p_branch, "p_branch_est": float(w.mean()),
        "branch_err": branch_err}


#: 4×4 binary digit prototypes (one per class) for the generate/classify
#: loop — distinct in ≥ 5 pixels pairwise, so flip noise 0.1 is separable
_DIGITS = {
    0: ("1111", "1001", "1001", "1111"),
    1: ("0010", "0110", "0010", "0111"),
    2: ("1110", "0010", "0100", "1111"),
    3: ("1111", "0001", "0111", "1110"),
}
_FLIP = 0.1


def _digit_mps(cls: int):
    """Class prototype → a product-form linear MPS over 16 binary sites:
    ``gammas[i, 0, 0, s] = p_i(s)`` with flip noise, everything else 0
    (χ=2 embedding; only bond index 0 is reachable from the boundary)."""
    from repro_torch.core.mps import MPS
    bits = [int(b) for row in _DIGITS[cls] for b in row]
    g = np.zeros((16, 2, 2, 2))
    for i, b in enumerate(bits):
        g[i, 0, 0, b] = 1.0 - _FLIP
        g[i, 0, 0, 1 - b] = _FLIP
    return (MPS(torch.from_numpy(g), torch.ones((16, 2), dtype=torch.float64),
                "linear"), bits)


def _digit_loglik(samples: np.ndarray, bits: list[int]) -> np.ndarray:
    """(N, 16) binary samples → per-sample log-likelihood under a class."""
    proto = np.asarray(bits)[None, :]
    match = samples == proto
    return np.where(match, np.log(1.0 - _FLIP), np.log(_FLIP)).sum(axis=1)


@scenario("mnist_classify_generate",
          "per-class digit MPS: generate samples, classify by log-likelihood")
def _mnist(cfg: ScenarioConfig):
    per_class = max(cfg.n_samples // (4 * 8), 25)   # cheap: 4 full sessions
    all_samples, labels, protos = [], [], {}
    for cls in sorted(_DIGITS):
        mps, bits = _digit_mps(cls)
        protos[cls] = bits
        sub = dataclasses.replace(cfg, seed=cfg.seed + 17 * (cls + 1))
        samples, _ = _sample(mps, per_class, sub)
        all_samples.append(samples)
        labels.append(np.full(len(samples), cls))
    samples = np.concatenate(all_samples)
    labels = np.concatenate(labels)
    loglik = np.stack([_digit_loglik(samples, protos[c])
                       for c in sorted(protos)], axis=1)
    pred = loglik.argmax(axis=1)
    acc = float((pred == labels).mean())
    threshold = 0.9
    flip_rate = float(np.concatenate([
        s != np.asarray(protos[c])[None, :]
        for s, c in zip(all_samples, sorted(protos))], axis=0).mean())
    return acc >= threshold, acc, threshold, {
        "per_class": per_class, "classes": len(protos),
        "observed_flip_rate": flip_rate, "nominal_flip_rate": _FLIP}
