"""Workloads of the port: conditional sampling, BYO-MPS ingest, scenarios.

- :mod:`repro_torch.workloads.clamp` — the clamp spec carried on
  ``SamplerConfig.clamp`` through plan, engine and kernels; clamped sites
  force their outcome into the collapse path and the walk returns the
  clamped branch's weight as a per-sample ``log_prob``;
- :mod:`repro_torch.workloads.ingest` — an external MPS (a list of site
  tensors or an ``.npz``) canonicalised into the port's Γ/Λ form, checked
  for isometry and written to a digest-manifested ``GammaStore``;
- :mod:`repro_torch.workloads.scenarios` — named build → sample → score
  pipelines, driven by ``python -m repro_torch.launch.scenarios``.

Only :mod:`.clamp` is imported eagerly: ``repro_torch.api.config``
normalises clamp specs when a config is made, and :mod:`.scenarios`
imports the api back; the lazy attributes below keep that cycle open (as
in ``repro.workloads``).
"""
from repro_torch.workloads.clamp import (ClampSpec, clamp_map,
                                         normalize_clamp, parse_clamp_arg,
                                         segment_clamp_arrays, validate_clamp)

__all__ = ["ClampSpec", "clamp_map", "ingest", "normalize_clamp",
           "parse_clamp_arg", "scenarios", "segment_clamp_arrays",
           "validate_clamp"]


def __getattr__(name):
    if name in ("ingest", "scenarios"):
        import importlib
        return importlib.import_module(f"repro_torch.workloads.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
