"""Observability: counters, gauges and histograms with the Prometheus text
exposition (``repro_torch.obs.metrics``), bound to the service's and the
worker pool's observer events and to ``SamplingService.stats()``."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, instrument_service)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "instrument_service"]
