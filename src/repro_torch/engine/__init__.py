"""The streamed data plane: :class:`StreamingEngine` walks a chain from a
:class:`~repro_torch.data.gamma_store.GammaStore` segment by segment, and
:func:`plan_stream` sizes its segments.  Applications reach it through
:class:`repro_torch.api.SamplingSession` (``backend="streamed"``)."""
from repro_torch.engine.planner import explain_plan, plan_stream
from repro_torch.engine.streaming import StreamPlan, StreamingEngine

__all__ = ["StreamPlan", "StreamingEngine", "plan_stream", "explain_plan"]
