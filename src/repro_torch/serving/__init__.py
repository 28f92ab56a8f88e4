"""The serving path: slot-pool continuous batching with per-phase power
profiles (``engine``) and its open-loop request scheduler (``scheduler``)."""
from repro_torch.serving.engine import (  # noqa: F401
    ContinuousEngine, Prefix, Request, ServeEngine, scale_profile,
    serving_profiles)
from repro_torch.serving.scheduler import (  # noqa: F401
    ServeReport, poisson_arrivals, serve)
