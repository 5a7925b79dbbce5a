"""Continuous-batching inference serving (docs/serving.md).

The port's counterpart of ``mpi4jax_tpu/serving/``: a request queue and
slot-based batch scheduler (:mod:`.scheduler`) admit prefills into free
KV slots while in-flight decodes continue; a deadline-aware admission
controller (:mod:`.admission`: token bucket + SLO estimator fed by the
transport's worst-link gauges) sheds load before it blows the p99
target; a seeded open-loop Poisson load generator (:mod:`.loadgen`)
drives the loop ``benchmarks/serving.py`` measures.

* The **pure core** (:mod:`.request`, :mod:`.scheduler`,
  :mod:`.admission`, :mod:`.loadgen`, :mod:`.plan`, :mod:`.stats`,
  :mod:`.autoscale`) is the JAX package's, copied: the same seed gives
  the same requests, plans, plan words, verdicts and gauges.
* The **engine** (:mod:`.engine`, imported lazily) runs the transformer
  (``models/transformer.py``) as a tensor-parallel continuous-batching
  decoder: on one rank, or across the proc ranks of a launcher job,
  where rank 0 is the frontend and every rank executes the broadcast
  step plan (:mod:`.plan`).

Knobs (``utils/config.py``): ``T4J_SLO_MS`` (the p99 latency target),
``T4J_MAX_BATCH`` (decode slots), ``T4J_ADMIT`` (``off`` | ``on``);
``python -m mpi4jax_tpu_torch.launch --serve`` wires them.  The
autoscale policy (:mod:`.autoscale`) is here; the engine's elastic
epochs and its autoscale wiring come with ROADMAP Queue 1 item 19.
"""

from . import admission, autoscale, loadgen, plan, request, scheduler, stats
from .admission import (
    AdmissionController,
    SLOEstimator,
    TokenBucket,
    degradation_factor,
)
from .autoscale import Autoscaler
from .loadgen import LoadGen
from .plan import (
    PlanError,
    decode_plan,
    encode_plan,
    plan_words,
    rebuild_mirror,
)
from .request import Request, RequestState
from .scheduler import (
    FollowerMirror,
    SchedulerError,
    SlotScheduler,
    StepPlan,
    slots_digest,
)
from .stats import ServingStats, current, publish

__all__ = [
    "AdmissionController",
    "Autoscaler",
    "FollowerMirror",
    "LoadGen",
    "PlanError",
    "Request",
    "RequestState",
    "SLOEstimator",
    "SchedulerError",
    "ServingStats",
    "SlotScheduler",
    "StepPlan",
    "TokenBucket",
    "admission",
    "autoscale",
    "current",
    "decode_plan",
    "degradation_factor",
    "encode_plan",
    "engine",
    "loadgen",
    "plan",
    "plan_words",
    "publish",
    "rebuild_mirror",
    "request",
    "scheduler",
    "slots_digest",
    "stats",
]


def __getattr__(name):
    # the engine imports torch and the model; the pure core does not
    if name == "engine":
        import importlib

        return importlib.import_module(__name__ + ".engine")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
