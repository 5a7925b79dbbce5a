"""Comm telemetry of the port.

So far only :mod:`.registry`'s histogram core, which the serving gauges
(``serving/stats.py``) read their percentiles from.  The event ring,
the snapshots, the exporter and ``t4j-top`` come with ROADMAP Queue 1
item 10, which fills in this package rather than keeping a second copy.
"""

from . import registry
from .registry import Histogram, log2_bucket

__all__ = ["Histogram", "log2_bucket", "registry"]
