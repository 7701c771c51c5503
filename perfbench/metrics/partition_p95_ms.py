"""partition_p95_ms: the 95th percentile (linear interpolation between
order statistics) of the wall time of every call in the window; a call
transforms one partition, and a Spark stage waits for its slowest
tasks."""
import numpy as np

NAME = "partition_p95_ms"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(view):
    if not view.calls:
        return None
    return float(np.percentile([c.seconds for c in view.calls], 95)) * 1e3
