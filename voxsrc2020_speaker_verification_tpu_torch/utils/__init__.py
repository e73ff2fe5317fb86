"""Small utilities of the port."""

import os


def resolve_num_workers(requested=None, cores=None):
    """Default worker/thread count of the host feeder pools: min(4, host
    cores), floor 1 (a fixed 4 on a 2-core host oversubscribes the threads
    that drive the device); explicit values pass through. ``cores`` honors
    the process's CPU affinity (sched_getaffinity) where the platform has
    it, else os.cpu_count()."""
    if requested is not None:
        return requested
    if cores is None:
        try:
            cores = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):
            cores = os.cpu_count() or 4
    return max(1, min(4, cores))
