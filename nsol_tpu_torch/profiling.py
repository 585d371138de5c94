"""Tracing (counterpart of ``nsol_tpu/profiling.py``).

The reference's only instrumentation is wall-clock timing around
``Solver._run`` (nsol/solver.py:152-166). :func:`trace` wraps a solve in
``torch.profiler``: the host's operators and, where torch sees a GPU, the
kernels on the card (CUPTI), the hand-written ones launched through the
port's C entries among them. The trace is a Chrome-trace JSON file, which
Perfetto (ui.perfetto.dev) and ``chrome://tracing`` open. :func:`annotate`
marks a region inside a trace.

The profiler observes; it does not change what runs: a traced solve takes
the route, the storage and the launch sequence of the same solve untraced.
"""

import contextlib
import os
import time

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(log_dir, create_perfetto_link=False):
    """Trace the enclosed computation into a Chrome-trace JSON file in
    ``log_dir`` (created where absent), named after the process and the
    time. ``create_perfetto_link=True`` prints that file's path, to open in
    Perfetto; the reference serves a link instead, which needs a network.

    The first trace of a process keeps every kernel record. A later one,
    with CUPTI kept alive between traces (torch's default), may lose its
    earliest kernel records, more of them the longer ago that first trace
    was (F7 in ROADMAP.md); a CLI's ``--trace`` is its process's first.

    Example::

        with profiling.trace("/tmp/nsol_trace"):
            solver.run()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "nsol_tpu_torch_%d_%d.pt.trace.json"
                        % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print("trace written to %s (open it at https://ui.perfetto.dev)"
              % path)


def annotate(name):
    """A named region inside a trace (``torch.profiler.record_function``);
    outside a trace it records nothing."""
    from torch.profiler import record_function

    return record_function(name)
