"""bcpnn_update_us.fit: device time a launch of ``bcpnn_update``, us, in
the traced fits: the profiler's time of the kernels that the program
declares for it (``kernels/ops.py::device_kernels``) over the launches
the program counted in those fits (``kernels/ops.py::launch_counts``, by
each fit's report in ``repro_torch/obs.py``).  Where the trace holds
another number of those kernels than the program counted, nothing is
read."""
from hbench import program

ENTRY = "bcpnn_update"


def read(r):
    if r.trace is None or not r.traced:
        return None
    reports = program.fit_reports(r.traced)
    kernels = program.device_kernels(ENTRY)
    if not reports or not kernels:
        return None
    launches = sum(f.launches.get(ENTRY, 0) for f in reports)
    seconds, n = program.device_time(r.trace, kernels)
    if n == 0 or n != launches:
        return None
    return 1e6 * seconds / n
