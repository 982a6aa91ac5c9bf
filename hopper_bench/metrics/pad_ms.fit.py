"""pad_ms.fit: the program's zero-padding of a fit's rows to whole
batches on the host, ms a fit over the window's fits: the span
``repro_torch.fit.pad`` of each fit's report (``repro_torch/obs.py``),
host clock."""
from hbench import program


def read(r):
    reports = program.fit_reports(r.units)
    if not reports:
        return None
    return 1e3 * sum(f.pad[1] - f.pad[0] for f in reports) / len(reports)
