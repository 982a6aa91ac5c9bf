"""h2d_ms.fit: the program's copies of a fit's padded arrays to the card,
ms a fit over the window's fits: the span ``repro_torch.fit.h2d`` of each
fit's report (``repro_torch/obs.py``), host clock, which ends when the
blocking copies have."""
from hbench import program


def read(r):
    reports = program.fit_reports(r.units)
    if not reports:
        return None
    return 1e3 * sum(f.h2d[1] - f.h2d[0] for f in reports) / len(reports)
