"""captures.fit: the steps a fit's epoch programs captured, over the
window's fits (``StepProgram.captures``, summed by each fit's report in
``repro_torch/obs.py``).  Fits on one trainer re-use their captures, so
anything above 0 is a re-capture a fit."""
from hbench import program


def read(r):
    reports = program.fit_reports(r.units)
    if not reports:
        return None
    return sum(f.captures for f in reports) / len(reports)
