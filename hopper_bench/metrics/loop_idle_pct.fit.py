"""loop_idle_pct.fit: the share of a fit's epoch loop in which no kernel,
copy or fill ran on the card, %: 1 - (device busy time inside the traced
fits' ``repro_torch.fit.unsup`` and ``repro_torch.fit.sup`` spans, a fit)
/ (the length of those spans a fit over the window's untraced fits).  The
spans are the phases of each fit's report (``repro_torch/obs.py``), placed
on the profiler's clock by the unit's range; the program's own ranges are
not work (``hbench/program.py::work``).  As in ``idle_pct.fit``, the
untraced fits give the length: the profiler's host work lengthens the
traced ones and leaves the card's work as it was."""
from hbench import program


def read(r):
    if r.trace is None or not r.traced:
        return None
    traced = program.fit_reports(r.traced)
    rest = program.fit_reports(r.units[len(r.traced):])
    busy = program.work(r.trace).busy_intervals()
    if not traced or not rest or not busy:
        return None
    loop_busy = 0.0
    for (r0, _), u, f in zip(r.trace.units, r.traced, traced):
        off = r0 - u["t0"] * 1e6
        a, b = f.unsup[0] * 1e6 + off, f.sup[1] * 1e6 + off
        loop_busy += (b - a) - program.idle_us(busy, a, b)
    length = 1e6 * sum(f.sup[1] - f.unsup[0] for f in rest) / len(rest)
    return 100.0 * (1.0 - loop_busy / len(traced) / length)
