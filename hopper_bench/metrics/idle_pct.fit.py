"""idle_pct.fit: the share of a fit in which no kernel, copy or fill ran on
the card, %: 1 - (device busy time a traced fit, from the profiler's
trace) / (host time a fit over the window's untraced fits).  The untraced
fits give the length: the profiler's own host work lengthens the traced
ones and leaves the card's work as it was."""


def read(r):
    if r.trace is None or not r.traced:
        return None
    rest = r.units[len(r.traced):]
    if not rest or r.trace.busy_s <= 0:
        return None
    busy = r.trace.busy_s / len(r.traced)
    length = (rest[-1]["t1"] - rest[0]["t0"]) / len(rest)
    return 100.0 * (1.0 - busy / length)
