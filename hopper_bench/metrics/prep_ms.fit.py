"""prep_ms.fit: a fit's time outside its epoch programs, ms a fit: the
benchmark's span around ``Trainer.fit`` less the ``unsup_s`` and ``sup_s``
the fit reports (padding, the host-to-device copies, the programs'
look-ups), averaged over the window's fits."""


def read(r):
    fits = [u for u in r.units if "fit_s" in u]
    if not fits:
        return None
    return 1e3 * sum(u["fit_s"] - u["unsup_s"] - u["sup_s"]
                     for u in fits) / len(fits)
