"""unsup_step_us.fit: the fit's ``unsup_s`` over its unsupervised steps,
us a step, over the window's fits: a replayed step's wall time, the
padded tail's eager step and the epochs' synchronisations included."""


def read(r):
    fits = [u for u in r.units if "unsup_steps" in u]
    if not fits:
        return None
    return 1e6 * (sum(u["unsup_s"] for u in fits)
                  / sum(u["unsup_steps"] for u in fits))
