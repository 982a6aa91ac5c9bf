"""train_img_per_s: images learned over the window's fits (rows × (epochs
× depth + 1) a fit), over the time from the window's start to the end of
its last fit, host clock.  Each fit's data preparation and copy count."""


def read(r):
    if not r.units or "images" not in r.units[0]:
        return None
    return sum(u.get("images", 0) for u in r.units) / r.window_s
