"""Mean push sweeps (or warm-start iterations) per refresh: the program's
``UpdateInfo.iters``."""


def read(rec):
    sweeps = rec.get("sweeps", [])
    return sum(sweeps) / len(sweeps) if sweeps else None
