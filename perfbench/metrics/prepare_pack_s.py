"""Seconds of the rest of the layout's build (on ``ell``, on the device:
the budget ``k0`` from the row counts read on the host, the row positions,
the (n, k0) scatters, the overflow and the storage type): the program's
span ``prepare.pack`` inside ``prepare``, the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.pack")
