"""Seconds of the transition CSR of the ``ell`` tiers, built on the
engine's device from its edge set (one sort of the keys ``dst * n + src``;
on ``ell`` first the vertices numbered by out-degree): the program's span
``prepare.csr`` inside ``prepare``, the engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.csr")
