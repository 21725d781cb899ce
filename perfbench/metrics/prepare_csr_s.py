"""Seconds of the host transition CSR (``build_transition_csr``) of the
``ell`` tiers: the program's span ``prepare.csr`` inside ``prepare``, the
engine's constructor."""
from perfbench.spans import phase_s


def read(rec):
    return phase_s("prepare.csr")
