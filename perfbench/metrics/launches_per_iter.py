"""Kernel launches in the traced stretch over the iterations issued in
it."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("iterations"):
        return None
    return prof["kernels"] / prof["iterations"]
