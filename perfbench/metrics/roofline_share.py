"""The solves' work bytes (:mod:`perfbench.work`) in the traced stretch at
the HBM bandwidth of the cell's cards (``chips`` times one card's), over
the device's busy time there (the mean card's), in %."""
from perfbench.peaks import peak


def read(rec):
    prof = rec.get("profile")
    bw = peak(rec.get("device_kind", ""), "hbm_bytes_per_s")
    if not prof or not prof.get("iterations") or not bw \
            or prof["busy_s"] <= 0:
        return None
    least_s = (rec["work_bytes_per_iter"] * prof["iterations"]
               / (rec["chips"] * bw))
    return least_s / prof["busy_s"] * 100.0
