"""Seconds of the engine's constructor (the layout preparation), ending
in a synchronize."""


def read(rec):
    spans = rec["spans"].get("prepare")
    return spans[0] if spans else None
