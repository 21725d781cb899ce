"""Seconds from process start to the first timed call."""


def read(rec):
    return rec["setup_s"]
