"""Window time over solves completed, in ms."""


def read(rec):
    done = rec.get("completed", 0)
    return rec["window_s"] / done * 1e3 if done else None
