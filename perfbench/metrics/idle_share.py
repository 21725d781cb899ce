"""The window's share of time in which no device operation ran: one less
the device time per request, from the traced stretch, times the
window's requests per second.

The stretch's own busy share would read the profiler's cost to the host
as idle time: a closed loop completes fewer solves a second under it.
The device time a request takes does not depend on how fast the host
issues it, so it is taken from the trace and scaled by the rate of the
untraced window.  On a cell of several cards the device time is the
mean card's, so this is the mean card's idle share."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("requests") or not rec.get("attempted"):
        return None
    per_request = prof["busy_s"] / prof["requests"]
    return 1.0 - per_request * rec["attempted"] / rec["window_s"]
