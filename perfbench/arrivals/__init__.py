"""When an open loop's requests are due: one law per module, named by a
traffic file's ``"arrivals"``.  A law's ``times(traffic, seconds, rng)``
returns the due times in seconds from the start of the window, in order.
Every seed gets the same multiset of gaps in another order, so that the
seed changes which requests arrive when and never how much work a run
offers."""
