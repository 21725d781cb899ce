"""What each query of an open loop asks: one law per module, named by a
traffic file's ``"seed_sets"``.  A law's ``sets(count, graph, traffic,
rng)`` returns ``count`` seed sets (sorted unique vertex ids) in the order
they are sent.  Every seed gets the same multiset of set sizes and the
same quantiles of the law, in another order."""
