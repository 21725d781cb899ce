"""The port's registry held to the JAX package's: the port alone times the
phases of the engine's constructor (the spans ``prepare.dedupe``,
``prepare.keys``, ``prepare.csr``, ``prepare.pack`` and
``prepare.upload`` inside ``prepare``), so a parity test compares
everything the JAX engine emits with the port's instruments minus
those."""

PORT_ONLY_SPANS = frozenset({"prepare.dedupe", "prepare.keys",
                             "prepare.csr", "prepare.pack",
                             "prepare.upload"})


def shared_histograms(exported: dict) -> set:
    """The histogram names of an ``as_dict()`` export, minus those of the
    port-only spans."""
    return {k for k in exported["histograms"]
            if k.removeprefix("span.") not in PORT_ONLY_SPANS}


def shared_events(registry) -> list[dict]:
    """The registry's events, minus those of the port-only spans."""
    return [e for e in registry.events
            if not (e["kind"] == "span" and e["name"] in PORT_ONLY_SPANS)]
