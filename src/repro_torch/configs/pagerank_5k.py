"""The paper's own workload: PageRank over a 5000-protein network,
100 iterations, d=0.85, on the 4096-site fabric (Fig. 4C / Fig. 6B) —
plus the pod-scale variant used by the multi-pod dry-run."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PageRankConfig:
    name: str
    n_nodes: int
    n_iters: int = 100
    damping: float = 0.85
    fabric_sites: int = 4096       # Table I evaluated fabric
    avg_degree: float = 8.0
    seed: int = 0


def full() -> PageRankConfig:
    return PageRankConfig(name="pagerank-5k", n_nodes=5000)


def pod_scale() -> PageRankConfig:
    """Dense 64k-node network (H is 16 GiB in float32); kept for parity
    with the JAX package's configs, not run by the port yet."""
    return PageRankConfig(name="pagerank-65k", n_nodes=65536, n_iters=100)


def smoke() -> PageRankConfig:
    return PageRankConfig(name="pagerank-smoke", n_nodes=64, n_iters=10)
