from repro_torch.graph.generators import (barabasi_albert, erdos_renyi,
                                          protein_network)
from repro_torch.graph.sparse import CSRMatrix
from repro_torch.graph.transition import (build_transition_csr,
                                          build_transition_dense,
                                          dangling_fix, dangling_mask)

__all__ = ["barabasi_albert", "erdos_renyi", "protein_network",
           "CSRMatrix", "build_transition_csr", "build_transition_dense",
           "dangling_fix", "dangling_mask"]
