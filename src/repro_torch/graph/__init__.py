from repro_torch.graph.generators import (barabasi_albert, erdos_renyi,
                                          protein_network)
from repro_torch.graph.sparse import BSRMatrix, CSRMatrix, ELLMatrix
from repro_torch.graph.transition import (build_transition_bsr,
                                          build_transition_csr,
                                          build_transition_dense,
                                          build_transition_ell,
                                          dangling_fix, dangling_mask)
from repro_torch.graph.validate import (DeadLetter, DeadLetterQueue,
                                        DeltaRejected, ValidationPolicy,
                                        ValidationResult, validate_delta)

__all__ = ["barabasi_albert", "erdos_renyi", "protein_network",
           "CSRMatrix", "ELLMatrix", "BSRMatrix", "build_transition_csr",
           "build_transition_dense", "build_transition_ell",
           "build_transition_bsr", "dangling_fix", "dangling_mask",
           "DeadLetter", "DeadLetterQueue", "DeltaRejected",
           "ValidationPolicy", "ValidationResult", "validate_delta"]
