"""The paper's contribution on PyTorch: the OCC pattern + DP-means.

Primary entry point: `OCCEngine` running an `OCCTransaction`; the
`occ_dp_means` / `serial_dp_means` wrappers run over the same engine.
OFL and BP-means are later slices of the port.
"""
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, make_pool, nearest_center,
    nearest_center_with_new, serial_validate, precomputed_validate,
    logdepth_validate, precomputed_gather_validate,
)
from repro_torch.core.engine import (
    OCCEngine, OCCTransaction, OCCPassResult, resolve_assignments,
)
from repro_torch.core.objective import sq_dists, dp_means_objective
from repro_torch.core.dp_means import (
    DPMeansResult, DPMeansTransaction, serial_dp_means, serial_dp_means_pass,
    occ_dp_means, thm31_permutation,
)
