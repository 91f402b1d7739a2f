"""The paper's contribution on PyTorch: the OCC pattern + DP-means, OFL and
BP-means.

Primary entry point: `OCCEngine` running an `OCCTransaction`; the
`occ_dp_means` / `occ_ofl` / `occ_bp_means` and `serial_*` wrappers run
over the same engine and mechanism.
"""
from repro_torch.core.occ import (
    CenterPool, OCCStats, ValidatePre, make_pool, nearest_center,
    nearest_center_with_new, serial_validate, precomputed_validate,
    precomputed_validate_gram, logdepth_validate, precomputed_gather_validate,
)
from repro_torch.core.engine import (
    OCCEngine, OCCTransaction, OCCPassResult, resolve_assignments,
)
from repro_torch.core.objective import (
    sq_dists, dp_means_objective, bp_means_objective,
)
from repro_torch.core.dp_means import (
    DPMeansResult, DPMeansTransaction, serial_dp_means, serial_dp_means_pass,
    occ_dp_means, thm31_permutation,
)
from repro_torch.core.ofl import (
    OFLResult, OFLTransaction, point_uniforms, serial_ofl, occ_ofl,
)
from repro_torch.core.bp_means import (
    BPMeansResult, BPMeansTransaction, coordinate_pass, serial_bp_means,
    serial_bp_means_pass, occ_bp_means,
)
