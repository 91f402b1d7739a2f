from repro_torch.data.synthetic import (
    dp_stick_breaking_data, bp_stick_breaking_data, separable_cluster_data,
)
from repro_torch.data.tokens import TokenPipeline, synthetic_token_batches
