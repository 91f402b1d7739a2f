"""The optimizer of the port's training path: AdamW with a cosine schedule,
and int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, clip_by_global_norm, cosine_lr,
    global_norm,
)
from repro_torch.optim.compression import (
    EFState, apply_error_feedback, compress_int8, compressed_psum_with_feedback,
    decompress_int8, ef_init,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm", "EFState", "ef_init",
           "compress_int8", "decompress_int8", "apply_error_feedback",
           "compressed_psum_with_feedback"]
