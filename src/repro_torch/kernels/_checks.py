"""Input checks shared by the language-model kernel wrappers (`rmsnorm`,
`swiglu`, `flash_attention`): the CUDA device, the element types the
kernels are compiled for, the 16-byte alignment of their packed accesses,
and the refusal of tensors that autograd would record: a kernel launched
by hand records nothing.  Training reaches the rmsnorm and swiglu kernels
through `ops`' autograd Functions, whose forward and backward run with
autograd off; flash attention has no backward."""
from __future__ import annotations

import torch

__all__ = ["DTYPE_CODES", "LM_DTYPES", "require_cuda", "require_no_grad",
           "aligned16", "stream_of"]

# The element types, as every kernel's C code numbers them (the nearest-
# center kernel takes all three).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# The types swiglu and flash_attention are compiled for (rmsnorm takes f16
# too).
LM_DTYPES = (torch.float32, torch.bfloat16)


def require_cuda(name: str, t, device: torch.device | None = None,
                 dtype: torch.dtype | None = None,
                 dtypes: tuple = LM_DTYPES) -> None:
    """`t` is a tensor on a CUDA device (that of `device` when given) of one
    of `dtypes`, the types the kernel is compiled for (`dtype` when given);
    raises TypeError or ValueError otherwise."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must lie on the CUDA device of the first "
                         f"input, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} like the first input, "
                        f"got {t.dtype}")


NO_GRAD_HINT = ("call it through kernels.ops, whose autograd Function "
                "launches the backward kernel")


def require_no_grad(hint: str = NO_GRAD_HINT, **tensors) -> None:
    """Raises if autograd would record a call on any of the tensors; the
    message ends with `hint`, what to do instead."""
    if not torch.is_grad_enabled():
        return
    for name, t in tensors.items():
        if t.requires_grad:
            raise RuntimeError(f"{name} requires a gradient and a kernel "
                               f"launched by hand records none: {hint}")


def aligned16(*tensors) -> bool:
    """Every tensor's first element is 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on t's device, as the int the C side takes."""
    return torch.cuda.current_stream(t.device).cuda_stream
