"""Global runtime numerics configuration and device resolution.

The framework keeps float32 params; what varies is how float32 products run
on the card:

- ``"highest"`` (default): true fp32 matmul and convolution — TF32 off for
  both ``torch.backends.cuda.matmul`` and ``torch.backends.cudnn`` (cuDNN's
  own default is TF32 ON, which would break f32 parity with the reference);
- ``"high"`` / ``"default"``: TF32 allowed — the throughput modes.

``set_precision()`` is process-wide; ``precision_scope()`` is context-local
for the precision NAME (a ContextVar), and applies the torch TF32 flags for
the duration of the block, restoring them on exit. The torch flags are
process-global, so concurrent scopes in different threads share them.
"""

import contextlib
import contextvars

import torch

_PRECISIONS = ("default", "high", "highest")

_process_default = ["highest"]
_precision = contextvars.ContextVar("v2f_precision")


def _apply_tf32(name):
    allow = name != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def set_precision(name: str):
    if name not in _PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    _process_default[0] = name
    _apply_tf32(get_precision_name())


def get_precision_name():
    return _precision.get(None) or _process_default[0]


@contextlib.contextmanager
def precision_scope(name: str):
    if name not in _PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    token = _precision.set(name)
    _apply_tf32(name)
    try:
        yield
    finally:
        _precision.reset(token)
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def resolve_device(device=None):
    """``None`` means the card. Without a CUDA device that raises: nothing
    quietly carries on on the CPU — pass ``device="cpu"`` to ask for it."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" (CLI: -d cpu) "
            "to run on the CPU")
    return device


# the process default ("highest") holds from import on
_apply_tf32(_process_default[0])
