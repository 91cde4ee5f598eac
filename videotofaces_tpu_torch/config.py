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
process-global, so every model call (the detectors' ``submit``, the
encoders' ``__call__``) runs inside ``model_call()``: under one process
lock, it sets the flags from ITS thread's precision name, launches, and
restores them. A model call in one thread thus runs under its own
precision whatever scope another thread holds; plain tensor ops outside a
model call still see the process-global flags.
"""

import contextlib
import contextvars
import threading

import torch

_PRECISIONS = ("default", "high", "highest")

_process_default = ["highest"]
_precision = contextvars.ContextVar("v2f_precision")
# serializes every change of the process-global TF32 flags with the model
# calls that read them (reentrant: a model call may open a scope inside)
_flags_lock = threading.RLock()


def _apply_tf32(name):
    allow = name != "highest"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32_flags(flags):
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def set_precision(name: str):
    if name not in _PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    _process_default[0] = name
    with _flags_lock:
        _apply_tf32(get_precision_name())


def get_precision_name():
    return _precision.get(None) or _process_default[0]


@contextlib.contextmanager
def precision_scope(name: str):
    if name not in _PRECISIONS:
        raise ValueError(f"unknown precision {name!r}")
    with _flags_lock:
        saved = _tf32_flags()
        _apply_tf32(name)
    token = _precision.set(name)
    try:
        yield
    finally:
        _precision.reset(token)
        with _flags_lock:
            _set_tf32_flags(saved)


@contextlib.contextmanager
def model_call():
    """Run a model call under the TF32 flags of the calling thread's
    precision name, holding the process lock so that no other thread's
    scope or model call changes them until the launches are queued."""
    with _flags_lock:
        saved = _tf32_flags()
        _apply_tf32(get_precision_name())
        try:
            yield
        finally:
            _set_tf32_flags(saved)


def resolve_device(device=None):
    """``None`` means the card. Without a CUDA device that raises: nothing
    quietly carries on on the CPU — pass ``device="cpu"`` to ask for it.
    A CUDA device without an index gets the calling thread's current one,
    so that every later launch, copy and event names the same card
    whichever thread makes it."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" (CLI: -d cpu) "
                "to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


# the process default ("highest") holds from import on
_apply_tf32(_process_default[0])
