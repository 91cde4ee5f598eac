"""The control's precision: TF32, the step below the float32 "highest"
path that the configurations state. On the card the TF32 flags of
cuBLAS and cuDNN are switched on; on the CPU, which has no TF32, every
convolution and dense layer of the model rounds its input and its weight
to TF32 (10 mantissa bits, round to nearest even) instead, which is what
a TF32 product does to its operands."""

import contextlib

import torch


def round_tf32(x):
    """float32 -> the nearest TF32 value, as float32."""
    bits = x.float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def tf32(model):
    """Run ``model`` (a module on one device) in TF32 inside the block."""
    dev = next(model.parameters()).device
    if dev.type == "cuda":
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        return
    layers = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    saved = [m.weight.detach().clone() for m in layers]
    with torch.no_grad():
        for m in layers:
            m.weight.copy_(round_tf32(m.weight))
    hooks = [m.register_forward_pre_hook(lambda mod, args: (round_tf32(args[0]),) + args[1:])
             for m in layers]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        with torch.no_grad():
            for m, w in zip(layers, saved):
                m.weight.copy_(w)
