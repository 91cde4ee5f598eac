"""Weights from the seed, made on the card in one draw: a standard normal
vector as long as every floating-point tensor of the module's state,
split and scaled by the kind of tensor (the recipe of the port's parity
tests):

- convolution and dense kernels N(0, 1 / fan_in), regression heads x 0.1;
- their biases, BatchNorm biases and means N(0, 0.1);
- BatchNorm scales 1 + N(0, 0.1) (x 0.2 on a bottleneck's last unit),
  variances 0.8 + 0.2 |N|;
- LayerNorm scales 1 + N(0, 0.02), biases N(0, 0.02); PReLU slopes
  0.25 + N(0, 0.05); anything else (tokens, position embeddings)
  N(0, 0.02).

The detector heads and the encoders' last layers are then calibrated
(``models.py``). The same state goes to the program and to the plain
reference, whose modules carry the same tensor names."""

import math

import torch


def _kinds(module):
    out = {}
    for mname, mod in module.named_modules():
        tensors = list(mod.named_parameters(recurse=False)) + list(mod.named_buffers(recurse=False))
        for pname, _ in tensors:
            out[(mname + "." if mname else "") + pname] = (type(mod).__name__, mname, pname)
    return out


def _value(z, kind, t):
    cls, mname, pname = kind
    last = mname.split(".")[-1] if mname else ""
    if "BatchNorm" in cls:
        if pname == "weight":
            return (1.0 + 0.1 * z) * (0.2 if mname.endswith("u3.bn") else 1.0)
        if pname == "running_var":
            return 0.8 + 0.2 * z.abs()
        return 0.1 * z
    if "LayerNorm" in cls:
        return (1.0 + 0.02 * z) if pname == "weight" else 0.02 * z
    if cls == "PReLU":
        return 0.25 + 0.05 * z
    if pname == "weight" and t.dim() >= 2:
        fan_in = t[0].numel()
        return z / math.sqrt(fan_in) * (0.1 if last == "reg" else 1.0)
    if pname == "bias":
        return 0.1 * z
    return 0.02 * z


@torch.no_grad()
def seed_module_(module, seed):
    """Fill ``module`` (already on its device) from ``seed``. Returns the
    module."""
    state = module.state_dict(keep_vars=True)
    kinds = _kinds(module)
    floats = [(k, t) for k, t in state.items() if t.is_floating_point()]
    dev = floats[0][1].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    z = torch.randn(sum(t.numel() for _, t in floats), generator=gen, device=dev)
    at = 0
    for k, t in floats:
        n = t.numel()
        t.copy_(_value(z[at:at + n].view(t.shape), kinds[k], t))
        at += n
    return module


def host_state(module):
    """A host copy of the module's floating-point state."""
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


@torch.no_grad()
def load_state_(module, state):
    """Copy ``state`` into ``module``'s tensors, in place (the module keeps
    its device and dtype); every tensor must be present."""
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError("state lacks %s" % ", ".join(missing[:5]))
    for k, t in own.items():
        t.copy_(state[k].to(t.device, t.dtype))
    return module
