"""Floating-point operation counts of torch code: the operations side of a
kernel's bound (the least time the card could take for its work).

The port's counterpart of the JAX package's gradkernel._count_jaxpr_flops /
kernel_flops_per_ray (gradkernel.py:816-960), in XLA's "useful flops"
convention: one flop per output element of each float arithmetic op, the
input's size for a reduction; selects, compares, copies, views, index ops
and integer (RNG) arithmetic count zero. ``FlopCounter`` counts the aten
ops that run under it, autograd's backward ops included, so counting a
kernel's plain version (plain torch, or autograd over it for the gradient
kernels) counts the work of the kernel's function. The plain versions are
dense: a masked lane (a ray that left the scene) is computed and counted
like a live one.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt", "rsqrt", "exp", "exp2",
    "log", "log2", "log1p", "expm1", "sin", "cos", "tan", "asin", "acos", "atan", "atan2",
    "pow", "abs", "sign", "sgn", "floor", "ceil", "round", "trunc", "frac", "fmod",
    "remainder", "maximum", "minimum", "fmax", "fmin", "clamp", "clamp_min", "clamp_max",
    "sigmoid", "tanh", "erf", "square", "hypot", "copysign", "lerp", "addcmul", "addcdiv",
    "sigmoid_backward", "tanh_backward",
})
REDUCTIONS = frozenset({"sum", "mean", "prod", "amax", "amin", "max", "min", "norm",
                        "linalg_vector_norm"})


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, (tuple, list)):
        return next((o for o in out if isinstance(o, torch.Tensor)), None)
    return None


def op_flops(name: str, args, out) -> int:
    """Flops of one aten op (its overload packet's name, without a trailing
    in-place underscore) with these arguments and output."""
    res = _first_tensor(out)
    if res is None or not res.dtype.is_floating_point:
        return 0
    if name in REDUCTIONS:
        src = _first_tensor(args)
        if src is not None and src.numel() > res.numel():
            return src.numel()
        return res.numel() if name in ("max", "min") else 0
    return res.numel() if name in ELEMENTWISE else 0


class FlopCounter(TorchDispatchMode):
    """``with FlopCounter() as fc: ...``; ``fc.flops`` is the count."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name.endswith("_") and not name.startswith("_"):
            name = name[:-1]
        self.flops += op_flops(name, args, out)
        return out


def count_flops(fn, *args, **kwargs) -> tuple:
    """(fn(*args, **kwargs), the flops it ran)."""
    with FlopCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.flops
