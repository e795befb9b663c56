"""The lower-precision control: the reference computed in bfloat16.

Under ``BFloat16Arithmetic`` every float32 arithmetic op's result (the
ops the flop counter counts, autograd's backward included) is rounded to
bfloat16, as a bfloat16 computation rounds each op's result; data
movement and integer (RNG) ops are left as they are."""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.reference.utils.flops import ELEMENTWISE, REDUCTIONS

_ARITH = ELEMENTWISE | REDUCTIONS


def _round(t):
    return t.to(torch.bfloat16).to(torch.float32)


class BFloat16Arithmetic(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        inplace = name.endswith("_") and not name.startswith("_")
        if inplace:
            name = name[:-1]
        if name not in _ARITH:
            return out
        if isinstance(out, torch.Tensor) and out.dtype == torch.float32:
            if inplace:
                return out.copy_(_round(out))
            return _round(out)
        return out
