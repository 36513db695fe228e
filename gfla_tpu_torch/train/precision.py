"""Mixed precision: float32 master parameters, a compute dtype for the math.

Counterpart of gfla_tpu/train/precision.py. gfla_tpu casts the f32 master
parameters (and the spectral-norm state) to the compute dtype inside the
differentiated function, so that the cast's transpose sums each gradient
back into f32, and casts the outputs and the updated state back to f32
(gfla_tpu/tasks/pose.py:145-181). `cast_call` does the same for a module:
for the length of one call, every floating parameter and buffer of each of
its modules is replaced by a copy cast to the compute dtype (a
differentiable cast, so the gradients reach the f32 parameters), and the
floating inputs are cast; the outputs come back in f32, and a buffer the
call rebinds (a spectral-norm u) is stored back in f32. The swap is made
once per module, so a module registered under two names (the original's
`Jump.conv1`) is cast once. Optimizer state and checkpoints stay f32.

Not `torch.autocast`: it casts per operation and keeps some operations in
f32 that gfla_tpu runs in the compute dtype, so it could not be held against
gfla_tpu.
"""

from __future__ import annotations

import torch


def compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name in ("bfloat16", "bf16") else torch.float32


def cast_tree(tree, dtype: torch.dtype):
    """Every floating tensor of a nest of lists, tuples and dicts cast to
    `dtype`; other tensors and leaves untouched."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(t, dtype) for t in tree)
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree


def to_f32(tree):
    return cast_tree(tree, torch.float32)


def cast_call(module: torch.nn.Module, dtype: torch.dtype, *args, **kwargs):
    """`module(*args, **kwargs)` computed in `dtype`, outputs in f32. In
    float32 it is the plain call."""
    if dtype == torch.float32:
        return module(*args, **kwargs)
    swapped = []
    for m in module.modules():  # each module once
        for store in (m._parameters, m._buffers):
            for name, t in store.items():
                if t is not None and t.is_floating_point():
                    swapped.append((store, name, t, t.to(dtype)))
                    store[name] = swapped[-1][3]
    try:
        out = module(*cast_tree(args, dtype), **cast_tree(kwargs, dtype))
    finally:
        for store, name, orig, cast in swapped:
            now = store[name]
            store[name] = orig if now is cast else to_f32(now)
    return to_f32(out)
