"""Kernels of the port: each module holds a hand-written CUDA kernel's
wrapper beside its plain torch version."""

from __future__ import annotations


def check_args(want: dict, device) -> None:
    """Raise unless every tensor of `want` ({name: (tensor, shape, dtype)})
    has that shape and dtype, lies on `device` and is contiguous: what a
    kernel reading raw pointers needs."""
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {list(shape)}, got "
                             f"{t.dtype} {list(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

