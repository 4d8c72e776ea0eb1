"""Where the Pallas kernels run: one decision for the whole package.

The kernels are written for the GPU through Triton. On a GPU they are
compiled; on the CPU (the test lane) they run in Pallas interpret mode.
Any other platform has no kernel route and raises — a kernel never falls
back to the interpreter or to a reference on an accelerator.
"""
from __future__ import annotations

import jax


def kernel_mode(platform: str | None = None) -> str:
    """"compile" on ``gpu``, "interpret" on ``cpu``; raises otherwise."""
    platform = jax.default_backend() if platform is None else platform
    if platform == "gpu":
        return "compile"
    if platform == "cpu":
        return "interpret"
    raise RuntimeError(
        f"no Pallas kernel route for platform {platform!r}: the kernels "
        f"compile for 'gpu' and are interpreted on 'cpu'")


def interpret() -> bool:
    """The ``interpret=`` argument for every ``pallas_call``."""
    return kernel_mode() == "interpret"
