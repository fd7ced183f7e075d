"""Hand-written CUDA kernels for Hopper, one package per kernel:
ref.py (plain PyTorch version), kernel.py (CUDA launcher), ops.py
(counting wrapper).  Sources live in ../csrc; build.py builds and loads them.

Each wrapper carries ``launches``, a plain int it raises by one per kernel
launch (never on the CPU path), and ``capture``: None, or a list to which
each launch appends its ``(args, kwargs)`` so a caller can replay the
inputs a forward handed the kernel.
"""

__all__ = ["note_launch"]


def note_launch(wrapper, args: tuple, kwargs: dict) -> None:
    """Count one launch of ``wrapper``'s kernel and capture its inputs."""
    wrapper.launches += 1
    if wrapper.capture is not None:
        wrapper.capture.append((args, kwargs))
