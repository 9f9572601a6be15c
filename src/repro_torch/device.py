"""Where the port's entry points run: the GPU unless asked otherwise."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device and raises when there is
    none; an explicit ``"cpu"`` (the tests) or ``"cuda:N"`` is taken
    as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU by default; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


@contextlib.contextmanager
def deterministic_cudnn(device):
    """cuDNN's deterministic algorithms on a CUDA device for the block
    (its default backward algorithms differ from run to run)."""
    if device.type != "cuda":
        yield
        return
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved
