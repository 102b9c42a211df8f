"""Shared small helpers; structured tracing lives in :mod:`.trace`."""

import torch

__all__ = ["on_device", "pow2_at_least", "resolve_device", "round_up"]


def round_up(x, m):
    """Smallest multiple of ``m`` >= ``x``: the alignment rule of the
    chain geometry (halos, lead and tail are whole 128-sample frames)."""
    return -(-int(x) // int(m)) * int(m)


def pow2_at_least(n):
    """Smallest power of two >= ``n`` (>= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length() if n > 1 else 1


def resolve_device(device=None):
    """The device an entry point runs on: the CUDA card unless the caller
    names another.  Raises RuntimeError when CUDA is asked for (or left as
    the default) and not available; ``device="cpu"`` runs the plain
    versions on the host."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"audian_torch runs on CUDA by default, and CUDA is not "
            f"available (device {device}); pass device='cpu' to run the "
            f"plain versions on the host")
    return device


def on_device(x, device=None):
    """``x`` as a tensor: a tensor stays on its device unless ``device``
    names another; host data (numpy, lists) goes to
    :func:`resolve_device`'s device, the CUDA card by default."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))
