"""Device selection for the port's entry points.

Every entry point takes ``device=`` and resolves it here.  The default is
the first CUDA card; asking for it on a machine without CUDA raises
instead of carrying on quietly on the CPU.  The CPU is used only when the
caller names it (the tests do), and then every kernel wrapper takes its
plain PyTorch version because the tensors it is given lie on the CPU.
"""

from __future__ import annotations

import warnings
from typing import Union

import numpy as np
import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda:0`` by default; ``"cpu"`` only when asked for by name
    (``"meta"`` too: shapes and dtypes, no memory)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cuda, cpu "
                         f"or meta)")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' to run the plain PyTorch versions explicitly")
    return torch.device("cuda", 0 if dev.index is None else dev.index)


def host_to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host table (numpy array or tensor) as a tensor on ``device``.

    Onto a card the copy goes through pinned memory and does not wait for
    earlier kernels.  Read-only numpy arrays (plan tables are frozen) are
    wrapped without a host copy; the result is only ever read."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            t = torch.as_tensor(x, dtype=dtype)
    else:
        t = torch.as_tensor(x, dtype=dtype)
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
