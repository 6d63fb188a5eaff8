"""Device selection shared by every entry point of the port, and the one
way host arrays reach a device."""
from __future__ import annotations

import numpy as np
import torch

# Elements of a host array converted at once on its way to a device: 4 Mi
# elements, 32 MiB at int64, whatever the array's length.
HOST_CHUNK = 1 << 22


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``.

    Asking for CUDA where there is none raises: the port never drops quietly
    to the CPU, so a CPU run is always one the caller asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


def to_device(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """A new ``dtype`` tensor on ``device`` holding the host array ``arr``.

    The copy goes through chunks of at most :data:`HOST_CHUNK` elements,
    each converted to ``dtype`` on its own, so a memmap-backed edge array
    is paged in chunk by chunk and never needs a second resident copy in
    the target dtype (an int32 ``src`` bound for int64 costs one chunk of
    int64 on the host, not the whole array).  The tensor never aliases
    ``arr``, on the CPU either: a read-only ``np.memmap`` is neither
    shared with a writable tensor nor written."""
    src = np.asarray(arr)
    out = torch.empty(src.shape, dtype=dtype, device=device)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    flat, dst = src.reshape(-1), out.view(-1)
    for lo in range(0, flat.size, HOST_CHUNK):
        part = np.array(flat[lo:lo + HOST_CHUNK], dtype=np_dtype)  # a copy
        dst[lo:lo + part.size].copy_(torch.from_numpy(part))
    return out
