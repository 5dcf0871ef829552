"""numpy encodings → torch tensors on a device.

The encoders (state/tensors.py, and the reference package's identical
ones) build numpy arrays; every device program of the port reads torch
tensors. `arrays_to_torch` is the one conversion, with a fixed dtype map, so
the tests can hand the JAX functions and their ports identical inputs.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_DTYPES = {
    np.dtype(bool): torch.bool,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def arrays_to_torch(
    arrays: Dict[str, np.ndarray], device, copy: bool = False
) -> Dict[str, torch.Tensor]:
    """Convert a dict of numpy arrays (NodeBank.arrays(), PodBatch.arrays(),
    make_ids output) to contiguous tensors on `device`. Raises TypeError on
    a dtype outside the map (bool, int16, int32, int64, float32). With copy=False a
    CPU result may share memory with the numpy input; copy=True always
    allocates (the mirror's resident copy)."""
    device = torch.device(device)
    out: Dict[str, torch.Tensor] = {}
    for k, v in arrays.items():
        a = np.asarray(v)
        dt = _DTYPES.get(a.dtype)
        if dt is None:
            raise TypeError(f"array {k!r}: dtype {a.dtype} has no torch mapping")
        if not a.flags.writeable:  # e.g. a view of an immutable buffer
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a))
        if t.dtype != dt:
            t = t.to(dt)
        out[k] = t.to(device, copy=copy)
    return out
