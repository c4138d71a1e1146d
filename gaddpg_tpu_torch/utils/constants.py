"""Small constant tensors, made once per device.

A tensor built from Python numbers (`torch.tensor([...], device="cuda")`)
is a host-to-device copy that waits for the host each time; the env
step would make hundreds of them. `const` makes each once per device and
dtype and hands out the same tensor afterwards, so callers must not
write to it.
"""

import numpy as np
import torch

_cache = {}


def const(value, device, dtype=torch.float32) -> torch.Tensor:
    """`value` on `device`: a tuple of numbers (nested for a matrix), or a
    module-level numpy array (cached by identity: never pass a
    temporary array)."""
    device = torch.device(device)
    if isinstance(value, np.ndarray):
        key = (id(value), device, dtype)
    else:
        key = (value, device, dtype)
    hit = _cache.get(key)
    if hit is None:
        # the cache keeps `value` alive, so its id is never reused
        hit = _cache[key] = (torch.as_tensor(np.asarray(value), dtype=dtype, device=device),
                             value)
    return hit[0]
