"""JAX parameter trees -> the port's state dict.

`params_from_jax(params_np, bn_state_np)` takes the JAX package's
`init_unet`/checkpoint pytrees as nested dicts of numpy arrays, with each
BatchNorm state as a `(mean, var)` pair (an instance norm's state is None:
it carries its affine only), and returns a state dict that
`ResUNet.load_state_dict` accepts. Conv weights keep the JAX layout
[K^3, Ci, Co] and tap order, so nothing is transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def params_from_jax(params_np: dict, bn_state_np: dict) -> dict:
    out = {}

    def walk(prefix, p, s):
        for key, val in p.items():
            name = f"{prefix}{key}"
            if isinstance(val, dict) and "scale" in val:        # a norm
                out[f"{name}.weight"] = _tensor(val["scale"])
                out[f"{name}.bias"] = _tensor(val["bias"])
                if s.get(key) is not None:                      # a BN
                    mean, var = s[key]
                    out[f"{name}.running_mean"] = _tensor(mean)
                    out[f"{name}.running_var"] = _tensor(var)
            elif isinstance(val, dict) and "w" in val:          # final 1x1
                out[f"{name}.weight"] = _tensor(val["w"])
                out[f"{name}.bias"] = _tensor(val["b"])
            elif isinstance(val, dict):                         # a block
                walk(f"{name}.", val, (s or {}).get(key) or {})
            else:                                               # a conv
                out[f"{name}.weight"] = _tensor(val)

    walk("", params_np, bn_state_np or {})
    return out
