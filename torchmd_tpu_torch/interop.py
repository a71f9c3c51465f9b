"""Hand one parameter set from the JAX package to the port.

`ffparams_from_numpy(d, device, dtype)` takes the JAX package's `FFParams`
with every leaf as a numpy array (for example
`jax.tree_util.tree_map(np.asarray, ffp)`), or a mapping with the same
field names, and returns the port's `FFParams` on `device`. Integer
leaves become int64, boolean leaves stay bool, float leaves take `dtype`.
"""

from __future__ import annotations

import numpy as np
import torch

from .potentials import FFParams, TermTable

_TABLES = ("bonds", "angles", "dihedrals", "impropers", "nb14",
           "urey_bradley", "bonds_g96", "angles_g96")


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable copy: the leaves may be read-only views
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int64, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def _field(d, name):
    if isinstance(d, dict):
        return d.get(name)
    return getattr(d, name, None)


def ffparams_from_numpy(d, device="cpu", dtype=torch.float64) -> FFParams:
    if _field(d, "cmap") is not None:
        raise NotImplementedError("CMAP tables are not ported yet")
    out = {}
    for name in FFParams._fields:
        v = _field(d, name)
        if v is None:
            out[name] = None
        elif name in _TABLES:
            out[name] = TermTable(*(_tensor(_field(v, f), device, dtype)
                                    for f in TermTable._fields))
        elif name == "lj_ab":
            out[name] = tuple(_tensor(t, device, dtype) for t in v)
        else:
            out[name] = _tensor(v, device, dtype)
    return FFParams(**out)
