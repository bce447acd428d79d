"""Carry analyzer states across between this package and the JAX package.

A state persisted by ``deequ_tpu`` (its filesystem state provider writes
one ``.npz`` per state) is a mapping of numpy arrays: ``__type__`` (the
state's class name), ``__version__`` (its format version) and one array
per NamedTuple field. :func:`states_from_numpy` turns such a mapping into
this package's state on a device, so it merges with a state this package
computed (``aggregate_with=`` on the runner); :func:`states_to_numpy`
produces the same mapping from this package's state, for
``numpy.savez``.

Both sides share the field names, dtypes and merges of every state, and
HLL registers are bit-identical across the packages, so a merged state
is the state of the union of the data.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from deequ_tpu_torch.analyzers.states import STATE_FORMAT_VERSIONS, STATE_TYPES


def states_from_numpy(
    state_type_name: str, arrays: Mapping[str, Any], device="cpu"
) -> Any:
    """This package's ``state_type_name`` state from a persisted state's
    arrays, on ``device``. A missing ``__version__`` reads as version 1,
    as the JAX package reads it; a version other than the current one is
    refused, since a merge across versions would be silently wrong."""
    cls = STATE_TYPES.get(state_type_name)
    if cls is None:
        raise TypeError(f"unknown state type {state_type_name!r}")
    expected = STATE_FORMAT_VERSIONS.get(state_type_name, 1)
    found = int(arrays["__version__"]) if "__version__" in arrays else 1
    if found != expected:
        raise TypeError(
            f"{state_type_name} has format v{found}, this package reads "
            f"v{expected} — recompute the state"
        )
    return cls(
        **{
            f: torch.as_tensor(np.array(arrays[f])).to(device)
            for f in cls._fields
        }
    )


def states_to_numpy(state: Any) -> Dict[str, np.ndarray]:
    """The persisted-state mapping of one of this package's states."""
    name = type(state).__name__
    if name not in STATE_TYPES:
        raise TypeError(f"cannot carry a state of type {name}")
    out: Dict[str, np.ndarray] = {
        "__type__": np.asarray(name),
        "__version__": np.int64(STATE_FORMAT_VERSIONS.get(name, 1)),
    }
    for f in state._fields:
        out[f] = torch.as_tensor(getattr(state, f)).cpu().numpy()
    return out
