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
is the state of the union of the data. A KLL sketch
(``sketches/kll.py::KLLSketchState``) is host numpy on both sides and is
persisted without a format version, as the JAX package persists it:
``__type__`` plus the arrays of its ``to_arrays``. A frequency state
(``analyzers/grouping.py::FrequenciesAndNumRows``, a device spill state
included: it persists its fetched groups) is persisted as the JAX
package's state provider writes it: ``columns`` and ``keys`` as JSON,
``counts`` and ``num_rows``.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping

import numpy as np
import torch

from deequ_tpu_torch.analyzers.grouping import FrequenciesAndNumRows
from deequ_tpu_torch.analyzers.states import STATE_FORMAT_VERSIONS, STATE_TYPES
from deequ_tpu_torch.sketches.kll import KLLSketchState

_KLL = "KLLSketchState"
_FREQUENCIES = "FrequenciesAndNumRows"


def _json_safe(value):
    """A key value as JSON holds it (the JAX package's rule): None,
    strings and booleans as they are, numbers as int or float, anything
    else (timestamps) as its ``str``."""
    if value is None or isinstance(value, (str, bool)):
        return value
    if isinstance(value, (np.integer, int)):
        return int(value)
    if isinstance(value, (np.floating, float)):
        return float(value)
    return str(value)


def states_from_numpy(
    state_type_name: str, arrays: Mapping[str, Any], device="cpu"
) -> Any:
    """This package's ``state_type_name`` state from a persisted state's
    arrays, on ``device``. A missing ``__version__`` reads as version 1,
    as the JAX package reads it; a version other than the current one is
    refused, since a merge across versions would be silently wrong. A
    KLL sketch stays on the host whatever ``device`` says."""
    if state_type_name == _KLL:
        return KLLSketchState.from_arrays(arrays)
    if state_type_name == _FREQUENCIES:
        columns = tuple(json.loads(str(arrays["columns"])))
        rows = json.loads(str(arrays["keys"]))
        keys = np.empty((len(rows), len(columns)), dtype=object)
        for i, row in enumerate(rows):
            keys[i, :] = row
        return FrequenciesAndNumRows(
            columns, keys, np.asarray(arrays["counts"]), int(arrays["num_rows"])
        )
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
    if isinstance(state, KLLSketchState):
        return {"__type__": np.asarray(_KLL), **state.to_arrays()}
    if isinstance(state, FrequenciesAndNumRows):
        return {
            "__type__": np.asarray(_FREQUENCIES),
            "columns": np.asarray(json.dumps(list(state.columns))),
            "keys": np.asarray(
                json.dumps([[_json_safe(v) for v in row] for row in state.keys])
            ),
            "counts": state.counts,
            "num_rows": np.int64(state.num_rows),
        }
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
