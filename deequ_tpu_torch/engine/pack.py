"""Packed device -> host state transfer: one copy per scan.

Counterpart of ``deequ_tpu/engine/pack.py``. A fused scan ends with a
tree of small state tensors on the device (NamedTuples, dicts, tuples).
Copying them leaf by leaf costs one synchronising transfer per leaf;
instead :func:`pack_tree` lays every device leaf's bytes into ONE uint8
buffer, the host copies that buffer once, and :func:`unpack_tree` views
it back into tensors of the original shapes and dtypes.

Leaves are laid out by descending element size, so every leaf starts at
an offset that is a multiple of its own element size and can be viewed
in place.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
from torch.utils import _pytree as pytree


def _layout(leaves: Sequence[torch.Tensor]) -> List[int]:
    """Leaf order of the packed buffer: largest element size first."""
    return sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())


def pack_tree(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate the raw bytes of ``leaves`` into one uint8 tensor on
    their device."""
    parts = [
        leaves[i].contiguous().reshape(-1).view(torch.uint8)
        for i in _layout(leaves)
    ]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack_tree(packed: torch.Tensor, template: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Slice ``packed`` back into tensors shaped like ``template``'s
    leaves (shape and dtype are all that is read from them)."""
    out: List[Any] = [None] * len(template)
    offset = 0
    for i in _layout(template):
        leaf = template[i]
        nbytes = leaf.numel() * leaf.element_size()
        piece = packed[offset:offset + nbytes].view(leaf.dtype)
        out[i] = piece.reshape(leaf.shape)
        offset += nbytes
    return out


def packed_device_get(tree: Any) -> Any:
    """The same tree with every device tensor copied to the host in ONE
    transfer. Leaves already on the host pass through."""
    leaves, spec = pytree.tree_flatten(tree)
    device_idx = [
        i
        for i, leaf in enumerate(leaves)
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu"
    ]
    if not device_idx:
        return tree
    on_device = [leaves[i] for i in device_idx]
    host = unpack_tree(pack_tree(on_device).cpu(), on_device)
    for i, value in zip(device_idx, host):
        leaves[i] = value
    return pytree.tree_unflatten(leaves, spec)
