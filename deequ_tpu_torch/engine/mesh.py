"""The ``dp`` mesh: ranks that each scan their own rows and merge once.

Counterpart of the multi-device half of ``deequ_tpu/engine/scan.py``
(``monoid_all_reduce``, the mesh placement) and of the success-flag
exchanges of ``deequ_tpu/engine/ingest.py`` and
``deequ_tpu/analyzers/spill.py``. The JAX package shards each batch
over a ``dp`` axis and reduces inside every jitted step; the port runs
one process a rank (``torch.distributed``), each rank scans its own
share of the rows with the one-device engine, and the ranks merge their
states ONCE after the scan:

- :func:`monoid_all_reduce` gathers every rank's states (the tensor
  leaves packed into one byte buffer and gathered in one collective,
  the rest pickled) and folds them with each op's own ``merge`` in rank
  order, so every rank holds the same bits on every run. The merge is
  associative, so integer states equal a one-device scan's; float sums
  differ only by their order.
- :meth:`MeshContext.sync` is the one collective every rank reaches at
  each point where a rank may fail or decide alone: it gathers a
  payload and an error from every rank, and when any rank failed it
  raises :class:`RankFailed` on EVERY rank (a rank that raised alone
  would leave its peers waiting in the next collective until the
  timeout). Payloads that must agree (the scan's plan token) raise
  :class:`MeshPlanMismatch` on every rank when they do not.

The caller initialises the default process group and builds the
``DeviceMesh``, and so chooses the backend: NCCL when each rank has a
card of its own, gloo when the ranks share one card or run on the CPU.
The engine makes its own group over the mesh's ``dp`` ranks, with
``config.collective_timeout_s`` as the timeout of every collective.
Tensors cross the NCCL backend on the rank's card; the gloo backend's
collectives take host tensors, so they are staged through the host.
"""

from __future__ import annotations

import datetime
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from deequ_tpu_torch import config


class MeshError(RuntimeError):
    """A fault of a mesh run that every rank raises together."""


class RankFailed(MeshError):
    """One rank or more failed at a point every rank had to reach; the
    message names the ranks and their errors."""


class MeshPlanMismatch(MeshError):
    """The ranks planned different scans (different ops, state shapes or
    request sets), so their states cannot be merged."""


def _error_text(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"[:2000]


# one group a mesh, made once (``new_group`` is itself a collective)
_GROUPS: Dict[Tuple[int, str], Any] = {}


class MeshContext:
    """A ``DeviceMesh``'s ``dp`` dimension as the engine uses it: this
    process's rank and the world, a group of the dp ranks with the
    configured collective timeout, and the device its collectives move
    tensors on."""

    def __init__(self, mesh, axis: str = "dp"):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if axis not in names:
            raise ValueError(f"the mesh has no {axis!r} dimension (dimensions: {names})")
        if not dist.is_initialized():
            raise RuntimeError("a mesh engine needs torch.distributed's default process group")
        self.mesh = mesh
        self.axis = axis
        parent = mesh.get_group(axis)
        self.rank = int(mesh.get_local_rank(axis))
        self.world = int(dist.get_world_size(parent))
        self.backend = str(dist.get_backend(parent))
        key = (id(parent), self.backend)
        group = _GROUPS.get(key)
        if group is None:
            ranks = dist.get_process_group_ranks(parent)
            timeout = datetime.timedelta(seconds=float(config.options().collective_timeout_s))
            group = _GROUPS[key] = dist.new_group(ranks=ranks, timeout=timeout,
                                                  backend=self.backend)
        self.group = group
        self.comm_device = (torch.device("cuda", torch.cuda.current_device())
                            if "nccl" in self.backend else torch.device("cpu"))
        # bytes and seconds of this context's collectives, by kind
        self.bytes: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    @property
    def placement(self) -> str:
        """The run metadata's name of the placement (the JAX package's
        ``mesh<ndev>`` label)."""
        return f"mesh{self.world}"

    def _account(self, kind: str, nbytes: int, t0: float) -> None:
        self.bytes[kind] = self.bytes.get(kind, 0) + int(nbytes)
        self.seconds[kind] = self.seconds.get(kind, 0.0) + time.perf_counter() - t0

    # -- collectives ------------------------------------------------------

    def gather_objects(self, obj: Any, kind: str = "objects") -> List[Any]:
        """Every rank's ``obj``, in rank order (pickled)."""
        t0 = time.perf_counter()
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        self._account(kind, len(pickle.dumps(obj)) * self.world, t0)
        return out

    def gather_tensor(self, t: torch.Tensor, kind: str = "tensors") -> List[torch.Tensor]:
        """Every rank's tensor of the same shape and dtype, in rank order,
        on ``t``'s device."""
        t0 = time.perf_counter()
        src = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src, group=self.group)
        self._account(kind, src.numel() * src.element_size() * self.world, t0)
        return [o.to(t.device) for o in out]

    def all_to_all(self, send: torch.Tensor, send_counts: Sequence[int],
                   recv_counts: Sequence[int], kind: str = "all_to_all") -> torch.Tensor:
        """``all_to_all_single`` with split sizes every rank already knows:
        rank r's ``send[sum(send_counts[:d]):][:send_counts[d]]`` lands in
        rank d's output at rank r's place."""
        t0 = time.perf_counter()
        src = send.to(self.comm_device).contiguous()
        out = torch.empty(int(sum(recv_counts)), dtype=src.dtype, device=self.comm_device)
        dist.all_to_all_single(out, src, output_split_sizes=[int(c) for c in recv_counts],
                               input_split_sizes=[int(c) for c in send_counts],
                               group=self.group)
        self._account(kind, src.numel() * src.element_size(), t0)
        return out.to(send.device)

    def sync(self, stage: str, payload: Any = None,
             error: Optional[BaseException] = None) -> List[Any]:
        """The uniform exchange every rank enters: ``(stage, payload,
        error)`` from each rank; returns the payloads in rank order. A
        failure of any rank raises :class:`RankFailed` on every rank
        (chained to this rank's own error); ranks at different stages
        raise :class:`MeshPlanMismatch`."""
        mine = (stage, payload, None if error is None else _error_text(error))
        got = self.gather_objects(mine, kind="sync")
        bad = [r for r, g in enumerate(got) if g[2] is not None]
        if bad:
            text = "; ".join(f"rank {r}: {got[r][2]}" for r in bad)
            raise RankFailed(f"{stage} failed on rank(s) {bad}: {text}") from error
        if len({g[0] for g in got}) > 1:
            raise MeshPlanMismatch(
                f"the ranks reached different points of the run: {[g[0] for g in got]}")
        return [g[1] for g in got]

    def agree(self, stage: str, token: Any) -> None:
        """Raise :class:`MeshPlanMismatch` on every rank unless every rank
        holds the same ``token``."""
        tokens = self.sync(stage, token)
        if any(t != tokens[0] for t in tokens[1:]):
            raise MeshPlanMismatch(f"the ranks planned different scans ({stage}): {tokens}")


def monoid_all_reduce(states: Sequence[Any], merges: Sequence[Any],
                      ctx: MeshContext) -> List[Any]:
    """Every rank's ``states`` merged, the same on every rank: the tensor
    leaves of all states travel in ONE byte buffer (every rank's states
    have the same structure, shapes and dtypes: the plan token was
    agreed before the scan), any other leaf (a KLL sketch, a numpy
    array) is pickled, and each state is folded with its ``merge`` in
    rank order: ``merge(...merge(s0, s1)..., s_{W-1})``."""
    if not states:
        return []
    leaves, spec = pytree.tree_flatten(list(states))
    # largest element size first, so every leaf's bytes start aligned
    tensor_idx = sorted((i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)),
                        key=lambda i: -leaves[i].element_size())
    other_idx = [i for i, x in enumerate(leaves) if not isinstance(x, torch.Tensor)]
    per_rank: List[List[Any]] = [list(leaves) for _ in range(ctx.world)]
    if tensor_idx:
        parts = [leaves[i].detach().contiguous().reshape(-1).view(torch.uint8)
                 for i in tensor_idx]
        sizes = [p.numel() for p in parts]
        buf = torch.cat(parts) if parts else torch.zeros(0, dtype=torch.uint8)
        gathered = ctx.gather_tensor(buf.cpu(), kind="merge")
        for r, g in enumerate(gathered):
            offset = 0
            for i, size in zip(tensor_idx, sizes):
                leaf = leaves[i]
                piece = g[offset:offset + size].view(leaf.dtype).reshape(leaf.shape)
                per_rank[r][i] = piece.clone()
                offset += size
    if other_idx:
        objects = ctx.gather_objects([leaves[i] for i in other_idx], kind="merge")
        for r, objs in enumerate(objects):
            for i, obj in zip(other_idx, objs):
                per_rank[r][i] = obj
    trees = [pytree.tree_unflatten(p, spec) for p in per_rank]
    out = []
    for k, merge in enumerate(merges):
        acc = trees[0][k]
        for r in range(1, ctx.world):
            acc = merge(acc, trees[r][k])
        out.append(acc)
    return out


def choose_backend() -> Tuple[str, str]:
    """(backend, device type) for a run over this machine's cards: NCCL
    with one rank a card when there are two or more, gloo with every
    rank on ``cuda:0`` when there is one, gloo on the CPU without a card.
    Decided by the device count, never by trying NCCL first."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count >= 2:
        return "nccl", "cuda"
    if count == 1:
        return "gloo", "cuda"
    return "gloo", "cpu"
