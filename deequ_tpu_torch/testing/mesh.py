"""Spawn the ranks of a ``dp`` mesh for tests and smoke runs.

:func:`run_ranks` starts ``world`` fresh Python processes (never a fork:
CUDA and the distributed runtime need their own), each of which joins
one process group through a ``FileStore`` in a temporary directory,
builds a one-dimensional ``DeviceMesh`` named ``("dp",)``, calls
``target(rank, world, mesh, *args)`` and sends back what it returns
(pickled). The parent waits for all of them under ONE deadline: a rank
that exits non-zero, or a group that outlives ``timeout``, has every
rank killed and raises, so a rank stranded in a collective fails one
call and never hangs its caller.

``target`` must be a module-level function of a module the rank can
import (its directory is put on the rank's ``sys.path``); a rank
imports only that module, torch, numpy and this package.

Run as ``python -m deequ_tpu_torch.testing.mesh <spec>``, the module is
one rank (what :func:`run_ranks` starts).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class RanksFailed(RuntimeError):
    """A rank exited non-zero, or the group outlived its timeout."""


def run_ranks(target: Callable, world: int, *args: Any, timeout: float = 120.0,
              backend: str = "gloo", device_type: str = "cpu",
              threads: int = 1) -> List[Any]:
    """Run ``target(rank, world, mesh, *args)`` on ``world`` spawned
    ranks (``backend`` over a ``FileStore``; a ``device_type`` mesh) and
    return their results in rank order. Raises :class:`RanksFailed`
    (every rank killed first) when a rank exits non-zero or the group
    is still running after ``timeout`` seconds."""
    module = sys.modules[target.__module__]
    module_dir = os.path.dirname(os.path.abspath(module.__file__))
    work = tempfile.mkdtemp(prefix="deequ_tpu_torch_ranks_")
    procs: List[subprocess.Popen] = []
    logs = []
    try:
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [_REPO, module_dir] + [p for p in [child_env.get("PYTHONPATH")] if p])
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
            child_env[var] = str(threads)
        for rank in range(world):
            spec = {
                "module": target.__module__ if target.__module__ != "__main__"
                else os.path.splitext(os.path.basename(module.__file__))[0],
                "name": target.__name__, "args": args, "rank": rank, "world": world,
                "store": os.path.join(work, "store"), "out": os.path.join(work, f"out{rank}"),
                "backend": backend, "device_type": device_type, "threads": threads,
                "timeout": timeout,
            }
            path = os.path.join(work, f"spec{rank}")
            with open(path, "wb") as f:
                pickle.dump(spec, f)
            log = open(os.path.join(work, f"log{rank}"), "w+b")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deequ_tpu_torch.testing.mesh", path],
                stdout=log, stderr=subprocess.STDOUT, env=child_env, cwd=work))
        deadline = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failed = "a rank exited non-zero"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failed = f"the ranks were still running after {timeout} s"
                break
            time.sleep(0.02)
        if failed is not None:
            _kill(procs)
            raise RanksFailed(f"{failed} (exit codes {[p.poll() for p in procs]}):\n"
                              + _outputs(logs))
        results = []
        for rank in range(world):
            with open(os.path.join(work, f"out{rank}"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        _kill(procs)
        for log in logs:
            log.close()
        shutil.rmtree(work, ignore_errors=True)


def _kill(procs: Sequence[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass


def _outputs(logs) -> str:
    parts = []
    for rank, log in enumerate(logs):
        log.flush()
        log.seek(0)
        text = log.read().decode(errors="replace")
        parts.append(f"--- rank {rank} ---\n{text[-6000:]}")
    return "\n".join(parts)


def _rank_main(spec_path: str) -> int:
    """One rank: join the group, build the mesh, run the target, write
    its result."""
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    torch.set_num_threads(int(spec["threads"]))
    rank, world = spec["rank"], spec["world"]
    timeout = datetime.timedelta(seconds=float(spec["timeout"]))
    store = dist.FileStore(spec["store"], world)
    dist.init_process_group(spec["backend"], store=store, rank=rank, world_size=world,
                            timeout=timeout)
    code = 0
    try:
        if spec["device_type"] == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        mesh = DeviceMesh(spec["device_type"], list(range(world)), mesh_dim_names=("dp",))
        fn = getattr(importlib.import_module(spec["module"]), spec["name"])
        result = fn(rank, world, mesh, *spec["args"])
    except BaseException:  # noqa: BLE001 — reported, then the rank exits non-zero
        traceback.print_exc()
        sys.stdout.flush()
        code = 1
    if code == 0:
        with open(spec["out"] + ".tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(spec["out"] + ".tmp", spec["out"])
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    exit_code = _rank_main(sys.argv[1])
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: a collective thread left by a failed
    # peer must not hold the exit
    os._exit(exit_code)
