"""The children of ``test_torch_subproc.py``: module-level functions that
a spawned child imports by reference. This module imports neither JAX nor
the JAX package, so a child starts with torch and the port alone."""

import signal
import time

import numpy as np
import torch

import deequ_tpu_torch as T
from deequ_tpu_torch import config as tconfig
from deequ_tpu_torch.engine import subproc
from deequ_tpu_torch.telemetry import get_telemetry


def table_data(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=n).tolist(), "g": (np.arange(n) % 7).tolist()}


def analyzers(P):
    return [P.Size(), P.Completeness("a"), P.Mean("a"), P.ApproxQuantile("a", 0.5),
            P.Uniqueness(["g"])]


def child_ok(payload):
    return {"doubled": payload["x"] * 2}


def child_raise(payload):
    raise ValueError(payload["message"])


def child_crash(payload):
    from deequ_tpu_torch.testing.faults import hard_crash

    hard_crash(payload.get("signum"))


def child_sleep(payload):
    time.sleep(payload.get("seconds", 600))


def child_wait_cancel(payload):
    token = subproc.child_cancel_token()
    deadline = time.monotonic() + payload["seconds"]
    while not token.cancelled and time.monotonic() < deadline:
        time.sleep(0.01)
    return {"cancelled": token.cancelled, "reason": token.reason}


def child_device(payload):
    engine = T.AnalysisEngine()
    ctx = T.AnalysisRunner.do_analysis_run(T.Dataset.from_pydict({"x": [1.0, 2.0, 4.0]}),
                                           [T.Mean("x")], engine=engine)
    return {"option": tconfig.options().device, "engine": str(engine.device),
            "mean": ctx.metric(T.Mean("x")).value.get()}


def child_tensors(payload):
    """CPU tensors in the result of a child that exits right after."""
    gen = torch.Generator().manual_seed(payload["seed"])
    return {"big": torch.randn(payload["n"], generator=gen, dtype=torch.float64),
            "ints": [torch.arange(5), torch.tensor([7], dtype=torch.int8)]}


def stub_no_cuda():
    """Run in the child while its arguments are unpickled, before
    ``_child_main``: this child has no usable GPU."""
    torch.cuda.is_available = lambda: False
    return "no cuda"


class NoCuda:
    def __reduce__(self):
        return (stub_no_cuda, ())


def traced_child(payload):
    with get_telemetry().span("child_work"):
        return payload


def traced_crash_child(payload):
    from deequ_tpu_torch.testing.faults import hard_crash

    with get_telemetry().span("doomed_stage"):
        pass
    hard_crash(signal.SIGSEGV)


def scan_child(payload):
    """The resilience suite's scan, with a checkpointer over a durable
    path and an optional token-gated hard crash: the shape
    ``IsolatedRunner`` relaunches."""
    from deequ_tpu_torch.io.state_provider import ScanCheckpointer
    from deequ_tpu_torch.testing.faults import FaultInjectingDataset

    ds = T.Dataset.from_pydict(payload["data"])
    if payload.get("crash_at_batch") is not None:
        ds = FaultInjectingDataset(ds, crash_at_batch=payload["crash_at_batch"],
                                   crash_token_path=payload["crash_token_path"])
    budget = (1 << 30) if payload["mode"] == "resident" else 0
    engine = T.AnalysisEngine(checkpointer=ScanCheckpointer(payload["ckpt_path"]))
    with tconfig.configure(checkpoint_every_batches=3, batch_size=104,
                           device_cache_bytes=budget):
        ctx = T.AnalysisRunner.do_analysis_run(ds, analyzers(T), engine=engine)
    out = []
    for analyzer in analyzers(T):
        value = ctx.metric(analyzer).value
        assert value.is_success, (analyzer, value)
        out.append((str(analyzer), value.get()))
    return {"metrics": out, "resumed_at": engine.resumed_at}




def child_imports(payload):
    """The modules of JAX and of the JAX package this child holds."""
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "deequ_tpu"))
