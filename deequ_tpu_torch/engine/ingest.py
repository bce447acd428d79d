"""The ordered ingest pool: a streamed scan's decode and pack on worker
threads, released in source order.

Counterpart of ``deequ_tpu/engine/ingest.py``. One prefetch thread
(``engine/scan.py::_prefetched``) serialises a streamed batch's decode
and pack; :func:`ordered_ingest` spreads them over a bounded pool:

- a READER thread walks the order-defining source iterator (cheap: Arrow
  slices of a parquet source) and queues ``(seq, item)``;
- WORKER threads run the heavy ``work(item)`` stage (Arrow to numpy,
  mask packing, the copy into a pinned slot; numpy and Arrow release the
  interpreter lock for the bulk of it);
- the CONSUMER (the generator returned to the caller) releases results
  strictly in sequence order and runs the optional ``commit(result,
  item)`` stage there, on its own thread, in order: the dictionary
  deltas of ``data/parquet.py`` are cut in it.

At most ``lookahead`` items are in flight (queued, working, or done and
waiting for release). An exception raised in the reader, a worker or a
commit surfaces on the consumer's thread at exactly its sequence
position, after every earlier item. Closing the generator (or an
exception in the consumer) stops the reader and the workers, drains the
queue and joins every thread: :func:`active_ingest_threads` is then
``[]``.

``process_sharded_feed`` of the JAX module (the multi-host row-group
shards) belongs to the multi-device slice and is not here.
"""

from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

# every thread this module or engine/scan.py starts, weakly: a leak probe
_INGEST_THREADS: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()
# seconds the consumer waits for each thread to exit at teardown
_JOIN_TIMEOUT_S = 30.0


def register_ingest_thread(thread: threading.Thread) -> threading.Thread:
    """Register a host-ingest thread with the leak probe."""
    _INGEST_THREADS.add(thread)
    return thread


def active_ingest_threads():
    """Ingest threads (reader, workers and prefetch threads) still alive."""
    return [t for t in list(_INGEST_THREADS) if t.is_alive()]


@dataclass
class IngestPoolStats:
    """One pool's accounting: seconds of each stage summed over the
    threads that ran it, and by worker thread (``by_worker[name][stage]``),
    batches released, the consumer's waits for the head of the order,
    the pool's wall time, and the most items and result bytes in flight
    at once."""

    workers: int = 0
    released: int = 0
    decode_s: float = 0.0  # workers: Arrow -> numpy
    encode_s: float = 0.0  # workers: pack into the pinned slot (not its wait)
    commit_s: float = 0.0  # consumer: the ordered stage
    idle_s: float = 0.0  # workers waiting for work
    stall_s: float = 0.0  # consumer waiting for the next item in order
    wall_s: float = 0.0
    peak_in_flight: int = 0
    peak_in_flight_bytes: int = 0
    by_worker: Dict[str, Dict[str, float]] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def add(self, stage: str, seconds: float) -> None:
        """Add ``seconds`` to ``stage``, and to the calling thread's share."""
        name = threading.current_thread().name
        with self._lock:
            setattr(self, stage, getattr(self, stage) + seconds)
            mine = self.by_worker.setdefault(name, {})
            mine[stage] = mine.get(stage, 0.0) + seconds


def resolve_ingest_workers(configured: int) -> int:
    """``config.ingest_workers`` -> a worker count: 0 = auto
    (``min(4, cpus)``); never below 1."""
    if configured and configured > 0:
        return int(configured)
    return max(1, min(4, os.cpu_count() or 1))


def resolve_ingest_lookahead(configured: int, workers: int) -> int:
    """``config.ingest_lookahead`` -> the in-flight bound: 0 = auto
    (``2 * workers``); never below ``workers``."""
    if configured and configured > 0:
        return max(int(configured), workers)
    return 2 * workers


def ordered_ingest(
    items: Iterable[Any],
    work: Callable[[Any], Any],
    commit: Optional[Callable[[Any, Any], Any]] = None,
    *,
    workers: int,
    lookahead: int,
    stats: Optional[IngestPoolStats] = None,
    sizer: Optional[Callable[[Any], int]] = None,
) -> Iterator[Any]:
    """Yield ``commit(work(item), item)`` (or ``work(item)``) for each
    item, ``work`` spread over ``workers`` threads and the results
    released in source order (see the module docstring).
    ``sizer(result)`` prices a finished result in bytes for
    ``stats.peak_in_flight_bytes``."""
    workers = max(1, int(workers))
    lookahead = max(workers, int(lookahead))
    stats = stats if stats is not None else IngestPoolStats()
    stats.workers = workers
    started = time.perf_counter()

    work_q: "queue.Queue" = queue.Queue(maxsize=lookahead)
    stop = threading.Event()
    cond = threading.Condition()
    # seq -> ("item", result, item, nbytes) | ("error", exc, None, 0) |
    # ("done", None, None, 0); guarded by cond
    results: Dict[int, Any] = {}
    state = {"released": 0, "in_flight_bytes": 0}

    def put_work(msg) -> bool:
        # a bounded put that notices an abandoned consumer
        while not stop.is_set():
            try:
                work_q.put(msg, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def deposit(seq: int, entry) -> None:
        with cond:
            results[seq] = entry
            if entry[0] == "item":
                state["in_flight_bytes"] += entry[3]
                stats.peak_in_flight_bytes = max(stats.peak_in_flight_bytes,
                                                 state["in_flight_bytes"])
            cond.notify_all()

    def reader() -> None:
        seq = 0
        try:
            for item in items:
                # admission: at most ``lookahead`` items in flight
                with cond:
                    while seq - state["released"] >= lookahead and not stop.is_set():
                        cond.wait(timeout=0.1)
                    stats.peak_in_flight = max(stats.peak_in_flight,
                                               seq - state["released"] + 1)
                if stop.is_set() or not put_work((seq, item)):
                    return
                seq += 1
        except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer in order
            deposit(seq, ("error", exc, None, 0))
            return
        deposit(seq, ("done", None, None, 0))

    def worker_loop() -> None:
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                seq, item = work_q.get(timeout=0.1)
            except queue.Empty:
                stats.add("idle_s", time.perf_counter() - t0)
                continue
            stats.add("idle_s", time.perf_counter() - t0)
            try:
                result = work(item)
                nbytes = int(sizer(result)) if sizer is not None else 0
                deposit(seq, ("item", result, item, nbytes))
            except BaseException as exc:  # noqa: BLE001 — re-raised by the consumer in order
                deposit(seq, ("error", exc, None, 0))

    threads = [register_ingest_thread(
        threading.Thread(target=reader, daemon=True, name="deequ-tpu-torch-ingest-reader"))]
    threads += [
        register_ingest_thread(threading.Thread(
            target=worker_loop, daemon=True, name=f"deequ-tpu-torch-ingest-{i}"))
        for i in range(workers)
    ]
    for t in threads:
        t.start()
    try:
        while True:
            want = state["released"]
            with cond:
                t0 = time.perf_counter()
                while want not in results:
                    cond.wait(timeout=0.1)
                stats.stall_s += time.perf_counter() - t0
                tag, payload, item, nbytes = results.pop(want)
            if tag == "error":
                raise payload
            if tag == "done":
                return
            t0 = time.perf_counter()
            released = commit(payload, item) if commit is not None else payload
            stats.commit_s += time.perf_counter() - t0
            stats.released += 1
            with cond:
                state["released"] = want + 1
                state["in_flight_bytes"] -= nbytes
                cond.notify_all()
            yield released
    finally:
        stop.set()  # the consumer is done or raised: release the threads
        with cond:
            cond.notify_all()
        try:
            while True:
                work_q.get_nowait()
        except queue.Empty:
            pass
        for t in threads:
            t.join(timeout=_JOIN_TIMEOUT_S)
        stats.wall_s = time.perf_counter() - started
