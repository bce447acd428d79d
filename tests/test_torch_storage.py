"""The port's byte storage (``deequ_tpu_torch/io/storage.py``) against the
JAX package's.

The same sequence of storage operations runs through both packages, on
a local path and on ``mem://``: every read, listing, existence test,
compare-and-swap outcome and the bytes left on disk must be equal.
Exact comparisons throughout (bytes, keys, booleans).
"""

import os
import threading
import uuid

import pytest

from deequ_tpu.io import storage as rstorage

from deequ_tpu_torch.io import storage as tstorage


def _ops(mod, root):
    """A fixed sequence of storage operations; returns what each one
    observed."""
    st = mod.storage_for(root)
    seen = []
    seen.append(("read-missing", st.read_bytes("a.bin")))
    st.write_bytes("a.bin", b"\x00\x01payload")
    st.write_bytes("dir/b.json", b'{"k": 1}', durable=True)
    st.write_bytes("dir/sub/c.npz", b"npz-bytes")
    st.write_bytes("leases/lease-0001.json", b"one")
    seen.append(("read", st.read_bytes("a.bin")))
    seen.append(("exists", st.exists("dir/b.json"), st.exists("nope")))
    seen.append(("list", st.list_keys()))
    seen.append(("list-prefix", st.list_keys("dir/")))
    seen.append(("list-sub", st.list_keys("dir/sub/c")))
    seen.append(("list-missing-dir", st.list_keys("absent/x")))
    st.write_bytes("a.bin", b"overwritten")
    seen.append(("read-over", st.read_bytes("a.bin")))
    st.delete("dir/b.json")
    st.delete("dir/b.json")  # idempotent
    seen.append(("after-delete", st.list_keys(), st.exists("dir/b.json")))
    seen.append(("cas-create", mod.compare_and_swap(root, "lease", None, b"e1")))
    seen.append(("cas-create-again", mod.compare_and_swap(root, "lease", None, b"e2")))
    seen.append(("cas-wrong", mod.compare_and_swap(root, "lease", b"zz", b"e3")))
    seen.append(("cas-right", mod.compare_and_swap(root, "lease", b"e1", b"e4")))
    seen.append(("lease", st.read_bytes("lease")))
    return seen


@pytest.mark.parametrize("where", ["path", "file-uri", "mem"])
def test_same_operations_same_outcomes(where, tmp_path):
    if where == "mem":
        name = uuid.uuid4().hex
        roots = (f"mem://r-{name}", f"mem://t-{name}")
    else:
        roots = (str(tmp_path / "ref"), str(tmp_path / "port"))
        if where == "file-uri":
            roots = tuple("file://" + r for r in roots)
    ref = _ops(rstorage, roots[0])
    port = _ops(tstorage, roots[1])
    assert port == ref
    if where != "mem":
        # the same files on disk, with the same bytes (the CAS lock file
        # included, and no temporaries left behind)
        def tree(root):
            root = root.split("://", 1)[-1]
            out = {}
            for dirpath, _, files in os.walk(root):
                for f in files:
                    full = os.path.join(dirpath, f)
                    out[os.path.relpath(full, root)] = open(full, "rb").read()
            return out

        assert tree(roots[1]) == tree(roots[0])


def test_unregistered_scheme_raises_in_both():
    with pytest.raises(ValueError):
        rstorage.storage_for("s3x://bucket/x")
    with pytest.raises(ValueError):
        tstorage.storage_for("s3x://bucket/x")


def test_registered_scheme_is_used():
    made = []

    def factory(uri):
        made.append(uri)
        return tstorage.MemoryStorage("mem://" + uri.split("://", 1)[1])

    tstorage.register_storage_scheme("unit-test-scheme", factory)
    st = tstorage.storage_for("unit-test-scheme://space-a")
    st.write_bytes("k", b"v")
    assert made == ["unit-test-scheme://space-a"]
    assert tstorage.storage_for("mem://space-a").read_bytes("k") == b"v"


def test_memory_spaces_are_shared_by_name_only():
    name = uuid.uuid4().hex
    a = tstorage.storage_for(f"mem://{name}")
    b = tstorage.storage_for(f"mem://{name}")
    c = tstorage.storage_for(f"mem://{name}-other")
    a.write_bytes("x", b"1")
    assert b.read_bytes("x") == b"1"
    assert c.read_bytes("x") is None


def test_durable_replace_publishes_the_file(tmp_path):
    for mod, name in ((rstorage, "ref"), (tstorage, "port")):
        tmp = tmp_path / f"{name}.tmp"
        tmp.write_bytes(b"segment")
        mod.durable_replace(str(tmp), str(tmp_path / f"{name}.bin"))
        assert not tmp.exists()
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()


def test_failed_write_leaves_no_temporary(tmp_path):
    st = tstorage.LocalStorage(str(tmp_path))
    with pytest.raises(TypeError):
        st.write_bytes("k", object())  # not bytes: the write fails
    assert os.listdir(tmp_path) == []
    assert st.list_keys() == []


@pytest.mark.parametrize("where", ["path", "mem"])
def test_compare_and_swap_has_one_winner(where, tmp_path):
    """Threads racing to create one key: exactly one wins, in both."""
    for mod in (rstorage, tstorage):
        root = str(tmp_path / mod.__name__) if where == "path" else f"mem://{uuid.uuid4().hex}"
        wins = []
        barrier = threading.Barrier(8)

        def claim(i):
            barrier.wait()
            wins.append(mod.compare_and_swap(root, "epoch", None, str(i).encode()))

        threads = [threading.Thread(target=claim, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert sorted(wins) == [False] * 7 + [True]


def test_interprocess_lock_serializes_threads(tmp_path):
    path = str(tmp_path / "x.lock")
    inside = []
    overlap = []

    def hold():
        with tstorage.interprocess_lock(path):
            inside.append(1)
            if len(inside) > 1:
                overlap.append(1)
            threading.Event().wait(0.01)
            inside.pop()

    # flock is per open file description: threads of one process each
    # open their own, so they exclude each other too
    threads = [threading.Thread(target=hold) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert overlap == []
