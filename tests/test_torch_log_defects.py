"""Two storage defects of the segment writer's copy, held on both packages
on the CPU: the reference keeps them (each of its cases is a strict
``xfail``), the port repairs them.

- ``SegmentWriter.close()`` joined its flusher for at most 10 s and then
  drained the queue on the caller's thread, so a flush that outlasted the
  join ran beside a second drainer (closing a node's storage after a
  full-width failover failed this way on the card). The port's close
  waits for the flusher and drains inline only what a dead one left.
- A ``Log`` opened while WAL recovery hands its memtables to the segment
  writer could list the segment file the writer is creating before its
  header is written, and fail to open on the torn header. The port's
  segment set skips such a file: it holds no entry yet (the writer
  writes the header and the index region before any), and the entries
  are still in the memtable.

Each case gates the writer's thread on an ``Event`` at the point that
matters, so the interleaving is fixed and no case sleeps.
"""

import importlib
import os
import threading

import pytest

from torch_batch import PACKAGES

WAIT_S = 10.0


def _mod(name, sub):
    return importlib.import_module(f"{name}.{sub}")


def _packages(reason):
    return [pytest.param(n, marks=pytest.mark.xfail(strict=True, reason=reason))
            if n == "ra_tpu" else n for n in PACKAGES]


@pytest.mark.parametrize("name", _packages(
    "the reference's SegmentWriter.close() drains on the caller's thread "
    "once a bounded join gives up, while its flusher still flushes"))
def test_close_never_runs_two_drainers(name, tmp_path):
    """A flush held by a gate until close() has decided what to do: a
    close that stops waiting for the flusher and drains on its own
    thread enters a second flush while the first is still running; a
    close that waits for the flusher lets it flush both jobs alone."""
    SW = _mod(name, "log.segment_writer").SegmentWriter
    Tables = _mod(name, "log.tables").TableRegistry
    sw = SW(str(tmp_path / "data"), Tables(), lambda uid, evt: None)
    gate, entered, decided = (threading.Event() for _ in range(3))
    lock = threading.Lock()
    inside, overlap, flushed = [], [], []

    def gated_flush(seqs):
        me = threading.current_thread().name
        with lock:
            if inside:
                overlap.append((inside[0], me))
                decided.set()
            inside.append(me)
            first = not flushed
            flushed.append(me)
        try:
            if first:
                entered.set()
                gate.wait(WAIT_S)
        finally:
            with lock:
                inside.remove(me)

    sw._flush_job = gated_flush
    thread = sw._thread
    real_join = thread.join

    def join(timeout=None):
        # a bounded join gives up while the gated flush runs, as the
        # 10 s one does behind a slow flush; an unbounded one waits
        if timeout is not None:
            return real_join(0)
        decided.set()
        return real_join()

    thread.join = join
    sw.flush_mem_tables({"u1": []})
    assert entered.wait(WAIT_S), "the flusher never took the first job"
    sw.flush_mem_tables({"u2": []})
    closer = threading.Thread(target=sw.close, name="closer")
    closer.start()
    assert decided.wait(WAIT_S), "close() neither waited nor drained"
    gate.set()
    closer.join(WAIT_S)
    assert not closer.is_alive()
    assert not thread.is_alive()
    assert len(flushed) == 2, flushed
    assert overlap == [], f"two drainers at once: {overlap}"


@pytest.mark.parametrize("name", _packages(
    "the reference's segment set fails to open a segment file that the "
    "segment writer has created but whose header it has not yet written"))
def test_log_opens_while_recovery_creates_a_segment(name, tmp_path):
    """Entries live only in a WAL file; the WAL is reopened, its
    recovery hands them to the segment writer, whose thread is held
    just after it created the group's first segment file and before it
    wrote the header. A ``Log`` opened then must open, with its tail
    recovered from the memtable, and read every entry."""
    Wal = _mod(name, "log.wal").Wal
    SW = _mod(name, "log.segment_writer").SegmentWriter
    Tables = _mod(name, "log.tables").TableRegistry
    Log = _mod(name, "log.log").Log
    segment = _mod(name, "log.segment")
    P = _mod(name, "protocol")
    d = str(tmp_path)

    def storage():
        tables = Tables()
        sw = SW(os.path.join(d, "data"), tables, lambda uid, evt: None)
        return tables, sw, Wal(os.path.join(d, "wal"), tables,
                               lambda uid, evt: None, segment_writer=sw)

    tables, sw, wal = storage()
    log = Log("g0", os.path.join(d, "data", "g0"), tables, wal)
    n = 5
    for i in range(1, n + 1):
        log.append(P.Entry(i, 1, P.Command(kind=P.USR, data=i)))
    wal.close()  # the entries are in the WAL file, no segment yet
    sw.close()
    seg_dir = os.path.join(d, "data", "g0", "segments")
    assert not [f for f in os.listdir(seg_dir) if f.endswith(".segment")]

    created, gate = threading.Event(), threading.Event()
    real_retry = segment.retry

    def gated_retry(fn, *args, **kw):
        f = real_retry(fn, *args, **kw)
        if (not created.is_set() and hasattr(f, "fileno")
                and os.fstat(f.fileno()).st_size == 0):
            created.set()  # the file exists, its header is not written
            gate.wait(WAIT_S)
        return f

    segment.retry = gated_retry
    try:
        tables, sw, wal = storage()  # recovery hands g0's entries over
        assert created.wait(WAIT_S), "recovery created no segment"
        try:
            log = Log("g0", os.path.join(d, "data", "g0"), tables, wal)
            seen = (log.last_index_term(),
                    [log.fetch(i).cmd.data for i in range(1, n + 1)])
        finally:
            gate.set()
    finally:
        segment.retry = real_retry
        assert sw.wait_idle(WAIT_S)
        wal.close()
        sw.close()
    assert seen == ((n, 1), list(range(1, n + 1)))
