"""The mailbox-pack and fallback cases of ``tests/test_native_runtime.py``
on the port's copy of ``rt_native.cpp`` (``ra_tpu_torch.native``, built
under a private name and renamed into place, so parallel workers never
load a partial library).

- The byte-identity fuzz of ``_pack_hot``: the native scatter against
  the Python column stores over the original's 30 seeded corpora, and
  the port's mailbox against the JAX package's coordinator for the same
  corpora, byte for byte. The reference packs through its Python stores
  (``native="off"``), so no test here builds ``ra_tpu/native``.
- The fallbacks: a non-contiguous buffer, an armed failpoint, the helpers
  missing (on both packages, each loader told that nothing loaded) and
  the library vanishing midflight.

Without a compiler the port's library does not build and the native
cases skip, as the original's ``needs_rt`` does.
"""

import importlib
import random

import numpy as np
import pytest

import lane_cases as L
import torch_parity  # noqa: F401  (bounds torch's threads)
from torch_batch import PACKAGES, clear_both

from ra_tpu_torch import faults, native

CAP = 8
needs_rt = pytest.mark.skipif(
    not native.entry_points()["classify"],
    reason="rt_native.so unavailable (no compiler)",
)


@pytest.fixture(autouse=True)
def _clean():
    clear_both()
    yield
    clear_both()


def mk_coord(lane, name, spec):
    return lane.coord(name, capacity=CAP, num_peers=1, idle_sleep_s=0,
                      native=spec)


def add_groups(lane, c, tag, names=("g0", "g1", "g2")):
    for gname in names:
        c.add_group(gname, f"{tag}-{gname}", [(gname, c.name)], lane.adder())


def deliver_commands(lane, c, gname, n):
    p = lane.protocol
    for i in range(n):
        c.deliver((gname, c.name),
                  p.Command(kind=p.USR, data=i, priority="normal"), None)


@needs_rt
def test_pack_hot_parity_fuzz():
    lane = L.Lane("ra_tpu_torch")
    c_nat = mk_coord(lane, "tnpk0", "pack")
    c_off = mk_coord(lane, "tnpk1", "off")
    try:
        assert c_nat._nat_pack and not c_off._nat_pack
        port = L.pack_fuzz(lane, c_nat, c_off, CAP)
        assert c_nat.counters.get("native_pack_batches") > 0
        assert c_nat.counters.get("native_fallbacks") == 0
        assert c_off.counters.get("native_pack_batches") == 0
    finally:
        c_nat.stop()
        c_off.stop()
    # the JAX package's coordinator packs the same corpora (built from
    # its own message classes) into the same bytes
    ref = L.Lane("ra_tpu")
    r_off = mk_coord(ref, "tnpk2", "off")
    try:
        assert r_off._NROWS == c_nat._NROWS
        want = L.pack_fuzz(ref, r_off, r_off, CAP)
    finally:
        r_off.stop()
    assert len(want) == len(port) == L.PACK_TRIALS
    for trial, (a, b) in enumerate(zip(port, want)):
        assert a.tobytes() == b.tobytes(), f"trial {trial}"


@needs_rt
def test_pack_hot_noncontiguous_buffer_falls_back():
    lane = L.Lane("ra_tpu_torch")
    c = mk_coord(lane, "tnpf0", "pack")
    c_off = mk_coord(lane, "tnpf1", "off")
    try:
        corpus = L.pack_corpus(lane.protocol, random.Random(3), CAP)
        nrows = c._NROWS
        p_f = np.asfortranarray(np.zeros((nrows, CAP), np.int32))
        p_ref = np.zeros((nrows, CAP), np.int32)
        c._pack_hot(p_f, *corpus)
        c_off._pack_hot(p_ref, *corpus)
        assert np.array_equal(np.ascontiguousarray(p_f), p_ref)
        if corpus[0] or corpus[3]:  # corpus non-empty -> native refused
            assert c.counters.get("native_fallbacks") == 1
            assert c.counters.get("native_pack_batches") == 0
    finally:
        c.stop()
        c_off.stop()


@needs_rt
def test_pack_hot_armed_failpoint_falls_back():
    lane = L.Lane("ra_tpu_torch")
    c = mk_coord(lane, "tnpa0", "pack")
    try:
        corpus = L.pack_corpus(lane.protocol, random.Random(5), CAP)
        packed = np.zeros((c._NROWS, CAP), np.int32)
        faults.arm("tcp.send", ("raise", "eio"), ("always",))
        c._pack_hot(packed, *corpus)
        assert c.counters.get("native_pack_batches") == 0
        assert c.counters.get("native_fallbacks") == 0  # routed around
    finally:
        faults.disarm_all()
        c.stop()


@pytest.mark.parametrize("name", PACKAGES)
def test_rt_lib_missing_helpers_and_coordinator(monkeypatch, name):
    lane = L.Lane(name)
    nat = importlib.import_module(f"{name}.native")
    # the loaders report nothing loaded and build nothing
    for attr, val in (("_rt_lib", None), ("_rt_tried", True),
                      ("_lib", None), ("_tried", True)):
        monkeypatch.setattr(nat, attr, val)
    assert nat.classify(bytes([0, 1]), 2) is None
    assert nat.pack_mbox(np.zeros((2, 2), np.int32), [0], [1, 2],
                         np.asarray([0, 1], np.int32)) is False
    assert nat.seal_frames([b"x"], b"k") is None
    eps = nat.entry_points()
    assert not eps["pack"] and not eps["classify"] and not eps["egress"]
    c = mk_coord(lane, f"tnmh_{name}", "auto")
    try:
        assert not (c._nat_pack or c._nat_classify or c._nat_egress)
        add_groups(lane, c, c.name)
        deliver_commands(lane, c, "g0", 5)
        pre = c._drain_classify()
        assert [cm.data for cm in pre[2]["g0"]] == list(range(5))
        assert c.counters.get("native_classify_batches") == 0
    finally:
        c.stop()


@needs_rt
def test_rt_lib_vanishing_midflight_counts_fallback(monkeypatch):
    lane = L.Lane("ra_tpu_torch")
    c = mk_coord(lane, "tnvf0", "classify")
    try:
        add_groups(lane, c, "tnvf0")
        monkeypatch.setattr(native, "classify", lambda codes, n: None)
        deliver_commands(lane, c, "g0", 5)
        pre = c._drain_classify()
        assert [cm.data for cm in pre[2]["g0"]] == list(range(5))
        assert c.counters.get("native_fallbacks") == 1
        assert c.counters.get("native_classify_batches") == 0
    finally:
        c.stop()
