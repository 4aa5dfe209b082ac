"""The main-path step of the port and its wrapper, on the CPU.

``consensus_step_packed_scat_plain`` and ``_sub_scat_plain`` (the plain
torch-op step, the step kernel's plain version) are held exactly against
the JAX package's ``consensus_step_packed_scat`` / ``_sub_scat`` over
the edge inputs of ``torch_step_cases``: every state field and every
egress row equal. The dispatching wrappers are checked on CPU tensors
(the plain step, no kernel launch) and on malformed inputs (they raise),
the kernel build's hash is checked to cover the headers a source
includes, and the kernel source's row and field order is checked against
the Python lists. The kernels themselves run in ``test_torch_cuda.py``.
"""

import os
import re
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ra_tpu.ops import consensus as J
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import step as S

import torch_step_cases as cases
from torch_parity import assert_state_equal, jax_copy

G = 96


def _jax_state(fields):
    return J.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()})


def _inputs(seed, p, k, near_max):
    rng = np.random.default_rng(seed)
    fields = cases.state_fields(rng, G, p, k, near_max=near_max)
    full = cases.packed(rng, fields, np.arange(G), G)
    gidx = cases.active_set(rng, G, 40, 64)
    sub = cases.packed(rng, fields, gidx, 64)
    return fields, full, gidx, sub


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("p", [1, 3, 5, 8, 12])
def test_plain_steps_match_jax_on_the_edges(p, k, near_max):
    """Two chained steps (full width, then active set, each fed the
    other's result): the port's plain step equals JAX's, exactly."""
    fields, full, gidx, sub = _inputs(1000 * p + k + near_max, p, k, near_max)
    jst = _jax_state(fields)
    tst = T.state_from_numpy(fields, "cpu")
    js, je = J.consensus_step_packed_scat(jax_copy(jst), jnp.asarray(full))
    ts, te = T.consensus_step_packed_scat_plain(tst, torch.from_numpy(full))
    np.testing.assert_array_equal(np.asarray(je), te.numpy(), err_msg="full egress")
    assert_state_equal(js, ts, "full")
    js, je = J.consensus_step_packed_sub_scat(
        jax_copy(js), jnp.asarray(sub), jnp.asarray(gidx))
    ts, te = T.consensus_step_packed_sub_scat_plain(
        ts, torch.from_numpy(sub), torch.from_numpy(gidx))
    np.testing.assert_array_equal(np.asarray(je), te.numpy(), err_msg="sub egress")
    assert_state_equal(js, ts, "sub")


def test_negative_self_slot_wraps_once_as_in_jax():
    """A self slot of -1 reads member P-1, as JAX's take_along_axis
    does. Where the port read True instead, the first difference here
    was ``became_leader`` at group 37, a candidate with self slot -1
    that JAX does not elect."""
    rng = np.random.default_rng(20261017)
    fields = cases.state_fields(rng, G, 3, 8, negative_slots=False)
    fields["self_slot"][2::7] = -1
    full = cases.packed(rng, fields, np.arange(G), G)
    js, je = J.consensus_step_packed_scat(_jax_state(fields), jnp.asarray(full))
    ts, te = T.consensus_step_packed_scat_plain(
        T.state_from_numpy(fields, "cpu"), torch.from_numpy(full))
    je = np.asarray(je)
    assert fields["self_slot"][37] == -1 and fields["role"][37] == T.R_CANDIDATE
    assert je[T.EGRESS_FIELDS.index("became_leader"), 37] == 0
    for i, name in enumerate(T.EGRESS_FIELDS):
        np.testing.assert_array_equal(je[i], te[i].numpy(), err_msg=name)
    assert_state_equal(js, ts, "full")


@pytest.mark.parametrize("near_max", [False, True])
def test_edge_inputs_cover_the_hazards(near_max):
    """The inputs above really hold every edge the kernel must reproduce
    (so a change to the generator cannot quietly drop one)."""
    p, k = 3, 8
    fields, full, gidx, sub = _inputs(7, p, k, near_max)
    R = cases.R
    _, eg = T.consensus_step_packed_scat_plain(
        T.state_from_numpy(fields, "cpu"), torch.from_numpy(full))
    agreed = eg[T.EGRESS_FIELDS.index("agreed_idx")].numpy()
    assert (agreed == -1).any()  # groups with no voting member
    ss = fields["self_slot"]
    assert (ss >= p).any() and (ss == -1).any() and (ss == -p).any()
    assert (ss < -p).any()
    assert (full[R["sender_slot"]] >= p).any() and (full[R["sender_slot"]] < 0).any()
    for row in ("a_gid", "w_gid"):
        ids = full[R[row]]
        assert (ids < 0).any() and (ids < -G).any() and (ids >= G).any(), row
    w = full[R["w_gid"]]
    w = np.where(w < 0, w + G, w)
    w = w[(w >= 0) & (w < G)]
    assert len(np.unique(w)) < len(w)  # duplicate watermark ids
    a = sub[R["a_gid"]]
    a = np.where(a < 0, a + G, a)
    a = a[(a >= 0) & (a < G)]
    assert len(np.unique(a)) == len(a)  # a_gid ids unique, by contract
    real = np.where(gidx < 0, gidx + G, gidx)
    assert not set(a) <= set(real[(real >= 0) & (real < G)])  # outside gidx
    assert (gidx == G - 1).any() and (gidx >= G).any() and (gidx < -G).any()
    assert ((gidx < 0) & (gidx >= -G)).any()  # a negative alias of a real id
    if near_max:
        nxt = eg[T.EGRESS_FIELDS.index("next_index")].numpy()
        assert (nxt < 0).any()  # an int32 sum wrapped
        assert fields["last_index"].max() >= cases.I32_MAX - 2


def test_cpu_tensors_take_the_plain_step_and_launch_nothing():
    fields, full, gidx, sub = _inputs(3, 3, 8, False)
    st = T.state_from_numpy(fields, "cpu")
    counts = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    for got, want in (
        (T.consensus_step_packed_scat(st, torch.from_numpy(full)),
         T.consensus_step_packed_scat_plain(st, torch.from_numpy(full))),
        (T.consensus_step_packed_sub_scat(
            st, torch.from_numpy(sub), torch.from_numpy(gidx)),
         T.consensus_step_packed_sub_scat_plain(
             st, torch.from_numpy(sub), torch.from_numpy(gidx))),
    ):
        assert torch.equal(got[1], want[1])
        for a, b in zip(got[0], want[0]):
            assert torch.equal(a, b)
    assert (S.LAUNCHES_FULL, S.LAUNCHES_SUB) == counts
    with pytest.raises(ValueError, match="CUDA"):
        S.launch_full(st, torch.from_numpy(full))


@pytest.mark.parametrize("kind", ["full", "sub"])
def test_cpu_steps_of_several_threads_run_one_at_a_time(monkeypatch, kind):
    """The CPU route runs the plain step under one process-wide lock, so
    coordinators stepping in several threads of one process never
    interleave their steps' ops (ROADMAP Queue 3 item 2: unserialized,
    a step's hundreds of small ops each released the interpreter lock
    and three stepping threads ran each step over ten times slower)."""
    import threading

    fields, full, gidx, sub = _inputs(5, 3, 8, False)
    st = T.state_from_numpy(fields, "cpu")
    name = f"consensus_step_packed{'_sub' if kind == 'sub' else ''}_scat"
    plain = getattr(T, f"{name}_plain")
    inside, most = [0], [0]
    count = threading.Lock()

    def watched(*args):
        with count:
            inside[0] += 1
            most[0] = max(most[0], inside[0])
        try:
            return plain(*args)
        finally:
            with count:
                inside[0] -= 1

    monkeypatch.setattr(T, f"{name}_plain", watched)
    args = ((torch.from_numpy(full),) if kind == "full"
            else (torch.from_numpy(sub), torch.from_numpy(gidx)))
    step = getattr(T, name)
    threads = [threading.Thread(target=lambda: [step(st, *args)
                                                for _ in range(10)])
               for _ in range(3)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert most[0] == 1


def _malformed(name):
    """(state, packed, gidx) with one thing wrong, and the error type."""
    fields, full, gidx, sub = _inputs(4, 3, 8, False)
    st = T.state_from_numpy(fields, "cpu")
    packed = torch.from_numpy(full)
    if name == "state_dtype":
        return st._replace(role=st.role.long()), packed, None, TypeError
    if name == "bool_as_int":
        return st._replace(votes=st.votes.int()), packed, None, TypeError
    if name == "peer_width":
        return st._replace(next_index=st.next_index[:, :2]), packed, None, ValueError
    if name == "ring_rows":
        return st._replace(term_suffix=st.term_suffix[:-1]), packed, None, ValueError
    if name == "short_field":
        return st._replace(unknown_hi=st.unknown_hi[1:]), packed, None, ValueError
    if name == "packed_rows":
        return st, packed[:-1], None, ValueError
    if name == "packed_dtype":
        return st, packed.long(), None, TypeError
    if name == "packed_width":
        return st, packed[:, :-1], None, ValueError
    if name == "gidx_dtype":
        return st, torch.from_numpy(sub), torch.from_numpy(gidx).long(), TypeError
    if name == "gidx_length":
        return st, torch.from_numpy(sub), torch.from_numpy(gidx[:-1]), ValueError
    raise AssertionError(name)


@pytest.mark.parametrize("name", [
    "state_dtype", "bool_as_int", "peer_width", "ring_rows", "short_field",
    "packed_rows", "packed_dtype", "packed_width", "gidx_dtype",
    "gidx_length",
])
def test_malformed_inputs_raise(name):
    st, packed, gidx, err = _malformed(name)
    with pytest.raises(err):
        if gidx is None:
            T.consensus_step_packed_scat(st, packed)
        else:
            T.consensus_step_packed_sub_scat(st, packed, gidx)


def test_build_hash_covers_included_headers(tmp_path):
    """A changed header that a kernel source includes (directly or
    through another header) names a new library; an unrelated file does
    not."""
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <stdint.h>\n#include "inc/a.cuh"\nint x;\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("// b, version 1\n")
    (tmp_path / "other.cuh").write_text("// unrelated\n")
    files = {os.path.relpath(f, tmp_path) for f in kernels.source_files(str(src))}
    assert files == {"k.cu", os.path.join("inc", "a.cuh"), os.path.join("inc", "b.cuh")}
    before = kernels.source_digest(str(src))
    (tmp_path / "other.cuh").write_text("// unrelated, changed\n")
    assert kernels.source_digest(str(src)) == before
    (tmp_path / "inc" / "b.cuh").write_text("// b, version 2\n")
    assert kernels.source_digest(str(src)) != before
    # the port's own kernels: both sources share the quorum network
    for name in ("quorum", "step"):
        got = kernels.source_files(os.path.join(kernels.CSRC, f"{name}.cu"))
        assert os.path.join(kernels.CSRC, "quorum_net.cuh") in got


def _cu_names(src, pattern, prefix=""):
    return [n[len(prefix):].lower() for n in re.findall(pattern, src)
            if not n.startswith("N_")]


def test_kernel_source_follows_the_python_layouts():
    """csrc/step.cu names its mailbox and egress rows (enums) and the
    state pointers it reads and writes (state_in, state_out) in the
    order of ops.consensus's lists and ops.step's OUT_FIELDS."""
    with open(os.path.join(kernels.CSRC, "step.cu")) as f:
        src = f.read()

    def body(start, end):
        i = src.index(start)
        return src[i:src.index(end, i)]

    assert _cu_names(body("enum MboxRow", "};"), r"\b(M_\w+|N_\w+)\b",
                     "M_") == list(T.MBOX_FIELDS + T.MBOX_SCAT_FIELDS)
    assert _cu_names(body("enum EgressRow", "};"), r"\b(E_\w+|N_\w+)\b",
                     "E_") == list(T.EGRESS_FIELDS)

    def pointers(fn):
        found = re.findall(r"s\.(\w+) = [ib]\[(\d+)\];", body(fn, "return s;"))
        assert [int(i) for _, i in found] == list(range(len(found)))
        return [name for name, _ in found]

    assert pointers("StateIn state_in(") == list(T.GroupState._fields)
    assert pointers("StateOut state_out(") == list(S.OUT_FIELDS)
    assert set(S.OUT_FIELDS) <= set(T.GroupState._fields)
