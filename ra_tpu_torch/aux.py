"""Aux-machine context: server internals exposed to ``handle_aux``.

Capability parity with the reference's ``ra_aux`` (``src/ra_aux.erl:
8-23``): from inside an aux callback a machine can read its own machine
state, members, indexes, log entries and overview without going through
the client API. Instances wrap a live ``Server`` and are only valid for
the duration of one ``handle_aux`` call.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from ra_tpu_torch.protocol import Entry, ServerId


class AuxContext:
    __slots__ = ("_server",)

    def __init__(self, server) -> None:
        self._server = server

    # -- machine / membership ---------------------------------------------

    def machine_state(self) -> Any:
        return self._server.machine_state

    def members(self) -> List[ServerId]:
        return self._server.members()

    def leader_id(self) -> Optional[ServerId]:
        return self._server.leader_id

    def current_term(self) -> int:
        return self._server.current_term

    # -- indexes ------------------------------------------------------------

    def commit_index(self) -> int:
        return self._server.commit_index

    def last_applied(self) -> int:
        return self._server.last_applied

    def last_index_term(self) -> Tuple[int, int]:
        return self._server.log.last_index_term()

    def snapshot_index_term(self) -> Optional[Tuple[int, int]]:
        return self._server.log.snapshot_index_term()

    # -- log reads -----------------------------------------------------------

    def log_fetch(self, idx: int) -> Optional[Entry]:
        return self._server.log.fetch(idx)

    def log_sparse_read(self, idxs: Sequence[int]) -> List[Entry]:
        return self._server.log.sparse_read(list(idxs))

    def overview(self) -> dict:
        return self._server.overview()
