"""The user state-machine behaviour.

Capability parity with the reference's ``ra_machine`` behaviour
(reference: ``src/ra_machine.erl:232-311``): mandatory ``init``/``apply``;
optional ``state_enter``, ``tick``, ``snapshot_installed``, ``overview``,
``live_indexes``, ``version``/``which_module`` (machine versioning),
aux handlers. ``apply`` receives a meta dict with at least ``index`` and
``term`` plus ``system_time`` / ``machine_version`` / ``reply_mode`` when
relevant, and returns ``(new_state, reply)`` or
``(new_state, reply, effects)``.

Builtin commands are delivered to ``apply`` as tuples:
``("down", target, info)``, ``("nodeup", node)``, ``("nodedown", node)``,
``("machine_version", from_v, to_v)``, ``("timeout", name)`` (reference:
src/ra_machine.erl:108-111).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ra_tpu_torch.effects import Effect


class Machine:
    """Base class for user machines. Subclass and override."""

    # -- mandatory ---------------------------------------------------------

    def init(self, config: Dict[str, Any]) -> Any:
        raise NotImplementedError

    def apply(self, meta: Dict[str, Any], cmd: Any, state: Any):
        """Return (state, reply) or (state, reply, effects)."""
        raise NotImplementedError

    # -- optional ----------------------------------------------------------

    # Batched apply: an ra_tpu_torch extension beyond the reference behaviour
    # (the per-entry ``apply`` contract is unchanged; this is the
    # vectorization hook the batch backend uses when replies and effects
    # are not needed for a run of entries). Return the final state after
    # applying ``cmds`` (a list of command payloads at consecutive
    # indexes) or None to fall back to per-entry ``apply``.
    def apply_many(
        self, meta: Dict[str, Any], cmds: List[Any], state: Any
    ) -> Optional[Any]:
        return None

    def state_enter(self, role: str, state: Any) -> List[Effect]:
        return []

    def tick(self, time_ms: int, state: Any) -> List[Effect]:
        return []

    def snapshot_installed(self, meta, state, old_meta, old_state) -> List[Effect]:
        return []

    def overview(self, state: Any) -> Dict[str, Any]:
        return {"type": type(self).__name__}

    def live_indexes(self, state: Any) -> Sequence[int]:
        return ()

    def version(self) -> int:
        return 0

    def which_module(self, version: int) -> "Machine":
        """Return the machine implementation for a given version."""
        return self

    def snapshot_module(self):
        return None  # default snapshot codec

    # -- aux machine -------------------------------------------------------

    def init_aux(self, name: str) -> Any:
        return None

    def handle_aux(self, role: str, kind: str, cmd: Any, aux_state: Any, intern):
        """kind: "cast" | "call"; intern exposes server internals
        (ra_tpu_torch.aux.AuxContext). Return (reply, aux_state) or
        (reply, aux_state, effects)."""
        return None, aux_state


# -- machine factories -------------------------------------------------------
# Cold restart needs to reconstruct machines from persisted config alone
# (the reference stores the machine module atom in the server config and
# Erlang modules are globally addressable — src/ra_server_sup_sup.erl
# recover_config/2). The Python analog: a registered factory name or a
# "module:attr" dotted path, persisted in __server_config__ and resolved
# at boot.

_FACTORIES: Dict[str, Callable[[Dict[str, Any]], "Machine"]] = {}


def register_machine_factory(name: str, fn: Callable[[Dict[str, Any]], "Machine"]) -> None:
    _FACTORIES[name] = fn


def resolve_machine_factory(spec: str, machine_config: Optional[Dict[str, Any]] = None) -> "Machine":
    """Build a machine from a persisted factory spec: a name registered
    via ``register_machine_factory`` or an importable ``module:attr``
    callable taking the machine_config dict."""
    cfg = machine_config or {}
    fn = _FACTORIES.get(spec)
    if fn is None and ":" in spec:
        import importlib

        mod, attr = spec.split(":", 1)
        fn = getattr(importlib.import_module(mod), attr)
    if fn is None:
        raise KeyError(f"unknown machine factory {spec!r}")
    return fn(cfg)


def normalize_aux_result(res, aux_state) -> Tuple[Any, Any, List[Effect]]:
    """handle_aux contract: None | (reply, aux_state) |
    (reply, aux_state, effects) -> (reply, aux_state, effects). One
    definition shared by both execution backends."""
    if res is None:
        return None, aux_state, []
    if len(res) == 2:
        return res[0], res[1], []
    return res[0], res[1], list(res[2])


def normalize_apply_result(res) -> Tuple[Any, Any, List[Effect]]:
    if isinstance(res, tuple):
        if len(res) == 2:
            return res[0], res[1], []
        if len(res) == 3:
            return res[0], res[1], list(res[2])
    raise TypeError(f"machine apply must return a 2- or 3-tuple, got {res!r}")


class SimpleMachine(Machine):
    """Wraps a 2-arity fn as a machine (cf. ra_machine_simple,
    reference: src/ra_machine_simple.erl:12-24): state' = fn(cmd, state),
    reply is the new state."""

    def __init__(self, fn: Callable[[Any, Any], Any], initial_state: Any):
        self.fn = fn
        self.initial_state = initial_state

    def init(self, config):
        return self.initial_state

    def apply(self, meta, cmd, state):
        if isinstance(cmd, tuple) and cmd and cmd[0] in (
            "down",
            "nodeup",
            "nodedown",
            "machine_version",
            "timeout",
        ):
            return state, None  # simple machines ignore builtins
        new_state = self.fn(cmd, state)
        return new_state, new_state

    def apply_many(self, meta, cmds, state):
        fn = self.fn
        for cmd in cmds:
            if not (isinstance(cmd, tuple) and cmd and cmd[0] in (
                "down", "nodeup", "nodedown", "machine_version", "timeout",
            )):
                state = fn(cmd, state)
        return state

    def overview(self, state):
        return {"type": "simple", "state": state}


class VersionedMachine(Machine):
    """Helper for rolling machine upgrades: a registry of version ->
    machine module (reference capability: machine versioning,
    docs/internals/STATE_MACHINE_TUTORIAL.md:400-477)."""

    def __init__(self, versions: Dict[int, Machine]):
        if not versions:
            raise ValueError("need at least one version")
        self.versions = dict(versions)
        self._latest = max(versions)

    def version(self) -> int:
        return self._latest

    def which_module(self, version: int) -> Machine:
        eligible = [v for v in self.versions if v <= version]
        if not eligible:
            raise KeyError(f"no machine module for version {version}")
        return self.versions[max(eligible)]

    def init(self, config):
        return self.which_module(self._latest).init(config)

    def apply(self, meta, cmd, state):
        mv = meta.get("machine_version", self._latest)
        return self.which_module(mv).apply(meta, cmd, state)
