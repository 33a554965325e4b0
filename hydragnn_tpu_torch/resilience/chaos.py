"""Fault injection (``HYDRAGNN_FAULT_PLAN``): deterministic chaos.

Counterpart of ``hydragnn_tpu/resilience/chaos.py``. A recovery path that
has never run does not work: this module injects the faults the resilience
layer claims to survive at exact (epoch, dispatch) coordinates, so the
tests and ``chip_smoke.py`` drive every path, and an operator rehearses a
preemption with one variable. The plan is a JSON list of events, inline or
``@/path/to/plan.json``::

    HYDRAGNN_FAULT_PLAN='[
      {"fault": "nan_batch",   "epoch": 0, "dispatch": 3},
      {"fault": "sigterm",     "epoch": 1, "dispatch": 5},
      {"fault": "hang",        "epoch": 0, "dispatch": 2, "seconds": 1.5},
      {"fault": "corrupt_latest", "epoch": 0},
      {"fault": "dead_shard",  "epoch": 0, "dispatch": 4, "peer": 1},
      {"fault": "slow_peer",   "epoch": 0, "dispatch": 2, "peer": 0, "seconds": 5},
      {"fault": "device_loss", "epoch": 1, "dispatch": 0, "device": 3},
      {"fault": "mesh_shrink", "epoch": 1, "dispatch": 1, "to": 2},
      {"fault": "double_fault", "inner": {"fault": "device_loss"}}
    ]'

* ``nan_batch`` multiplies the batch's node features by NaN after they are
  on the card: the dispatch copies the poisoned features into the captured
  step's static input slot, so the NaN flows through the real forward,
  loss and backward with no recapture;
* ``sigterm``: the process signals itself, and the installed
  ``PreemptionHandler`` checkpoints and stops at the next boundary;
* ``hang`` sleeps ``seconds`` inside the watchdog-guarded dispatch;
* ``corrupt_latest`` truncates the checkpoint ``latest`` names at the end of
  the epoch, so the next restore takes the manifest-checked fallback;
* ``dead_shard`` closes the ``peer``-th live ``ShardServer`` of this
  process and ``slow_peer`` delays its replies by ``seconds``
  (``datasets/sharded.py::live_servers``);
* ``device_loss`` marks ``count`` ranks (from the original rank ``device``
  down; default the last one alive) lost on the active elastic controller,
  and ``mesh_shrink`` cuts the survivors to ``to``: every rank drains at
  one dispatch boundary and the survivors go on in a smaller group
  (``elastic.py``);
* ``double_fault`` fires its ``inner`` fault (``device_loss``,
  ``mesh_shrink`` or ``sigterm``) while a recovery is under way.

Every rank of a process group reads the same plan and fires each event at
the same coordinates. ``dispatch`` omitted or null matches every dispatch of
the epoch; ``times`` caps the firings (default 1; -1: unlimited). The
serving fleet's faults (``replica_kill``, ``replica_slow``,
``rollout_during_load``) are parsed and refused: they come with a later
slice (ROADMAP item 10).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time

FLEET_FAULTS = ("replica_kill", "replica_slow", "rollout_during_load")

_FAULTS = ("nan_batch", "sigterm", "hang", "corrupt_latest", "dead_shard", "slow_peer",
           "device_loss", "mesh_shrink", "double_fault") + FLEET_FAULTS

# a double_fault's payload fires while a recovery is under way
_INNER_FAULTS = ("device_loss", "mesh_shrink", "sigterm")


@dataclasses.dataclass
class FaultEvent:
    fault: str
    epoch: int = 0
    dispatch: int | None = None  # None: every dispatch of the epoch
    seconds: float = 1.0  # hang / slow_peer
    times: int = 1  # -1: unlimited
    peer: int = 0  # dead_shard / slow_peer: index into live_servers()
    device: int | None = None  # device_loss: original rank (None: the last alive)
    count: int = 1  # device_loss: ranks lost at once
    to: int | None = None  # mesh_shrink: survivors
    inner: dict | None = None  # double_fault: the nested fault

    def matches(self, epoch: int, dispatch: int | None) -> bool:
        if self.times == 0 or self.epoch != epoch:
            return False
        return self.dispatch is None or self.dispatch == dispatch

    def consume(self) -> None:
        if self.times > 0:
            self.times -= 1


class FaultPlan:
    """The plan's events in order, and the log of those fired
    (``(fault, epoch, dispatch)``)."""

    def __init__(self, events):
        self.events = list(events)
        self.log: list[tuple[str, int, int | None]] = []

    @staticmethod
    def parse(text: str) -> "FaultPlan":
        if text.startswith("@"):
            with open(text[1:]) as f:
                raw = json.load(f)
        else:
            raw = json.loads(text)
        if isinstance(raw, dict):
            raw = [raw]
        events = []
        for i, e in enumerate(raw):
            fault = e.get("fault")
            if fault not in _FAULTS:
                raise ValueError(f"HYDRAGNN_FAULT_PLAN event {i}: fault {fault!r} not one of "
                                 f"{_FAULTS}")
            if fault in FLEET_FAULTS:
                raise NotImplementedError(
                    f"HYDRAGNN_FAULT_PLAN event {i}: the serving fleet's fault {fault!r} is not "
                    "ported (a later slice: the fleet's chaos drills, ROADMAP item 10)")
            inner = e.get("inner")
            if fault == "double_fault":
                inner = dict(inner or {"fault": "device_loss"})
                if inner.get("fault") not in _INNER_FAULTS:
                    raise ValueError(f"HYDRAGNN_FAULT_PLAN event {i}: double_fault inner fault "
                                     f"{inner.get('fault')!r} not one of {_INNER_FAULTS}")
            events.append(FaultEvent(
                fault=fault, epoch=int(e.get("epoch", 0)),
                dispatch=None if e.get("dispatch") is None else int(e["dispatch"]),
                seconds=float(e.get("seconds", 1.0)), times=int(e.get("times", 1)),
                peer=int(e.get("peer", 0)),
                device=None if e.get("device") is None else int(e["device"]),
                count=int(e.get("count", 1)), to=None if e.get("to") is None else int(e["to"]),
                inner=inner))
        return FaultPlan(events)

    @staticmethod
    def from_env() -> "FaultPlan | None":
        from ..utils import flags

        text = flags.get(flags.FAULT_PLAN)
        return FaultPlan.parse(str(text)) if text else None

    def _take(self, fault: str, epoch: int, dispatch: int | None):
        for ev in self.events:
            if ev.fault == fault and ev.matches(epoch, dispatch):
                ev.consume()
                self.log.append((fault, epoch, dispatch))
                return ev
        return None

    # -- loop hooks ----------------------------------------------------------
    def on_dispatch(self, epoch: int, dispatch: int, batch):
        """Fire the dispatch's faults; returns the batch, or the dispatch's
        list of batches, poisoned by a ``nan_batch``. Called inside the
        loop's watchdog-guarded dispatch, so an injected hang exercises the
        real timer."""
        ev = self._take("hang", epoch, dispatch)
        if ev is not None:
            time.sleep(ev.seconds)
        if self._take("sigterm", epoch, dispatch) is not None:
            os.kill(os.getpid(), signal.SIGTERM)
        ev = self._take("dead_shard", epoch, dispatch)
        if ev is not None:
            srv = _live_server(ev.peer)
            if srv is not None:
                srv.close()  # connections refuse from here on: the host-loss drill
        ev = self._take("slow_peer", epoch, dispatch)
        if ev is not None:
            srv = _live_server(ev.peer)
            if srv is not None:
                srv.set_delay(ev.seconds)  # alive, but past any deadline
        ev = self._take("device_loss", epoch, dispatch)
        if ev is not None:
            from .elastic import deliver_fault

            deliver_fault("device_loss", device=ev.device, count=ev.count)
        ev = self._take("mesh_shrink", epoch, dispatch)
        if ev is not None:
            from .elastic import deliver_fault

            deliver_fault("mesh_shrink", to=ev.to)
        if self._take("nan_batch", epoch, dispatch) is not None:
            batch = poison_batch(batch)
        return batch

    def on_recovery(self, recovery_no: int) -> list[dict]:
        """The ``double_fault`` drill: called by the elastic driver while a
        recovery is under way; returns the nested faults that fire now."""
        out: list[dict] = []
        for ev in self.events:
            if ev.fault != "double_fault" or ev.times == 0:
                continue
            ev.consume()
            self.log.append(("double_fault", -1, recovery_no))
            out.append(dict(ev.inner or {"fault": "device_loss"}))
        return out

    def on_epoch_end(self, epoch: int, log_name: str, path: str = "./logs/") -> None:
        """Epoch-scoped faults, after the epoch's checkpoints: each matching
        ``corrupt_latest`` fires once per epoch end (rank 0 writes, so rank
        0 corrupts)."""
        from ..parallel.comm import rank_of
        from ..train.checkpoint import checkpoint_dir

        for ev in self.events:
            if ev.fault != "corrupt_latest" or not ev.matches(epoch, None):
                continue
            ev.consume()
            self.log.append(("corrupt_latest", epoch, None))
            latest = os.path.join(checkpoint_dir(log_name, path), "latest")
            if rank_of() == 0 and os.path.islink(latest):
                corrupt_checkpoint(os.path.realpath(latest))


def _live_server(peer: int):
    """The ``peer``-th live ``ShardServer`` of this process, or None (with
    a note): a plan naming a server that never existed is inert."""
    from ..datasets.sharded import live_servers

    servers = live_servers()
    if 0 <= peer < len(servers):
        return servers[peer]
    print(f"[chaos] no live ShardServer at index {peer} ({len(servers)} registered); fault "
          "skipped", file=sys.stderr)
    return None


def poison_batch(batch):
    """The batch with its node features times NaN: same shape, dtype and
    device, and the NaN reaches the loss through the real forward. A list
    or tuple (a superstep block, a step's microbatches) is poisoned
    whole."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(poison_batch(b) for b in batch)
    return batch.replace(x=batch.x * float("nan"))


def corrupt_checkpoint(ckpt_path: str) -> str:
    """Truncate a checkpoint file to half its size: the stand-in for a node
    dying mid-write. Returns the file's path."""
    size = os.path.getsize(ckpt_path)
    with open(ckpt_path, "r+b") as f:
        f.truncate(max(size // 2, 1))
    return ckpt_path


__all__ = ["FLEET_FAULTS", "FaultEvent", "FaultPlan", "corrupt_checkpoint", "poison_batch"]
