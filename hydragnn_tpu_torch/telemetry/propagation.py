"""Cross-process trace-context propagation over the array-frame wire.

Counterpart of ``hydragnn_tpu/telemetry/propagation.py``; the frame field
and its JSON blob are the JAX package's, so a port peer and a JAX peer
carry one ``request_id`` both ways. Without it the plane is per-process:
the moment a request crosses the wire (fleet router -> replica,
sharded-store client -> peer) its correlation ids die, so one fleet
predict can never be rendered as one timeline. This module carries them across:

* the CLIENT side (``RoundTripper.request``) calls :func:`inject` right
  where the auth token is stamped — when propagation is armed AND the
  ambient journal context holds a ``request_id``, one extra frame field
  (:data:`TRACE_FIELD`, a small JSON blob as uint8 bytes like every other
  string on this wire) rides along;
* the SERVER side (``WireServer``) calls :func:`extract` +
  :func:`scope` around ``handle_frame``, so every journal record and
  trace span the handler emits carries the SAME ``request_id`` the
  client minted — across processes, ``telemetry fleet`` merges them into
  one timeline.

Wire back-compat is by construction: the frame codec packs a dict of
named arrays and every receiver reads only the keys it knows, so an old
peer simply ignores :data:`TRACE_FIELD` and an old client simply never
sends it — no version negotiation, no decode errors (tested both
directions in ``tests/test_torch_trace_propagation.py``). Disabled
(``HYDRAGNN_TRACE_PROPAGATE=0`` / ``Telemetry.trace_propagate: false``),
:func:`inject` returns before touching the frame: ZERO added wire bytes.
"""

from __future__ import annotations

import json
import uuid

import numpy as np

from ..utils import flags
from . import journal, metrics

# The one optional frame field. Leading underscore keeps it visually apart
# from payload keys; no existing op uses the name.
TRACE_FIELD = "_trace_ctx"

# Correlation ids worth shipping. Everything else in the context (large or
# process-local values) stays home; the blob is bounded by construction.
_WIRE_KEYS = ("request_id", "parent_span", "run_id", "epoch", "step",
              "recovery_id")
_MAX_BLOB = 1024  # defensive cap on an inbound context blob

# Telemetry.trace_propagate config override (None = follow the env flag);
# same atomic-assignment pattern as metrics._ENABLED_OVERRIDE.
_PROPAGATE_OVERRIDE: bool | None = None


def set_propagate_enabled(value: bool | None) -> None:
    global _PROPAGATE_OVERRIDE
    _PROPAGATE_OVERRIDE = None if value is None else bool(value)


def propagate_enabled() -> bool:
    """Propagation is armed AND the telemetry plane is live."""
    if not metrics.enabled():
        return False
    if _PROPAGATE_OVERRIDE is not None:
        return _PROPAGATE_OVERRIDE
    return bool(flags.get(flags.TRACE_PROPAGATE))


def new_request_id() -> str:
    """Mint a fleet-unique request id (16 hex chars — short enough to
    read in a journal line, unique enough for any real request volume)."""
    return uuid.uuid4().hex[:16]


def wire_context() -> dict:
    """The shippable subset of the ambient journal context: the wire keys
    only, values coerced to JSON scalars."""
    ctx = journal.get_context()
    out = {}
    for key in _WIRE_KEYS:
        value = ctx.get(key)
        if value is None:
            continue
        out[key] = value if isinstance(value, (int, float)) else str(value)
    return out


def inject(fields: dict, parent_span: str | None = None) -> dict:
    """Stamp the trace-context field into an outgoing frame's fields —
    in place, returning the dict. A no-op (nothing added, zero wire
    bytes) unless propagation is armed and the ambient context carries a
    ``request_id``; an outbound frame with no request to correlate has
    nothing useful to ship."""
    if not propagate_enabled():
        return fields
    ctx = wire_context()
    if not ctx.get("request_id"):
        return fields
    if parent_span is not None:
        ctx["parent_span"] = parent_span
    blob = json.dumps(ctx, separators=(",", ":")).encode()
    fields[TRACE_FIELD] = np.frombuffer(blob, dtype=np.uint8)
    return fields


def extract(frame: dict) -> dict:
    """Pull the trace context out of a decoded inbound frame. Returns
    ``{}`` for legacy frames (no field), oversized blobs, or anything
    that does not decode to a flat dict of scalar ids — a malformed
    context must never kill the request it rode in on."""
    raw = frame.get(TRACE_FIELD)
    if raw is None:
        return {}
    try:
        blob = bytes(np.asarray(raw, dtype=np.uint8))
        if len(blob) > _MAX_BLOB:
            return {}
        ctx = json.loads(blob.decode())
    except Exception:
        return {}
    if not isinstance(ctx, dict):
        return {}
    out = {}
    for key in _WIRE_KEYS:
        value = ctx.get(key)
        if isinstance(value, (str, int, float)):
            out[key] = value
    return out


def scope(ctx: dict):
    """Enter the extracted context as the calling thread's journal scope
    (``journal.scoped_context``); an empty context scopes nothing, so the
    legacy path stays a plain passthrough."""
    return journal.scoped_context(**ctx)


__all__ = [
    "TRACE_FIELD",
    "extract",
    "inject",
    "new_request_id",
    "propagate_enabled",
    "scope",
    "set_propagate_enabled",
    "wire_context",
]
