"""Device-memory meter and budget source — the km_stat analog
(kalloc.c:218-224).

The reference's arena allocator can report its capacity/used bytes via
``km_stat``; here XLA owns allocation, so the meter tracks the bytes the
drivers actually dispatch: every ``note()`` records one device call's
buffer footprint (DP planes, traceback tables, snapshot rows — the
buffers that outgrow device memory first) and the module keeps the peak,
with the spec of the peak dispatch.  ``device_peak()`` and
``device_limit()`` read the runtime's own ``memory_stats()`` counters;
the CPU backend reports none.

Zero overhead when nothing reads it: plain integer max-tracking, no
device work, no synchronization.
"""

from __future__ import annotations

from typing import Optional, Tuple

_peak: int = 0
_peak_tag: str = ""
_peak_spec = None


def reset() -> None:
    global _peak, _peak_tag, _peak_spec
    _peak = 0
    _peak_tag = ""
    _peak_spec = None


def note(tag: str, nbytes: int, spec=None) -> None:
    """Record one device dispatch's buffer footprint (bytes)."""
    global _peak, _peak_tag, _peak_spec
    if nbytes > _peak:
        _peak = int(nbytes)
        _peak_tag = tag
        _peak_spec = spec


def note_arrays(tag: str, *objs, spec=None) -> int:
    """Sum ``nbytes`` over arrays / dicts of arrays and record it."""
    total = 0
    for o in objs:
        if o is None:
            continue
        if isinstance(o, dict):
            vals = o.values()
        elif isinstance(o, (list, tuple)):
            vals = o
        else:
            vals = (o,)
        for v in vals:
            total += int(getattr(v, "nbytes", 0) or 0)
    note(tag, total, spec)
    return total


def peak() -> Tuple[int, str]:
    """(peak dispatch bytes, tag of the peak dispatch) since reset()."""
    return _peak, _peak_tag


def peak_spec():
    """The engine spec of the peak dispatch since reset() (or None)."""
    return _peak_spec


def default_device():
    """The device a plain (unsharded) dispatch lands on: the one set by
    ``jax.default_device``, else the first local device."""
    import jax
    dev = jax.config.jax_default_device
    return dev if isinstance(dev, jax.Device) else jax.local_devices()[0]


def _stats(dev) -> Optional[dict]:
    """The device's memory_stats(); None on the CPU backend, which keeps
    no such counters.  An accelerator that reports none is an error: the
    drivers size their buffers from these numbers."""
    if dev.platform == "cpu":
        return None
    st = dev.memory_stats()
    if not st or "bytes_limit" not in st:
        raise RuntimeError(
            f"{dev.device_kind} reports no memory_stats()['bytes_limit']; "
            f"device buffer budgets cannot be sized")
    return st


def device_limit(dev=None) -> Optional[int]:
    """Bytes the runtime lets this process allocate on ``dev`` (default:
    the default device); None on the CPU backend."""
    st = _stats(dev if dev is not None else default_device())
    return None if st is None else int(st["bytes_limit"])


def device_peak(dev=None) -> Optional[int]:
    """Runtime peak_bytes_in_use on ``dev`` since process start; None on
    the CPU backend."""
    st = _stats(dev if dev is not None else default_device())
    return None if st is None else int(st.get("peak_bytes_in_use", 0))


def snapshot() -> dict:
    """One JSON-able report: the km_stat print."""
    b, tag = peak()
    out = {"peak_dispatch_bytes": b,
           "peak_dispatch_gb": round(b / 2**30, 3),
           "peak_dispatch": tag}
    dp = device_peak()
    if dp is not None:
        out["device_peak_bytes"] = dp
    return out
