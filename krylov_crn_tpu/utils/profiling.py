"""Device timing and the peak table that roofline shares divide by.

Timings fetch a scalar data-dependent on the work (``float(...)``), so
the host clock stops only after the device has finished, and repeated
work iterations are made data-dependent so XLA's loop-invariant code
motion cannot hoist the body out of a timing scan.
"""

from __future__ import annotations

import glob
import os
import tempfile
import time
from typing import Callable

import jax

__all__ = ["timed_scalar", "device_time_per_call", "kernel_time_per_call",
           "peak_bytes_per_s"]


def timed_scalar(fn: Callable, *args, reps: int = 3) -> float:
    """min wall time of fn(*args) where fn returns a scalar (fetched)."""
    float(fn(*args))  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def device_time_per_call(make_chained: Callable[[int], Callable], args,
                         k1: int = 1, k2: int = 17, reps: int = 3) -> float:
    """Per-call device time via chained-difference timing.

    ``make_chained(k)`` must return a jitted fn running k *data-dependent*
    iterations of the workload and returning a scalar. The difference
    (T(k2) - T(k1)) / (k2 - k1) cancels dispatch/transfer overheads.
    Host-clock differences can under-read; rates that are compared with a
    peak come from kernel_time_per_call instead.
    """
    t1 = timed_scalar(make_chained(k1), *args, reps=reps)
    t2 = timed_scalar(make_chained(k2), *args, reps=reps)
    return max((t2 - t1) / (k2 - k1), 0.0)


def kernel_time_per_call(fn: Callable, args, calls: int = 10,
                         windows: int = 5) -> list[float]:
    """Per-call device time read from the profiler: the summed durations
    of the kernels the accelerator ran for ``calls`` back-to-back calls
    of ``fn(*args)``, divided by ``calls``. One estimate per profiled
    window; returns them sorted (seconds), so callers report the median
    and the spread."""
    jax.block_until_ready(fn(*args))  # compile + warm outside the trace
    out = []
    for _ in range(windows):
        with tempfile.TemporaryDirectory() as d:
            jax.profiler.start_trace(d)
            try:
                for _ in range(calls):
                    r = fn(*args)
                jax.block_until_ready(r)
            finally:
                jax.profiler.stop_trace()
            out.append(_device_kernel_ns(d) * 1e-9 / calls)
    return sorted(out)


def _device_kernel_ns(trace_dir: str) -> int:
    """Total kernel nanoseconds on the device planes' stream lines of the
    one profile under ``trace_dir``. Raises when the profile holds no
    device kernels (a CPU backend, or a layout this parser does not
    know), rather than reporting zero."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one profile in {trace_dir}, "
                           f"found {len(paths)}")
    total, seen = 0, []
    for plane in ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            seen.append(f"{plane.name}:{line.name}")
            if line.name.startswith("Stream"):
                total += sum(int(e.duration_ns) for e in line.events)
    if total == 0:
        raise RuntimeError(f"no device kernels in the profile (device "
                           f"lines: {seen or 'none'})")
    return total


# Published device-memory bandwidth, bytes/s, keyed by
# jax.devices()[0].device_kind (NVIDIA's H100 and H200 data sheets).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # H100 SXM
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H200": 4.8e12,
}


def peak_bytes_per_s(device_kind: str | None = None) -> float:
    """Peak device-memory bandwidth of ``device_kind`` (default: the
    first JAX device). A kind missing from the table raises: no peak is
    assumed."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    try:
        return PEAK_BYTES_PER_S[device_kind]
    except KeyError:
        raise KeyError(f"no peak bandwidth known for device kind "
                       f"{device_kind!r}; add it to PEAK_BYTES_PER_S "
                       f"with its source") from None

