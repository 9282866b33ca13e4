"""Speed-of-light (roofline) accounting for the codec on the device.

The reference counts raw bytes/s per config (vbz/perf/vbz_perf.cpp:45-46,
101-102). On an accelerator the codec is bandwidth-bound, so the yardstick
is the share of memory bandwidth a kernel reaches: the bytes the algorithm
must move (:func:`svb_bytes_moved`) over its kernel time, against two
denominators — the device's published peak (:func:`hbm_peak_gbps`) and a
plain XLA copy measured in the same process (:func:`measure_copy_gbps`).
"""

from __future__ import annotations

import time

import numpy as np

import jax
import jax.numpy as jnp

# Published device-memory bandwidth by ``jax.Device.device_kind``.
# NVIDIA H200 Tensor Core GPU data sheet (SXM): 141 GB HBM3e at 4.8 TB/s.
HBM_PEAK_GB_S = {
    "NVIDIA H200": 4800.0,
}


def hbm_peak_gbps(device_kind: str) -> float:
    """Published memory bandwidth (GB/s) of ``device_kind``; a device not
    in the table is an error, not a default."""
    try:
        return HBM_PEAK_GB_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to HBM_PEAK_GB_S with its source") \
            from None


def svb_bytes_moved(n_values: int, itemsize: int, stream_bytes: int) -> int:
    """Least device-memory traffic of one direction of the svb stage: the
    raw integers in and the stream out (encode), or the reverse (decode)."""
    return n_values * itemsize + stream_bytes


@jax.jit
def _copy(x):
    return x + 1


def measure_copy_gbps(mib: int = 1024, reps: int = 10,
                      rounds: int = 5) -> float:
    """Bandwidth (GB/s, read and write counted) of a plain XLA copy of
    ``mib`` MiB of int32: ``reps`` calls back to back, timed to
    ``block_until_ready`` of the last, median over ``rounds``."""
    x = jnp.arange(mib * (1 << 20) // 4, dtype=jnp.int32)
    jax.block_until_ready(_copy(x))
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(reps):
            y = _copy(x)
        jax.block_until_ready(y)
        times.append((time.perf_counter() - t) / reps)
    return 2 * x.nbytes / float(np.median(times)) / 1e9
