"""Profiling and debug instrumentation.

The reference's observability is a google-benchmark harness plus a
compile-time ``VBZ_DEBUG`` checksum printer (reference:
``vbz_plugin/vbz_plugin.cpp:20-46``). The equivalents here:

- :func:`trace` — context manager around ``jax.profiler`` emitting an xprof
  trace directory for a codec region.
- :func:`annotate` — named trace annotation for individual stages.
- :func:`debug_checksums` — env-gated (``VBZ_DEBUG``) XOR checksums of
  buffers flowing through the Python pipeline, matching the plugin's format
  so host and device paths can be diffed.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np


def debug_enabled() -> bool:
    v = os.environ.get("VBZ_DEBUG", "")
    return bool(v) and v != "0"


def xor_checksum(buf) -> int:
    """Same rolling XOR as the native plugin's debug output."""
    arr = np.frombuffer(bytes(buf), dtype=np.uint8)
    pad = (-arr.size) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, np.uint8)])
    words = (arr.reshape(-1, 4).astype(np.uint32)
             << (np.arange(4, dtype=np.uint32) * 8)).sum(axis=1,
                                                         dtype=np.uint32)
    return int(np.bitwise_xor.reduce(words)) if words.size else 0


def debug_checksums(tag: str, **buffers) -> None:
    if not debug_enabled():
        return
    import sys

    parts = [f"{k} size={len(bytes(v))} checksum={xor_checksum(v):08x}"
             for k, v in buffers.items()]
    print(f"vbz debug: {tag}: " + " | ".join(parts), file=sys.stderr)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/vbz_trace"):
    """Capture a JAX profiler trace (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region annotation inside a trace."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield
