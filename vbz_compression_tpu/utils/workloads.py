"""Seeded signal workloads, generated with NumPy alone.

The shapes follow the reference perf harness: pseudo-signal reads with
lengths uniform in 30k-200k samples (``vbz/perf/test_data_generator.h:28-74``),
each an int16 random walk that jumps back to the midpoint when it leaves
``[lo, hi]`` (the recipe of ``native/gen_signal.cpp``), restarting at the
midpoint at every read.
"""

from __future__ import annotations

import numpy as np

_WINDOW = 16384  # walk steps drawn per pass (a reset cuts the pass short)


def walk(rng: np.random.Generator, n: int, sigma: float = 12.0,
         lo: int = 0, hi: int = 2000) -> np.ndarray:
    """One read: ``n`` int16 samples of a sigma-``sigma`` walk that resets
    to the midpoint of ``[lo, hi]`` whenever it leaves the range."""
    mid = 0.5 * (lo + hi)
    out = np.empty(n, np.float64)
    acc, i = mid, 0
    while i < n:
        acc_w = acc + np.cumsum(rng.normal(0.0, sigma, min(_WINDOW, n - i)))
        out_of_range = np.flatnonzero((acc_w < lo) | (acc_w > hi))
        if out_of_range.size:
            k = int(out_of_range[0])
            out[i:i + k] = acc_w[:k]
            out[i + k] = acc = mid
            i += k + 1
        else:
            out[i:i + acc_w.size] = acc_w
            acc = acc_w[-1]
            i += acc_w.size
    return out.astype(np.int16)


def pseudo_reads(total_bytes: int, seed: int, min_len: int = 30_000,
                 max_len: int = 200_000, sigma: float = 12.0, lo: int = 0,
                 hi: int = 2000) -> list[np.ndarray]:
    """int16 reads totalling about ``total_bytes`` (the last read is cut to
    fit), lengths uniform in ``[min_len, max_len]``."""
    rng = np.random.default_rng(seed)
    reads, left = [], total_bytes // 2
    while left > 0:
        n = min(int(rng.integers(min_len, max_len, endpoint=True)), left)
        reads.append(walk(rng, n, sigma, lo, hi))
        left -= n
    return reads


def content(tier: str, n: int, seed: int, dtype=np.int16) -> np.ndarray:
    """``n`` samples of one content tier, cast (wrapping) to ``dtype``:

    - ``realistic``: reads of 30k-200k samples, sigma 12 on [0, 2000];
    - ``mixed``: a sigma-50 walk on [-30000, 30000];
    - ``pure``: a sigma-12 walk that never resets;
    - ``incompressible``: uniform over the dtype;
    - ``constant``: one repeated value.
    """
    dtype = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if tier == "realistic":
        x = np.concatenate([np.zeros(0, np.int16)] + pseudo_reads(2 * n, seed))
    elif tier == "mixed":
        x = walk(rng, n, 50.0, -30000, 30000)
    elif tier == "pure":
        x = np.cumsum(rng.normal(0.0, 12.0, n)).astype(np.int64)
    elif tier == "incompressible":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, n, dtype=dtype,
                            endpoint=True)
    elif tier == "constant":
        x = np.full(n, 1234, np.int64)
    else:
        raise ValueError(f"unknown content tier {tier!r}")
    return x[:n].astype(np.int64).astype(dtype)
