"""Where the time of a bulk repack goes: wall time against device time.

Runs the bulk-repack job (seeded int16 pseudo-reads of the reference perf
harness) through the batch API on the default backend, once to compile and
once under ``jax.profiler.trace``, per direction and filter options. From the
trace it prints one JSON line per call: wall seconds, device-busy seconds
(the union of the GPU stream events), their share of the wall, memcpy and
kernel seconds, and the top events by total time; then a cProfile listing
of one more, untraced call (host time by function).

    python tools/trace_attrib.py

Run it on a machine whose JAX has a GPU; each trace goes to a temporary
directory, deleted after reduction.
"""

from __future__ import annotations

import cProfile
import glob
import io
import json
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0)


def reduce_trace(trace_dir: str, top: int = 8) -> dict:
    """Device time of the GPU stream events in one ``jax.profiler`` trace."""
    import jax

    pb = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)[0]
    data = jax.profiler.ProfileData.from_file(pb)
    per_name, ivs, kinds = {}, [], {"memcpy": 0, "kernel": 0}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "Stream" not in line.name:
                continue
            for e in line.events:
                per_name[e.name] = per_name.get(e.name, 0) + e.duration_ns
                ivs.append((e.start_ns, e.end_ns))
                kinds["memcpy" if "memcpy" in e.name.lower() else
                      "kernel"] += e.duration_ns
    names = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_busy_s": busy_ns(ivs) / 1e9,
            "memcpy_s": kinds["memcpy"] / 1e9,
            "kernel_s": kinds["kernel"] / 1e9, "events": len(ivs),
            "top_ms": {k: v / 1e6 for k, v in names}}


def main() -> int:
    sys.path.insert(0, REPO)
    import jax

    from vbz_compression_tpu import api
    from vbz_compression_tpu.options import CompressionOptions
    from vbz_compression_tpu.utils import compile_cache, workloads

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"trace_attrib: JAX's default device is {dev.platform!r}, not "
              f"a GPU", file=sys.stderr)
        return 1
    reads = workloads.pseudo_reads(100_000_000, seed=0)
    for cd in ((0, 2, 1, 0), (0, 2, 1, 1)):
        opts = CompressionOptions.from_cd_values(cd)
        enc = api.vbz_compress_sized_batch(reads, opts)
        api.vbz_decompress_sized_batch(enc, opts)
        calls = (("encode", lambda: api.vbz_compress_sized_batch(reads, opts)),
                 ("decode", lambda: api.vbz_decompress_sized_batch(enc, opts)))
        for name, fn in calls:
            with tempfile.TemporaryDirectory() as out_dir:
                with jax.profiler.trace(out_dir):
                    t = time.perf_counter()
                    fn()
                    wall = time.perf_counter() - t
                rec = {"call": name, "options": cd, "reads": len(reads),
                       "wall_s": wall, **reduce_trace(out_dir),
                       "device_kind": dev.device_kind}
            rec["busy_share_of_wall"] = rec["device_busy_s"] / wall
            print(json.dumps(rec), flush=True)
            prof = cProfile.Profile()
            prof.runcall(fn)
            listing = io.StringIO()
            pstats.Stats(prof, stream=listing).sort_stats(
                "tottime").print_stats(12)
            print(f"# cProfile {name} {cd}", flush=True)
            print("\n".join(listing.getvalue().splitlines()[:32]),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
