"""One process of a multi-process corpus run (spawned by the 2-process
distributed test, tests/test_multihost.py::test_two_process_corpus).

Usage: multihost_smoke.py <coordinator> <nproc> <pid> <out_dir> <paths...>
Prints one JSON line of global corpus stats (identical on every process —
they are allgathered over the jax.distributed backend).
"""

import json
import os
import sys


def main() -> int:
    coordinator, nproc, pid, out_dir = sys.argv[1:5]
    paths = sys.argv[5:]
    # Each process runs on its own virtual CPU mesh: two JAX processes must
    # not share one card.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from vbz_compression_tpu.parallel import multihost

    multihost.initialize(coordinator_address=coordinator,
                         num_processes=int(nproc), process_id=int(pid))
    stats = multihost.compress_corpus(paths, out_dir=out_dir)
    print(json.dumps({
        "pid": int(pid),
        "process_count": jax.process_count(),
        "files": stats.files,
        "reads": stats.reads,
        "raw_bytes": stats.raw_bytes,
        "compressed_bytes": stats.compressed_bytes,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
