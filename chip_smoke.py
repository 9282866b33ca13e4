"""Smoke test of the codec's device plane on an NVIDIA GPU.

Run from the root of a checkout, on a machine whose JAX has a CUDA device:

    python chip_smoke.py [--seed N]     # one card: every phase below
    python chip_smoke.py --four-cards   # the 4-card mesh path only

One card: (1) environment, (2) backend selection, (3) the bulk-repack job of
the reference perf harness — 100 MB of seeded int16 pseudo-reads through the
batch API, with and without zstd, (4) the 32020 lattice, eight flavors on
~8 MiB each, (5) the corpus driver on a one-card mesh, (6) memory, (7) one
call whose batch of streams passes 2 GiB, row by row against one-row calls.
Every stream of phases 3-5 is compared with the NumPy oracle
(``ops/scalar.py``) and every round trip bit for bit. Each phase prints its own lines; the last line is one JSON
object, ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count":
...}}``. The script exits non-zero, without that line, when JAX's default
device is not a GPU or any check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# Alone in a directory, without the package beside it, the script stops
# here with ImportError.
from vbz_compression_tpu import api  # noqa: E402
from vbz_compression_tpu.models import codec  # noqa: E402
from vbz_compression_tpu.ops import jax_svb, scalar  # noqa: E402
from vbz_compression_tpu.options import CompressionOptions  # noqa: E402
from vbz_compression_tpu.parallel import multihost, sharded  # noqa: E402
from vbz_compression_tpu.utils import compile_cache, workloads  # noqa: E402

CORPUS_BYTES = 100_000_000
LATTICE_BYTES = 8 << 20
# (name, integer_size, zigzag, version)
FLAVORS = [("zz16", 2, True, 0), ("none16", 2, False, 0),
           ("zz8", 1, True, 0), ("none8", 1, False, 0),
           ("zz32", 4, True, 0), ("none32", 4, False, 0),
           ("v1 zz8", 1, True, 1), ("v1 none8", 1, False, 1)]
TIERS = ("realistic", "mixed", "pure", "incompressible", "constant")
_DTYPE = {1: np.int8, 2: np.int16, 4: np.int32}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """``name, power limit`` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def phase_environment(cache_dir: str) -> str:
    dev = jax.devices()[0]
    card = card_line()
    log("env", f"jax {jax.__version__}, platform {dev.platform}, "
        f"{dev.device_kind} x{len(jax.devices())}; card: {card}")
    log("env", f"compile cache: {cache_dir}")
    return card


def phase_backend():
    os.environ.pop("VBZ_BACKEND", None)
    backend = api.default_backend()
    check(isinstance(backend, codec.DeviceSvbBackend),
          f"default backend is {type(backend).__name__}, not the device one")
    x = np.arange(5000, dtype=np.int16)
    streams, totals = backend._queue_encode(x, 2, True, 0)
    platforms = {d.platform for a in (streams, totals) for d in a.devices()}
    check(platforms == {"gpu"}, f"device arrays live on {platforms}")
    log("backend", f"default: {type(backend).__name__}; its arrays live on "
        f"{sorted(platforms)}")
    return backend


def select_per_bucket(reads, per_bucket: int = 4) -> list[int]:
    """Indices of up to ``per_bucket`` reads from every length bucket."""
    picked: dict[int, list[int]] = {}
    for i, r in enumerate(reads):
        b = picked.setdefault(codec.bucket_size(r.size), [])
        if len(b) < per_bucket:
            b.append(i)
    return sorted(i for idx in picked.values() for i in idx)


def phase_main_path(reads, backend, card: str,
                    min_checked: int = 16) -> list[bytes]:
    """Bulk repack through the batch API for filter options (0, 2, 1, 1)
    and (0, 2, 1, 0); returns the zstd-1 streams."""
    raw_bytes = sum(r.nbytes for r in reads)
    buckets = sorted({codec.bucket_size(r.size) for r in reads})
    log("main", f"{len(reads)} reads, {raw_bytes} bytes, lengths "
        f"{min(r.size for r in reads)}..{max(r.size for r in reads)}, "
        f"buckets {buckets}")
    checked = select_per_bucket(reads)
    check(len(checked) >= min(min_checked, len(reads)),
          f"only {len(checked)} reads to compare with the oracle")
    result = None
    for cd in ((0, 2, 1, 1), (0, 2, 1, 0)):
        opts = CompressionOptions.from_cd_values(cd)
        enc, enc_cold = _timed(lambda: api.vbz_compress_sized_batch(
            reads, opts, backend=backend))
        enc, enc_warm = _timed(lambda: api.vbz_compress_sized_batch(
            reads, opts, backend=backend))
        dec, dec_cold = _timed(lambda: api.vbz_decompress_sized_batch(
            enc, opts, backend=backend))
        dec, dec_warm = _timed(lambda: api.vbz_decompress_sized_batch(
            enc, opts, backend=backend))
        check(all(d == r.tobytes() for d, r in zip(dec, reads))
              and len(dec) == len(reads), f"round trip differs ({cd})")
        ref = api.vbz_compress_sized_batch([reads[i] for i in checked], opts,
                                           backend=scalar)
        check([enc[i] for i in checked] == ref,
              f"streams differ from the oracle ({cd})")
        comp = sum(map(len, enc))
        log("main", f"options {cd}: {len(reads)} reads round-trip exactly; "
            f"{len(checked)} reads across {len(buckets)} buckets "
            f"byte-identical to the oracle; ratio {comp / raw_bytes:.4f}")
        log("main", f"options {cd} on {card}: encode cold {enc_cold:.3f} s, "
            f"warm {enc_warm:.3f} s; decode cold {dec_cold:.3f} s, warm "
            f"{dec_warm:.3f} s (host wall clock, zstd on the host; "
            f"information, not the benchmark)")
        if cd[3]:
            result = enc
    return result


def phase_lattice(backend, nbytes: int, seed: int) -> None:
    """Every flavor on ``nbytes`` of input, a fifth from each content tier,
    through the single-chunk API without zstd."""
    for name, isz, zz, ver in FLAVORS:
        n = nbytes // isz // len(TIERS)
        x = np.concatenate([workloads.content(t, n, seed + k, _DTYPE[isz])
                            for k, t in enumerate(TIERS)])
        opts = CompressionOptions(zz, isz, 0, ver)
        (stream, t_enc) = _timed(lambda: api.vbz_compress_sized(
            x, opts, backend=backend))
        (out, t_dec) = _timed(lambda: api.vbz_decompress_sized(
            stream, opts, backend=backend))
        check(out == x.tobytes(), f"{name}: round trip differs")
        check(stream == api.vbz_compress_sized(x, opts, backend=scalar),
              f"{name}: stream differs from the oracle")
        log("lattice", f"{name}: {x.nbytes} bytes -> {len(stream)}, "
            f"byte-identical to the oracle, round trip exact "
            f"(first call {t_enc:.2f} s / {t_dec:.2f} s, compile included)")


def phase_corpus(reads, streams, backend) -> None:
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    mesh = sharded.make_mesh(jax.devices()[:1])
    out, secs = _timed(lambda: multihost.compress_signals(reads, opts,
                                                          mesh=mesh))
    check(out == streams, "corpus driver streams differ from the batch API")
    single = [api.vbz_compress_sized(r, opts, backend=backend) for r in reads]
    check(out == single, "corpus driver streams differ from "
          "api.vbz_compress_sized")
    log("corpus", f"{len(reads)} reads on a 1-card mesh: byte-identical to "
        f"api.vbz_compress_sized, in order ({secs:.3f} s, first call)")


def phase_memory(bucket: int) -> None:
    x = jnp.zeros((1, bucket), jnp.int16)
    n = jnp.asarray([bucket], jnp.int32)
    enc = jax_svb.encode_rows.lower(x, n, integer_size=2,
                                    use_zigzag=True).compile()
    s = jnp.zeros((1, codec.decode_capacity(bucket, 2, 0)), jnp.uint8)
    dec = jax_svb.decode_rows.lower(s, n, n, integer_size=2, use_zigzag=True,
                                    out_n=bucket).compile()
    for name, compiled in (("encode", enc), ("decode", dec)):
        log("memory", f"{name} zz16 [1, {bucket}]: "
            f"{compiled.memory_analysis()}")
    stats = jax.devices()[0].memory_stats() or {}
    log("memory", f"peak_bytes_in_use {stats.get('peak_bytes_in_use')}")


def phase_wide_batch(reads, min_stream_bytes: int = 2**31) -> None:
    """One zz16 call at the largest bucket with enough rows (the reads,
    repeated) that the batch's streams pass ``min_stream_bytes``: every
    row's stream and total equal its one-row encode, and the batch decodes
    back exactly. Checked on the device."""
    b = max(codec.bucket_size(r.size) for r in reads)
    src = [r for r in reads if codec.bucket_size(r.size) == b]
    rows = -(-min_stream_bytes // jax_svb.stream_capacity(b, 2, True))
    xs, ns = map(jnp.asarray, sharded.pad_chunks(src, pad_to=b))
    alone = [jax_svb.encode_rows(xs[i:i + 1], ns[i:i + 1], 2, True)
             for i in range(len(src))]
    pick = jnp.arange(rows) % len(src)
    x, n = xs[pick], ns[pick]
    (streams, totals), secs = _timed(lambda: jax.block_until_ready(
        jax_svb.encode_rows(x, n, 2, True)))
    check(bool(jnp.array_equal(
        streams, jnp.concatenate([s for s, _ in alone])[pick]))
        and bool(jnp.array_equal(
            totals, jnp.concatenate([t for _, t in alone])[pick])),
        f"[{rows}, {b}]: a row's stream differs from its one-row encode")
    out, ok = jax_svb.decode_rows(streams, n, totals, 2, True, b)
    valid = jnp.arange(b)[None, :] < n[:, None]   # x is zero past n
    check(bool(ok.all()) and bool(jnp.array_equal(jnp.where(valid, out, 0),
                                                  x)),
          f"[{rows}, {b}]: round trip differs")
    log("wide", f"zz16 [{rows}, {b}], {streams.nbytes} stream bytes in one "
        f"call: every row equals its one-row encode, round trip exact "
        f"({secs:.3f} s first encode, compile included)")
    log("wide", "encode memory: " + str(jax_svb.encode_rows.lower(
        x, n, integer_size=2, use_zigzag=True).compile().memory_analysis()))


def four_cards(reads) -> None:
    """The 4-card mesh path against the same batch on one card."""
    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 devices, has "
          f"{len(devices)}")
    mesh4, mesh1 = sharded.make_mesh(devices[:4]), sharded.make_mesh(
        devices[:1])
    by_bucket: dict[int, list[np.ndarray]] = {}
    for r in reads:
        by_bucket.setdefault(codec.bucket_size(r.size), []).append(r)
    for b, rows in sorted(by_bucket.items()):
        rows = rows + rows[-1:] * (-len(rows) % 4)
        batch, lens = sharded.pad_chunks(rows, pad_to=b)
        res = {}
        for name, mesh in (("4", mesh4), ("1", mesh1)):
            xb = sharded.shard_batch(mesh, batch)
            lb = sharded.shard_batch(mesh, lens)
            (streams, slens, total), secs = _timed(
                lambda: jax.block_until_ready(sharded.batch_encode_sharded(
                    xb, lb, mesh=mesh)))
            res[name] = (streams, np.asarray(slens), int(total), secs)
        streams4, slens4, total4, secs4 = res["4"]
        on = {s.device for s in streams4.addressable_shards}
        check(on == set(devices[:4]), f"shards live on {on}")
        s4 = np.asarray(streams4)
        check(np.array_equal(s4, np.asarray(res["1"][0]))
              and np.array_equal(slens4, res["1"][1]),
              f"bucket {b}: 4-card frames differ from 1-card frames")
        check(total4 == int(slens4.sum()), f"bucket {b}: psum total "
              f"{total4} != sum of frame lengths {int(slens4.sum())}")
        dec, ok = sharded.batch_decode_sharded(
            streams4, sharded.shard_batch(mesh4, lens),
            sharded.shard_batch(mesh4, slens4), mesh=mesh4, out_n=b)
        check(bool(np.asarray(ok).all()), f"bucket {b}: decode rejected")
        dec = np.asarray(dec)
        check(all(np.array_equal(dec[i, :k], r) for i, (k, r) in
                  enumerate(zip(lens, rows))),
              f"bucket {b}: 4-card round trip differs")
        log("four", f"bucket {b}: {len(rows)} rows on {len(on)} cards, "
            f"frames identical to 1 card and in order, psum {total4} bytes; "
            f"encode {secs4:.3f} s on 4 cards vs {res['1'][3]:.3f} s on 1 "
            f"(first call, compile included)")
    opts = CompressionOptions.from_cd_values((0, 2, 1, 1))
    four, secs4 = _timed(lambda: multihost.compress_signals(reads, opts,
                                                            mesh=mesh4))
    one, secs1 = _timed(lambda: multihost.compress_signals(reads, opts,
                                                           mesh=mesh1))
    check(four == one, "corpus driver: 4-card frames differ from 1 card")
    check(four[:8] == [api.vbz_compress_sized(r, opts) for r in reads[:8]],
          "corpus driver differs from api.vbz_compress_sized")
    log("four", f"corpus driver: {len(reads)} reads, frames identical on 4 "
        f"cards and 1, in order ({secs4:.3f} s vs {secs1:.3f} s)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the 4-card mesh path")
    args = parser.parse_args(argv)

    cache_dir = compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: JAX's default device is {dev.platform!r}, not a "
              f"GPU", file=sys.stderr)
        return 1

    t0 = time.perf_counter()
    card = phase_environment(cache_dir)
    reads, secs = _timed(lambda: workloads.pseudo_reads(CORPUS_BYTES,
                                                        args.seed))
    log("env", f"{len(reads)} pseudo-reads generated in {secs:.1f} s "
        f"(seed {args.seed})")
    if args.four_cards:
        four_cards(reads)
    else:
        backend = phase_backend()
        streams = phase_main_path(reads, backend, card)
        phase_lattice(backend, LATTICE_BYTES, args.seed)
        phase_corpus(reads, streams, backend)
        phase_memory(max(codec.bucket_size(r.size) for r in reads))
        phase_wide_batch(reads)
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
