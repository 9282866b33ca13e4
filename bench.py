"""Benchmark: codec throughput on the int16 signal hot path, on one GPU.

Prints JSON lines, the headline last; every line names the device it ran on
(``platform``, ``device_kind``, ``device_count``):

  {"metric": "int16_signal_pipeline_encdec_throughput", ...}   # svb+zstd1
  {"metric": "int16_signal_pipeline_own_encoder", ...}         # own zstd
  {"metric": "int16_signal_codec_encdec_throughput", ...}      # svb stage

- value: combined (harmonic-mean) encode+decode throughput, GB/s of raw
  int16 signal. The svb-stage line is device-resident: each jitted step of
  the XLA plane is timed to ``block_until_ready``, median of repeated calls.
  The pipeline lines are host-to-host wall clock through the public batch
  API with the default backend (the device plane on a GPU) and the threaded
  host zstd stage — what a plugin or CLI user gets.
- The svb line carries each tier's share of two bandwidth bounds: a plain
  XLA copy measured in the same process and the device's published peak
  (``utils/roofline.py``), over the bytes the stage must move.

Workloads come from NumPy with fixed seeds (``utils/workloads.py``). The
headline tier is the reference perf harness's pseudo-reads (lengths 30k-200k,
sigma 12 on [0, 2000], ``vbz/perf/test_data_generator.h:28-74``): read
boundaries leave a few two-byte deltas in almost every 64K block. The
mixed (sigma 50), pure (no resets) and incompressible tiers are extra fields
on the headline line.

Run on a machine whose JAX has a GPU: ``python bench.py``. Without one it
exits with an error; it does not fall back to the CPU.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

B, N = 4, 4 * 1024 * 1024  # 4 rows x 8 MiB of int16 per tier
TIERS = {"clean": "realistic", "mixed": "mixed", "pure": "pure",
         "hard": "incompressible"}


def _hm(enc: float, dec: float) -> float:
    return 2 * enc * dec / (enc + dec)


def _device():
    import jax

    from vbz_compression_tpu.utils import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: JAX's default device is {dev.platform!r}"
                         f", not a GPU")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def _median_seconds(fn, reps: int = 20) -> float:
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t)
    return float(np.median(times))


def device_codec_gbps(kind: str) -> dict:
    """svb-stage throughput on the device per content tier, round trip
    checked on the device for every row."""
    import jax.numpy as jnp

    from vbz_compression_tpu.ops import jax_svb
    from vbz_compression_tpu.utils import roofline, workloads

    copy_gbps = roofline.measure_copy_gbps()
    peak_gbps = roofline.hbm_peak_gbps(kind)
    n = jnp.full((B,), N, jnp.int32)
    tiers = {}
    for tier, content in TIERS.items():
        x = jnp.asarray(workloads.content(content, B * N, seed=11)
                        .reshape(B, N))

        def enc(x=x):
            return jax_svb.encode_rows(x, n, 2, True)

        streams, totals = enc()

        def dec(streams=streams, totals=totals):
            return jax_svb.decode_rows(streams, n, totals, 2, True, N)

        out, ok = dec()
        assert bool(ok.all()) and bool(jnp.array_equal(out, x)), \
            f"round trip differs on the device ({tier})"
        enc_s, dec_s = _median_seconds(enc), _median_seconds(dec)
        moved = roofline.svb_bytes_moved(B * N, 2, int(totals.sum()))
        rec = {"enc": x.nbytes / enc_s / 1e9, "dec": x.nbytes / dec_s / 1e9}
        rec["combined"] = _hm(rec["enc"], rec["dec"])
        for d, s in (("enc", enc_s), ("dec", dec_s)):
            rec[f"pct_of_copy_{d}"] = 100 * moved / s / 1e9 / copy_gbps
            rec[f"pct_of_peak_{d}"] = 100 * moved / s / 1e9 / peak_gbps
        print(f"# {tier}: enc {rec['enc']:.3f} / dec {rec['dec']:.3f} GB/s",
              file=sys.stderr)
        tiers[tier] = rec
    tiers["_roofline"] = {"copy_gb_s": copy_gbps, "peak_gb_s": peak_gbps}
    return tiers


def pipeline_gbps(encoder: str | None = None, reps: int = 5,
                  dec_reps: int | None = None) -> dict:
    """Full-pipeline (svb + zstd level 1) wall clock through the public
    batch API — host bytes to host bytes, default backend + threaded zstd.

    ``encoder`` selects the zstd stage ("own" = the from-scratch RFC 8878
    encoder) through the VBZ_ZSTD_ENCODER variable the batch API's zstd
    stage reads."""
    from vbz_compression_tpu import api
    from vbz_compression_tpu.options import CompressionOptions
    from vbz_compression_tpu.utils import workloads

    chunks = workloads.pseudo_reads(32 << 20, seed=42)
    total = sum(c.nbytes for c in chunks)
    opts = CompressionOptions(perform_delta_zig_zag=True, integer_size=2,
                              zstd_compression_level=1, vbz_version=0)

    prev_env = os.environ.get("VBZ_ZSTD_ENCODER")
    if encoder is not None:
        os.environ["VBZ_ZSTD_ENCODER"] = encoder
    try:
        streams = api.vbz_compress_sized_batch(chunks, opts)
        enc_s = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            streams = api.vbz_compress_sized_batch(chunks, opts)
            enc_s = min(enc_s, time.perf_counter() - t0)
        outs = api.vbz_decompress_sized_batch(streams, opts)
        dec_s = float("inf")
        # The decode leg is stock libzstd whatever ``encoder`` is: always
        # take at least three samples of it.
        for _ in range(dec_reps if dec_reps is not None else max(reps, 3)):
            t0 = time.perf_counter()
            outs = api.vbz_decompress_sized_batch(streams, opts)
            dec_s = min(dec_s, time.perf_counter() - t0)
    finally:
        if encoder is not None:
            if prev_env is None:
                os.environ.pop("VBZ_ZSTD_ENCODER", None)
            else:
                os.environ["VBZ_ZSTD_ENCODER"] = prev_env
    for c, o in zip(chunks, outs):
        assert c.tobytes() == o, "pipeline round-trip mismatch"
    enc_gbps, dec_gbps = total / enc_s / 1e9, total / dec_s / 1e9
    nout = sum(map(len, streams))
    print(f"# pipeline[{encoder or 'libzstd'}] encode {enc_gbps:.3f} GB/s, "
          f"decode {dec_gbps:.3f} GB/s, ratio {nout / total:.4f}",
          file=sys.stderr)
    return {"enc": enc_gbps, "dec": dec_gbps,
            "combined": _hm(enc_gbps, dec_gbps), "bytes": nout}


def main() -> None:
    device = _device()

    pipe = pipeline_gbps()
    print(json.dumps({
        "metric": "int16_signal_pipeline_encdec_throughput",
        "value": round(pipe["combined"], 4),
        "unit": "GB/s",
        "encode_gb_s": round(pipe["enc"], 4),
        "decode_gb_s": round(pipe["dec"], 4),
        **device,
    }))

    own = pipeline_gbps(encoder="own", reps=3)
    print(json.dumps({
        "metric": "int16_signal_pipeline_own_encoder",
        "value": round(own["combined"], 4),
        "unit": "GB/s",
        "encode_gb_s": round(own["enc"], 4),
        "decode_gb_s": round(own["dec"], 4),
        "size_vs_libzstd": round(own["bytes"] / pipe["bytes"], 4),
        **device,
    }))

    tiers = device_codec_gbps(device["device_kind"])
    roof = tiers.pop("_roofline")
    clean = tiers["clean"]
    line = {
        "metric": "int16_signal_codec_encdec_throughput",
        "value": round(clean["combined"], 4),
        "unit": "GB/s",
        "encode_gb_s": round(clean["enc"], 4),
        "decode_gb_s": round(clean["dec"], 4),
        "copy_gb_s": round(roof["copy_gb_s"], 1),
        "peak_gb_s": roof["peak_gb_s"],
        **device,
    }
    for tier, d in tiers.items():
        if tier != "clean":
            line[f"{tier}_gb_s"] = round(d["combined"], 4)
            line[f"{tier}_encode_gb_s"] = round(d["enc"], 4)
            line[f"{tier}_decode_gb_s"] = round(d["dec"], 4)
        for k in ("pct_of_copy_enc", "pct_of_copy_dec", "pct_of_peak_enc",
                  "pct_of_peak_dec"):
            line[f"{tier}_{k}"] = round(d[k], 2)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
