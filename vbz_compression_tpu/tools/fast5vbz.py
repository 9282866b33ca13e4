"""fast5 re-compression CLI — the framework's counterpart of the reference
demo tool (reference: ``python/fast5compress/fast5vbz.py:17-74``).

Copies a fast5 file and rewrites every ``read_*/Raw/Signal`` dataset with the
vbz filter (one chunk per read), or back to gzip with ``-d``. Unlike the
reference tool this does not require the HDF5 filter plugin for *reading*
vbz inputs — raw chunks are decoded by the framework codec — and can run
the svb stage on the GPU through the device backend.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import api
from ..options import CompressionOptions
from ..utils import hdf5_chunks


def _read_signal(dset):
    """Read a signal dataset, decoding vbz chunks manually when the filter
    plugin is not loaded."""
    opts = hdf5_chunks.dataset_vbz_options(dset)
    if opts is None:
        return dset[...]
    chunks = hdf5_chunks.read_raw_chunks(dset)
    parts = [
        np.frombuffer(api.vbz_decompress_sized(data, opts), np.int16)
        for _off, data in chunks
    ]
    return np.concatenate(parts) if len(parts) != 1 else parts[0]


def _copy_tree_except_signals(src, dst, signal_paths):
    """Recursively copy ``src`` into ``dst``, skipping the signal datasets
    (copied file space is never reclaimed by HDF5 after a delete, so the
    output is built fresh instead — unlike the reference tool, which
    copy-then-deletes and bloats, ``python/fast5compress/fast5vbz.py:20``)."""
    import h5py

    for k, v in src.attrs.items():
        dst.attrs[k] = v
    for name, item in src.items():
        path = item.name.lstrip("/")
        if path in signal_paths:
            continue
        if isinstance(item, h5py.Group):
            sub = dst.create_group(name)
            _copy_tree_except_signals(item, sub, signal_paths)
        else:
            src.copy(name, dst, name=name)


def compress_fast5(input_path: str, output_path: str, *, decompress: bool,
                   vbz_version: int, zstd_level: int, backend) -> None:
    import h5py

    with h5py.File(input_path, "r") as fin, \
            h5py.File(output_path, "w") as f:
        signals = [(name, _read_signal(dset), dict(dset.attrs))
                   for name, dset in hdf5_chunks.iter_signal_datasets(fin)]
        skip = {f"{name}/Raw/Signal" for name, _sig, _a in signals}
        _copy_tree_except_signals(fin, f, skip)
        opts = CompressionOptions(True, 2, zstd_level, vbz_version)
        if not decompress:
            # Bulk device batch path: every chunk's encode is queued
            # on-device before any compressed frame is pulled back
            # (api.vbz_compress_sized_batch).
            payloads = dict(zip(
                (name for name, _s, _a in signals),
                api.vbz_compress_sized_batch(
                    [sig for _n, sig, _a in signals], opts,
                    backend=backend)))
        for name, signal, attrs in signals:
            grp = f[name]["Raw"]
            if decompress:
                new = grp.create_dataset(
                    "Signal", data=signal, chunks=(max(signal.size, 1),),
                    compression="gzip", compression_opts=1)
            else:
                payload = np.frombuffer(payloads[name], dtype=np.uint8)
                # Write the pre-compressed chunk directly — no plugin needed.
                space = h5py.h5s.create_simple((max(signal.size, 1),))
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_chunk((max(signal.size, 1),))
                dcpl.set_filter(hdf5_chunks.VBZ_FILTER_ID,
                                h5py.h5z.FLAG_OPTIONAL, opts.cd_values)
                did = h5py.h5d.create(
                    grp.id, b"Signal", h5py.h5t.NATIVE_INT16, space, dcpl)
                did.write_direct_chunk((0,), payload.tobytes())
                new = h5py.Dataset(did)
            for k, v in attrs.items():
                new.attrs[k] = v


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Compress fast5 signal data with the vbz codec")
    parser.add_argument("input", help="input fast5 file")
    parser.add_argument("output", help="output fast5 file")
    parser.add_argument("-d", "--decompress", action="store_true",
                        help="re-encode signals as gzip instead of vbz")
    parser.add_argument("--vbz-version", type=int, default=0, choices=(0, 1))
    parser.add_argument("--zstd-level", type=int, default=1)
    parser.add_argument("--backend",
                        choices=("auto", "device", "native", "scalar"),
                        default="auto",
                        help="auto = the device plane on a GPU, else native "
                             "C++, else the NumPy oracle "
                             "(api.default_backend)")
    args = parser.parse_args(argv)

    backend = None if args.backend == "auto" else \
        api._backend_by_name(args.backend)

    compress_fast5(args.input, args.output, decompress=args.decompress,
                   vbz_version=args.vbz_version, zstd_level=args.zstd_level,
                   backend=backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
