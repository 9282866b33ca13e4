"""Speed-of-light accounting helpers (utils/roofline.py)."""

import pytest

from vbz_compression_tpu.utils import roofline


def test_peak_h200():
    # NVIDIA H200 data sheet (SXM): 4.8 TB/s.
    assert roofline.hbm_peak_gbps("NVIDIA H200") == 4800.0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 80GB HBM3", ""])
def test_peak_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no published memory bandwidth"):
        roofline.hbm_peak_gbps(kind)


def test_svb_bytes_moved():
    # 1 Mi int16 values in, a 1.3 MB stream out (or the reverse).
    assert roofline.svb_bytes_moved(1 << 20, 2, 1_300_000) == \
        2 * (1 << 20) + 1_300_000


def test_measure_copy_gbps_runs():
    # The function itself, at a size the CPU test backend handles; the
    # number means nothing off the card.
    assert roofline.measure_copy_gbps(mib=1, reps=2, rounds=2) > 0
