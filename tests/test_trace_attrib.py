"""tools/trace_attrib.py: the interval union, the trace reduction, and its
refusal to run off the GPU."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import trace_attrib  # noqa: E402


@pytest.mark.parametrize("intervals,busy", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),
    ([(0, 10), (5, 12)], 12),
    ([(5, 12), (0, 10), (11, 20)], 20),
    ([(0, 30), (5, 10), (12, 14)], 30),
])
def test_busy_ns(intervals, busy):
    assert trace_attrib.busy_ns(intervals) == busy


def test_reduce_trace_counts_only_gpu_streams(tmp_path):
    with jax.profiler.trace(str(tmp_path)):
        jax.block_until_ready(jnp.arange(1000) * 2)
    rec = trace_attrib.reduce_trace(str(tmp_path))
    assert rec["events"] == 0 and rec["device_busy_s"] == 0


def test_refuses_cpu(capsys):
    assert trace_attrib.main() == 1
    assert "not a GPU" in capsys.readouterr().err
