"""Backend selection: api.default_backend resolves the device plane on a GPU
-> native C++ -> NumPy oracle, with VBZ_BACKEND forcing a specific one.

Counterpart of the reference's single-path design (its C library has one
codec per platform, chosen at compile time via __SSE3__ —
vbz/v0/vbz_streamvbyte_impl.h:103-107); here the choice is at runtime, so
the resolution order is contract and must be pinned by tests.
"""

import numpy as np
import pytest

from vbz_compression_tpu import api
from vbz_compression_tpu.models.codec import DeviceSvbBackend
from vbz_compression_tpu.ops import scalar


@pytest.fixture(autouse=True)
def _reset_auto(monkeypatch):
    monkeypatch.delenv("VBZ_BACKEND", raising=False)
    monkeypatch.setattr(api, "_AUTO_BACKEND", None)
    yield
    monkeypatch.setattr(api, "_AUTO_BACKEND", None)


def _native_available() -> bool:
    try:
        from vbz_compression_tpu import native_backend

        native_backend.lib()
        return True
    except ImportError:
        return False


def _fake_platform(monkeypatch, platform):
    class FakeDev:
        pass

    FakeDev.platform = platform
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeDev()])


def test_forced_by_env(monkeypatch):
    monkeypatch.setenv("VBZ_BACKEND", "scalar")
    assert api.default_backend() is scalar
    monkeypatch.setenv("VBZ_BACKEND", "device")
    assert isinstance(api.default_backend(), DeviceSvbBackend)
    monkeypatch.setenv("VBZ_BACKEND", "bogus")
    with pytest.raises(ValueError):
        api.default_backend()


@pytest.mark.parametrize("name", ["pallas", "jax"])
def test_retired_backend_names_rejected(monkeypatch, name):
    # One name per backend: the old accelerator names are not aliases.
    monkeypatch.setenv("VBZ_BACKEND", name)
    with pytest.raises(ValueError):
        api.default_backend()


def test_forced_native(monkeypatch):
    if not _native_available():
        pytest.skip("libvbz_native.so not built")
    from vbz_compression_tpu.native_backend import NativeSvbBackend

    monkeypatch.setenv("VBZ_BACKEND", "native")
    assert isinstance(api.default_backend(), NativeSvbBackend)


def test_auto_prefers_accelerator(monkeypatch):
    _fake_platform(monkeypatch, "gpu")
    assert isinstance(api.default_backend(), DeviceSvbBackend)


@pytest.mark.parametrize("platform", ["cpu", "METAL"])
def test_auto_without_gpu_is_host_codec(monkeypatch, platform):
    # Only a GPU gets the device plane; every other platform runs the svb
    # stage on the host.
    _fake_platform(monkeypatch, platform)
    resolved = api.default_backend()
    assert not isinstance(resolved, DeviceSvbBackend)
    if _native_available():
        from vbz_compression_tpu.native_backend import NativeSvbBackend

        assert isinstance(resolved, NativeSvbBackend)
    else:
        assert resolved is scalar


def test_auto_gpu_start_failure_propagates(monkeypatch):
    # A device that fails to start must not turn into a silent CPU run.
    import jax

    def broken(*a):
        raise RuntimeError("no CUDA device")

    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError):
        api.default_backend()


def test_auto_on_cpu_prefers_native_then_scalar(monkeypatch):
    # Tests run with JAX_PLATFORMS=cpu (conftest), so auto must skip the
    # device plane.
    resolved = api.default_backend()
    if _native_available():
        from vbz_compression_tpu.native_backend import NativeSvbBackend

        assert isinstance(resolved, NativeSvbBackend)
    else:
        assert resolved is scalar


def test_default_roundtrip_uses_auto_backend():
    # Quick-start call pattern: no backend argument anywhere.
    sig = (np.arange(10000) % 311).astype(np.int16)
    comp = api.compress(sig)
    out = api.decompress(comp.tobytes(), np.int16)
    assert np.array_equal(out, sig)
