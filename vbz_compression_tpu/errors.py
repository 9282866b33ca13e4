"""Error taxonomy for the VBZ codec.

Mirrors the reference C ABI error space (reference: ``vbz/vbz.h:13-27``):
``vbz_size_t`` is uint32 and errors live at the top of its range,
``(vbz_size_t)-1 .. (vbz_size_t)-7``, with ``vbz_is_error(v) == v >= VBZ_FIRST_ERROR``
(reference: ``vbz/vbz.cpp:61-64``).
"""

from __future__ import annotations

VBZ_SIZE_MAX = 2**32

VBZ_ZSTD_ERROR = VBZ_SIZE_MAX - 1
VBZ_INPUT_SIZE_ERROR = VBZ_SIZE_MAX - 2
VBZ_INTEGER_SIZE_ERROR = VBZ_SIZE_MAX - 3
VBZ_DESTINATION_SIZE_ERROR = VBZ_SIZE_MAX - 4
VBZ_STREAMVBYTE_STREAM_ERROR = VBZ_SIZE_MAX - 5
VBZ_VERSION_ERROR = VBZ_SIZE_MAX - 6
VBZ_OUT_OF_MEMORY_ERROR = VBZ_SIZE_MAX - 7
VBZ_FIRST_ERROR = VBZ_OUT_OF_MEMORY_ERROR

# Deprecated aliases kept for API parity (reference: vbz/vbz.h:24-27).
VBZ_STREAMVBYTE_INPUT_SIZE_ERROR = VBZ_INPUT_SIZE_ERROR
VBZ_STREAMVBYTE_INTEGER_SIZE_ERROR = VBZ_INTEGER_SIZE_ERROR
VBZ_STREAMVBYTE_DESTINATION_SIZE_ERROR = VBZ_DESTINATION_SIZE_ERROR

_ERROR_STRINGS = {
    VBZ_ZSTD_ERROR: "VBZ_ZSTD_ERROR",
    VBZ_INPUT_SIZE_ERROR: "VBZ_INPUT_SIZE_ERROR",
    VBZ_INTEGER_SIZE_ERROR: "VBZ_INTEGER_SIZE_ERROR",
    VBZ_DESTINATION_SIZE_ERROR: "VBZ_DESTINATION_SIZE_ERROR",
    VBZ_STREAMVBYTE_STREAM_ERROR: "VBZ_STREAMVBYTE_STREAM_ERROR",
    VBZ_VERSION_ERROR: "VBZ_VERSION_ERROR",
    VBZ_OUT_OF_MEMORY_ERROR: "VBZ_OUT_OF_MEMORY_ERROR",
}


def vbz_is_error(result_value: int) -> bool:
    """True when a codec result value encodes an error (``vbz/vbz.cpp:61-64``)."""
    return result_value >= VBZ_FIRST_ERROR


def vbz_error_string(error_value: int) -> str:
    """Human-readable name for an error value (``vbz/vbz.cpp:66-77``)."""
    return _ERROR_STRINGS.get(error_value, "VBZ_UNKNOWN_ERROR")


class VbzError(Exception):
    """Pythonic exception wrapper carrying the reference error code."""

    def __init__(self, code: int, detail: str | None = None):
        self.code = code
        msg = vbz_error_string(code)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


def raise_if_error(value: int, detail: str | None = None) -> int:
    if vbz_is_error(value):
        raise VbzError(value, detail)
    return value
