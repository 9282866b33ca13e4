"""vbz_compression_tpu — VBZ codec framework with an accelerator data plane.

A from-scratch re-design of the VBZ lossless signal codec
(delta → zig-zag → StreamVByte → zstd): JAX/XLA for the device data plane, a native C++ runtime for the HDF5 filter plugin, and
``jax.sharding`` data-parallelism over device meshes for bulk corpus work.
"""

__version__ = "0.1.0"

from .errors import (  # noqa: F401
    VBZ_DESTINATION_SIZE_ERROR,
    VBZ_FIRST_ERROR,
    VBZ_INPUT_SIZE_ERROR,
    VBZ_INTEGER_SIZE_ERROR,
    VBZ_OUT_OF_MEMORY_ERROR,
    VBZ_STREAMVBYTE_STREAM_ERROR,
    VBZ_VERSION_ERROR,
    VBZ_ZSTD_ERROR,
    VbzError,
    vbz_error_string,
    vbz_is_error,
)
from .options import (  # noqa: F401
    VBZ_DEFAULT_VERSION,
    CompressionOptions,
    compression_options,
)
