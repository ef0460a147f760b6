"""strawboat_tpu_torch: strawboat's resident serving path, file scan and
general query path (sort, hash aggregate, join) on PyTorch + CUDA.

A port of ``strawboat_tpu`` (JAX/Pallas, the reference) to torch tensors,
with the reference's Pallas kernels rewritten by hand in CUDA C++ for the
NVIDIA H100.  Every entry that puts data on a device takes an explicit
``device``; there is no implicit "cuda if available" default.

The package imports ``torch`` and never JAX, and nothing of
``strawboat_tpu``: the host modules it needs (``errors``, ``constants``,
``meta``, ``util/``, ``native/``) are its own copies, under the JAX
package's module names.  pyarrow is imported lazily, only by the
``pa.Table`` front of ``make_resident`` and by ``to_arrow``.
"""

from .device import as_device, require_cuda  # noqa: F401

__version__ = "0.1.0"
