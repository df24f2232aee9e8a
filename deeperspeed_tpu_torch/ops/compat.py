"""Op availability registry (reference: `op_builder/builder.py:81`,
per-op `is_compatible()`): the port of `deeperspeed_tpu/ops/compat.py`.

One registry: the op_builder builders are the source of truth, one row
a Python op and one a C entry point of the kernel library
(`ops/hopper/_build.SIGNATURES`). A kernel is available when the
library builds and loads from `csrc/` and the card is ``sm_90``; on a
host without `nvcc` or without a card every kernel row reads
unavailable. `env_report` prints this matrix (reference
`env_report.py:23`).
"""

from .op_builder import ALL_OPS as BUILDERS

ALL_OPS = {name: builder.is_compatible for name, builder in BUILDERS.items()}


def kernel_ops():
    """The rows of the kernel library's C entry points, in
    `_build.SIGNATURES` order."""
    from .hopper._build import SIGNATURES
    return {name: ALL_OPS[name] for name in SIGNATURES}
