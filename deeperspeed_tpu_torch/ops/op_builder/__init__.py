"""Op build system (reference: `op_builder/builder.py:81`): the port of
`deeperspeed_tpu/ops/op_builder/__init__.py`.

The reference JIT-compiles CUDA extensions through torch's
cpp_extension. The port's split:

- **Hand-written Hopper kernels** (`ops/hopper`, sources in `csrc/`):
  one `nvcc` build of every source into one library with a plain C
  interface, loaded with ctypes (`ops/hopper/_build.py`). Each C entry
  point of `_build.SIGNATURES` is one builder here: it is compatible
  when the library builds and loads and the current card is ``sm_90``
  (the library is built for ``sm_90a`` only).
- **Python ops** (the fused optimizers' host wrappers, the transformer
  layer, sparse attention, flatten/unflatten): `load()` returns the
  module.

The JAX package's host-native builders (CPU Adam for the offload tier,
the async-IO spool engine) come with the offload tiers (ROADMAP A.7) and
have no builder here yet. `builder.load()` raises with the build log
when a kernel cannot build; `env_report` renders the availability
matrix.
"""

__all__ = [
    "OpBuilder", "FusedAdamBuilder", "FusedLambBuilder",
    "TransformerBuilder", "StochasticTransformerBuilder",
    "SparseAttnBuilder", "UtilsBuilder", "HopperKernelBuilder", "ALL_OPS",
    "get_default_compute_capabilities",
]

# the compute capability the kernel library is built for (sm_90a)
KERNEL_CAPABILITY = (9, 0)


class OpBuilder:
    """Base builder: `name`, `is_compatible()`, `load()` (reference
    `op_builder/builder.py:81`)."""

    NAME = "op"

    @property
    def name(self):
        return self.NAME

    def absolute_name(self):
        return f"deeperspeed_tpu_torch.ops.{self.NAME}"

    def sources(self):
        """Native source files, [] for Python ops."""
        return []

    def is_compatible(self):
        try:
            self.load()
            return True
        except Exception:
            return False

    def load(self):
        raise NotImplementedError

    def builder(self):  # reference API (returns the torch ext builder)
        return self


class FusedAdamBuilder(OpBuilder):
    NAME = "fused_adam"

    def load(self):
        from ..adam import fused_adam
        return fused_adam


class FusedLambBuilder(OpBuilder):
    NAME = "fused_lamb"

    def load(self):
        from ..lamb import fused_lamb
        return fused_lamb


class TransformerBuilder(OpBuilder):
    NAME = "transformer"

    def load(self):
        from ..transformer import transformer
        return transformer


class StochasticTransformerBuilder(TransformerBuilder):
    NAME = "stochastic_transformer"


class SparseAttnBuilder(OpBuilder):
    NAME = "sparse_attn"

    def load(self):
        from .. import sparse_attention
        return sparse_attention


class _FlattenUtils:
    """torch's flatten/unflatten_dense_tensors on tensor lists (reference
    `csrc/utils/flatten_unflatten.cpp`)."""

    @staticmethod
    def flatten(tensors):
        import torch
        if not tensors:
            return torch.zeros((0,), dtype=torch.float32)
        return torch.cat([t.reshape(-1) for t in tensors])

    @staticmethod
    def unflatten(flat, tensors):
        out, off = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[off:off + n].view_as(t))
            off += n
        return out


class UtilsBuilder(OpBuilder):
    NAME = "utils"

    def load(self):
        return _FlattenUtils()


_LIBRARY = {}


def _load_kernel_library():
    """The kernel library, built and loaded once a process; a failed
    attempt (no nvcc, a compile error) is remembered and re-raised."""
    if "error" in _LIBRARY:
        raise _LIBRARY["error"]
    if "lib" not in _LIBRARY:
        from ..hopper import _build
        try:
            _LIBRARY["lib"] = _build.load_library()
        except Exception as e:  # noqa: BLE001 - remembered for the report
            _LIBRARY["error"] = e
            raise
    return _LIBRARY["lib"]


class HopperKernelBuilder(OpBuilder):
    """One C entry point of the kernel library (`_build.SIGNATURES`)."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.NAME = symbol

    def sources(self):
        from ..hopper import _build
        return [str(p) for p in _build._sources()]

    def load(self):
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the Hopper kernels run on "
                               "an sm_90 card")
        cap = torch.cuda.get_device_capability()
        if tuple(cap) != KERNEL_CAPABILITY:
            raise RuntimeError(f"the kernels are built for sm_90a; this "
                               f"card is sm_{cap[0]}{cap[1]}")
        return getattr(_load_kernel_library(), self.symbol)


def _kernel_builders():
    from ..hopper._build import SIGNATURES
    return [HopperKernelBuilder(symbol) for symbol in SIGNATURES]


ALL_OPS = {
    b.NAME: b for b in (
        FusedAdamBuilder(), FusedLambBuilder(), TransformerBuilder(),
        StochasticTransformerBuilder(), SparseAttnBuilder(),
        UtilsBuilder(), *_kernel_builders())
}


def get_default_compute_capabilities():
    """The compute capabilities of the visible cards (the reference's
    list of archs to build for); [] without a card."""
    import torch
    if not torch.cuda.is_available():
        return []
    return sorted({"{}.{}".format(*torch.cuda.get_device_capability(i))
                   for i in range(torch.cuda.device_count())})
