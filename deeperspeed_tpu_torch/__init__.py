"""DeeperSpeed on PyTorch and CUDA: the port of `deeperspeed_tpu` to an
NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference it is tested against. This slice serves GPT-NeoX: the
continuous-batching `InferenceEngine` over a paged KV cache, with
hand-written CUDA kernels for the flash prefill and the paged decode
(`ops/hopper`, sources in `csrc`). The port never imports JAX or
`deeperspeed_tpu`.
"""

from .inference import InferenceEngine
from .models.gpt_neox import GPTNeoX, GPTNeoXConfig
from .utils.logging import log_dist, logger
from .version import __version__

__all__ = ["InferenceEngine", "GPTNeoX", "GPTNeoXConfig", "log_dist",
           "logger", "__version__"]
