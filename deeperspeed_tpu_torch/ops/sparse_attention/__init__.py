"""Block-sparse attention: sparsity patterns, the standalone block-sparse
MatMul and Softmax ops, and `SparseSelfAttention`, which routes a layout
to the block-sparse kernels, the layout-masked flash kernels or the
three-op path, and the BERT side: `BertSparseSelfAttention` and
`SparseAttentionUtils` (the port of `deeperspeed_tpu/ops/sparse_attention`)."""

from .bert_sparse_self_attention import BertSparseSelfAttention
from .matmul import MatMul, dense_to_sparse, sparse_to_dense
from .softmax import Softmax
from .sparse_self_attention import (SparseSelfAttention,
                                    dense_masked_attention,
                                    layout_to_token_mask)
from .sparsity_config import (BigBirdSparsityConfig,
                              BSLongformerSparsityConfig,
                              DenseSparsityConfig, FixedSparsityConfig,
                              LocalSlidingWindowSparsityConfig,
                              SparsityConfig, VariableSparsityConfig,
                              sparsity_config_from_dict)
from .sparse_attention_utils import SparseAttentionUtils
