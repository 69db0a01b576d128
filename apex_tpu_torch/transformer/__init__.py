"""Transformer building blocks of the PyTorch port — counterpart of
``apex_tpu.transformer``, module for module: the megatron softmax family
(CUDA kernels), RoPE, fused dense layers, the MLP, the wgrad GEMM, the
chunked linear + cross-entropy head and the multi-head attention
modules."""

from apex_tpu_torch.transformer.softmax import (  # noqa: F401
    generic_scaled_masked_softmax,
    get_batch_per_block,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
)
from apex_tpu_torch.transformer.rope import (  # noqa: F401
    fused_rope,
    fused_rope_2d,
    fused_rope_cached,
    fused_rope_thd,
)
from apex_tpu_torch.transformer.fused_dense import (  # noqa: F401
    FusedDense,
    FusedDenseGeluDense,
    dense_gelu_dense,
    linear_bias,
)
from apex_tpu_torch.transformer.linear_cross_entropy import (  # noqa: F401
    linear_cross_entropy,
)
from apex_tpu_torch.transformer.mlp import MLP, mlp_forward  # noqa: F401
from apex_tpu_torch.transformer.wgrad import (  # noqa: F401
    wgrad_gemm_accum_fp16,
    wgrad_gemm_accum_fp32,
)
from apex_tpu_torch.transformer.mha import (  # noqa: F401
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
    mha_reference,
)
