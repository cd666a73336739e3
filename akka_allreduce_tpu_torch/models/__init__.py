"""Model code of the port (dense causal transformer LM, decoding, the
minimal MLP)."""

from akka_allreduce_tpu_torch.models.mlp import init_mlp, mlp_apply
from akka_allreduce_tpu_torch.models.transformer import (TransformerConfig,
                                                         init_transformer,
                                                         transformer_apply)

__all__ = [
    "init_mlp",
    "mlp_apply",
    "TransformerConfig",
    "init_transformer",
    "transformer_apply",
]
