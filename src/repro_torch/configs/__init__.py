"""Architecture registry. One module per architecture; importing them
registers (full, smoke) config pairs. The port holds every arch of the JAX
package's zoo: the dense models ``gemma2-2b``, ``deepseek-7b``,
``granite-20b`` and ``minitron-8b``, the MoE models ``olmoe-1b-7b`` and
``deepseek-v3-671b``, the xLSTM model ``xlstm-1.3b``, the Mamba2 hybrid
``zamba2-2.7b``, the audio encoder ``hubert-xlarge`` and the VLM
``paligemma-3b``."""

from .base import (
    ATTN_IMPL_FROM_JAX,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    list_archs,
    register,
    torch_dtype,
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        deepseek_7b,
        deepseek_v3_671b,
        gemma2_2b,
        granite_20b,
        hubert_xlarge,
        minitron_8b,
        olmoe_1b_7b,
        paligemma_3b,
        xlstm_1_3b,
        zamba2_2_7b,
    )


__all__ = [
    "ATTN_IMPL_FROM_JAX",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "list_archs",
    "register",
    "torch_dtype",
]
