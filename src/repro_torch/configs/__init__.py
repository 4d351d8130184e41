"""Architecture registry: the ported architectures (the GQA decoders and
the DeepSeek MLA + MoE decoders).

The other assigned architectures (llava-next-34b, recurrentgemma-9b,
seamless-m4t-large-v2, xlstm-1.3b) wait for their modules (ROADMAP).
"""
from . import (chatglm3_6b, deepseek_v2_236b, deepseek_v3_671b, gemma2_27b,
               mistral_nemo_12b, qwen3_4b)
from .base import (ARCHS, SHAPES, ShapeCell, get_arch, register,
                   supported_shapes)

register("chatglm3-6b", chatglm3_6b)
register("mistral-nemo-12b", mistral_nemo_12b)
register("gemma2-27b", gemma2_27b)
register("qwen3-4b", qwen3_4b)
register("deepseek-v2-236b", deepseek_v2_236b)
register("deepseek-v3-671b", deepseek_v3_671b)

ALL_ARCHS = tuple(ARCHS.keys())

__all__ = ["ARCHS", "ALL_ARCHS", "SHAPES", "ShapeCell", "get_arch",
           "register", "supported_shapes"]
