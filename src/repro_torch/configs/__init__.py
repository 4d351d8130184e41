"""Architecture registry: the ported architectures (dense GQA decoders).

The other assigned architectures (chatglm3-6b, deepseek-v2-236b,
deepseek-v3-671b, llava-next-34b, recurrentgemma-9b,
seamless-m4t-large-v2, xlstm-1.3b) wait for their modules (ROADMAP).
"""
from . import gemma2_27b, mistral_nemo_12b, qwen3_4b
from .base import (ARCHS, SHAPES, ShapeCell, get_arch, register,
                   supported_shapes)

register("mistral-nemo-12b", mistral_nemo_12b)
register("gemma2-27b", gemma2_27b)
register("qwen3-4b", qwen3_4b)

ALL_ARCHS = tuple(ARCHS.keys())

__all__ = ["ARCHS", "ALL_ARCHS", "SHAPES", "ShapeCell", "get_arch",
           "register", "supported_shapes"]
