"""Architecture configs: the 10 assigned archs + the paper's Mixtral set.

Importing this package registers every config with the model registry.
"""

from repro_torch.configs import (dbrx_132b, llama3_2_3b, llama3_2_vision_90b,
                                 mamba2_2_7b, mixtral_paper, qwen3_32b,
                                 qwen3_moe_30b_a3b, recurrentgemma_9b,
                                 starcoder2_15b, whisper_tiny, yi_34b)
from repro_torch.configs.inputs import input_specs, make_batch

ASSIGNED = [
    "mamba2-2.7b", "yi-34b", "llama3.2-3b", "starcoder2-15b", "qwen3-32b",
    "recurrentgemma-9b", "whisper-tiny", "llama-3.2-vision-90b",
    "dbrx-132b", "qwen3-moe-30b-a3b",
]

PAPER_MODELS = ["mixtral-w1", "mixtral-w2", "mixtral-d1", "mixtral-d2",
                "mixtral-d3"]

__all__ = ["ASSIGNED", "PAPER_MODELS", "input_specs", "make_batch"]
