"""Architecture registry (mirrors ``repro/configs``): ``--arch <id>``
resolves here, for every architecture id of the reference."""
from . import (gemma_7b, jamba_1_5_large_398b, llama4_maverick_400b,
               llama4_scout_17b, mamba2_2_7b, phi3_medium_14b,
               phi3_vision_4_2b, qwen1_5_110b, qwen1_5_4b, whisper_small)
from .shapes import LONG_CONTEXT_WINDOW, SHAPES, InputShape  # noqa

_MODULES = [qwen1_5_4b, mamba2_2_7b, qwen1_5_110b, jamba_1_5_large_398b,
            llama4_maverick_400b, llama4_scout_17b, phi3_vision_4_2b,
            gemma_7b, whisper_small, phi3_medium_14b]

ARCHS = {m.ARCH_ID: m.make_config for m in _MODULES}


def get_config(arch_id: str):
    return ARCHS[arch_id]()


def list_archs():
    return sorted(ARCHS)
