"""Architecture registry (mirrors ``repro/configs``): ``--arch <id>``
resolves here.

Every architecture id of the reference is listed, but only the token-only
ones are configs yet; `get_config` of the others raises and names what
they still need."""
from . import (gemma_7b, jamba_1_5_large_398b, llama4_maverick_400b,
               llama4_scout_17b, mamba2_2_7b, phi3_medium_14b, qwen1_5_110b,
               qwen1_5_4b)
from .shapes import LONG_CONTEXT_WINDOW, SHAPES, InputShape  # noqa

_MODULES = [qwen1_5_4b, mamba2_2_7b, qwen1_5_110b, jamba_1_5_large_398b,
            llama4_maverick_400b, llama4_scout_17b, gemma_7b,
            phi3_medium_14b]

ARCHS = {m.ARCH_ID: m.make_config for m in _MODULES}

# id -> what the port still lacks to run it
NOT_PORTED = {
    "phi-3-vision-4.2b": "the VLM patch projector",
    "whisper-small": "the encoder-decoder model",
}


def get_config(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it needs {NOT_PORTED[arch_id]}, "
            f"which comes with a later slice of the port")
    return ARCHS[arch_id]()


def list_archs():
    return sorted(set(ARCHS) | set(NOT_PORTED))
