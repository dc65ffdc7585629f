"""Architecture registry (mirrors ``repro/configs``): ``--arch <id>``
resolves here.

Every architecture id of the reference is listed, but only the ones whose
mixers the port has are configs yet; `get_config` of the others raises and
names what they still need."""
from . import mamba2_2_7b

ARCHS = {mamba2_2_7b.ARCH_ID: mamba2_2_7b.make_config}

# id -> what the port still lacks to run it
NOT_PORTED = {
    "qwen1.5-4b": "the attention mixer and the MLP",
    "qwen1.5-110b": "the attention mixer and the MLP",
    "gemma-7b": "the attention mixer and the MLP",
    "phi3-medium-14b": "the attention mixer and the MLP",
    "llama4-scout-17b-a16e": "the attention mixer and the MoE FFN",
    "llama4-maverick-400b-a17b": "the attention mixer, the MLP and the MoE FFN",
    "jamba-1.5-large-398b": "the attention mixer, the MLP and the MoE FFN",
    "phi-3-vision-4.2b": "the attention mixer, the MLP and the VLM patch "
                         "projector",
    "whisper-small": "the encoder-decoder model",
}


def get_config(arch_id: str):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: it needs {NOT_PORTED[arch_id]}, "
            f"which come with a later slice of the port")
    return ARCHS[arch_id]()


def list_archs():
    return sorted(set(ARCHS) | set(NOT_PORTED))
