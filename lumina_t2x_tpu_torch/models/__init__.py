"""Model registry (counterpart of `lumina_t2x_tpu/models/__init__.py`): the
NextDiT text-to-image entries."""

from .next_dit import (
    NextDiT,
    NextDiT_2B_GQA_patch2,
    NextDiT_2B_patch2,
    NextDiT_600M_patch2,
    NextDiT_Tiny_patch2,
)

MODELS = {
    "NextDiT_2B_patch2": NextDiT_2B_patch2,
    "NextDiT_2B_GQA_patch2": NextDiT_2B_GQA_patch2,
    "NextDiT_600M_patch2": NextDiT_600M_patch2,
    "NextDiT_Tiny_patch2": NextDiT_Tiny_patch2,  # debug/smoke only
}


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](**kwargs)


__all__ = ["MODELS", "get_model", "NextDiT"]
