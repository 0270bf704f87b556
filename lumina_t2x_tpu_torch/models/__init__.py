"""Model registry (counterpart of `lumina_t2x_tpu/models/__init__.py`): the
NextDiT text-to-image and the class-conditional NextDiT-ImageNet entries."""

from .next_dit import (
    NextDiT,
    NextDiT_2B_GQA_patch2,
    NextDiT_2B_patch2,
    NextDiT_600M_patch2,
    NextDiT_Tiny_patch2,
)
from .next_dit_imagenet import (
    NextDiTImageNet,
    NextDiT_ImageNet_2B_patch2,
    NextDiT_ImageNet_3B_patch2,
    NextDiT_ImageNet_600M_patch2,
    NextDiT_ImageNet_7B_patch2,
    NextDiT_ImageNet_Small_patch2,
    NextDiT_ImageNet_Tiny_patch2,
)

MODELS = {
    "NextDiT_2B_patch2": NextDiT_2B_patch2,
    "NextDiT_2B_GQA_patch2": NextDiT_2B_GQA_patch2,
    "NextDiT_600M_patch2": NextDiT_600M_patch2,
    "NextDiT_Tiny_patch2": NextDiT_Tiny_patch2,  # debug/smoke only
    # class-conditional ImageNet
    "NextDiT_ImageNet_Tiny_patch2": NextDiT_ImageNet_Tiny_patch2,  # debug/smoke only
    "NextDiT_ImageNet_Small_patch2": NextDiT_ImageNet_Small_patch2,
    "NextDiT_ImageNet_600M_patch2": NextDiT_ImageNet_600M_patch2,
    "NextDiT_ImageNet_2B_patch2": NextDiT_ImageNet_2B_patch2,
    "NextDiT_ImageNet_3B_patch2": NextDiT_ImageNet_3B_patch2,
    "NextDiT_ImageNet_7B_patch2": NextDiT_ImageNet_7B_patch2,
}


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](**kwargs)


__all__ = ["MODELS", "get_model", "NextDiT", "NextDiTImageNet"]
