"""Model registry (counterpart of `lumina_t2x_tpu/models/__init__.py`): the
NextDiT text-to-image, class-conditional NextDiT-ImageNet, Flag-DiT,
Next-DiT-MoE, region-controlled compositional, FlagDiT-1D (audio and music)
and SD3 MMDiT entries."""

from .compositional import NextDiTCompositional, NextDiT_2B_patch2_Compositional
from .flag_dit_1d import FlagDiT1D
from .flag_dit import (
    FlagDiT,
    FlagDiT_5B_patch2,
    FlagDiT_ImageNet_3B_patch2,
    FlagDiT_ImageNet_600M_patch2,
    FlagDiT_ImageNet_7B_patch2,
)
from .mmdit import MMDiT, MMDiT_SD3_Medium
from .moe import (
    NextDiTMoE,
    NextDiT_MoE_600M_patch2_Both,
    NextDiT_MoE_600M_patch2_Spatial,
    NextDiT_MoE_600M_patch2_Time,
)
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
    "DiT_Llama_5B_patch2": FlagDiT_5B_patch2,
    # class-conditional ImageNet
    "NextDiT_ImageNet_Tiny_patch2": NextDiT_ImageNet_Tiny_patch2,  # debug/smoke only
    "NextDiT_ImageNet_Small_patch2": NextDiT_ImageNet_Small_patch2,
    "NextDiT_ImageNet_600M_patch2": NextDiT_ImageNet_600M_patch2,
    "NextDiT_ImageNet_2B_patch2": NextDiT_ImageNet_2B_patch2,
    "NextDiT_ImageNet_3B_patch2": NextDiT_ImageNet_3B_patch2,
    "NextDiT_ImageNet_7B_patch2": NextDiT_ImageNet_7B_patch2,
    "FlagDiT_ImageNet_600M_patch2": FlagDiT_ImageNet_600M_patch2,
    "FlagDiT_ImageNet_3B_patch2": FlagDiT_ImageNet_3B_patch2,
    "FlagDiT_ImageNet_7B_patch2": FlagDiT_ImageNet_7B_patch2,
    # MoE (Next-DiT-MoE family), class-conditional
    "NextDiT_MoE_600M_patch2_Time": NextDiT_MoE_600M_patch2_Time,
    "NextDiT_MoE_600M_patch2_Spatial": NextDiT_MoE_600M_patch2_Spatial,
    "NextDiT_MoE_600M_patch2_Both": NextDiT_MoE_600M_patch2_Both,
    # region-controlled compositional generation
    "NextDiT_2B_patch2_Compositional": NextDiT_2B_patch2_Compositional,
    # 1-D temporal denoisers (audio and music)
    "FlagDiT1D_audio": lambda **kw: FlagDiT1D(**{**dict(in_channels=20, context_dim=1024), **kw}),
    "FlagDiT1D_music": lambda **kw: FlagDiT1D(**{**dict(in_channels=20, context_dim=1024), **kw}),
    # SD3 (MMDiT), the SD3 sampler and DreamBooth
    "MMDiT_SD3_Medium": MMDiT_SD3_Medium,
}


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(f"Unknown model {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](**kwargs)


def is_class_cond(name: str) -> bool:
    """A class-conditional registry name: the ImageNet and MoE families."""
    return "ImageNet" in name or "MoE" in name


def default_cap_feat_dim(name: str) -> int:
    """The caption width of a text-to-image registry name when neither the
    caller nor a checkpoint gives one: LLaMA-2-7B's 4096 for the Flag-DiT
    5B, Gemma-2B's 2048 for the others."""
    return 4096 if name == "DiT_Llama_5B_patch2" else 2048


__all__ = ["MODELS", "get_model", "is_class_cond", "default_cap_feat_dim", "FlagDiT", "FlagDiT1D", "MMDiT", "NextDiT", "NextDiTCompositional",
           "NextDiTImageNet", "NextDiTMoE"]
