from .attention import attention, default_attn_scale, proportional_attn_scale, sdpa
from .norms import layer_norm, rms_norm
from .rope import apply_rope, rope_angles_1d, rope_angles_2d, rope_angles_2d_timeaware

__all__ = [
    "attention", "sdpa", "default_attn_scale", "proportional_attn_scale",
    "rms_norm", "layer_norm",
    "apply_rope", "rope_angles_1d", "rope_angles_2d", "rope_angles_2d_timeaware",
]
