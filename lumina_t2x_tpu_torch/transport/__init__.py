"""Transport factory (counterpart of `lumina_t2x_tpu/transport/__init__.py`)."""

from .path import LinearPath, expand_t_like_x
from .solvers import make_time_grid, odeint_fixed, time_shift
from .transport import (ModelType, PathType, Sampler, Transport, WeightType, mean_flat,
                        sample_t)

__all__ = [
    "create_transport", "Transport", "Sampler", "ModelType", "PathType", "WeightType",
    "sample_t", "mean_flat",
    "LinearPath", "expand_t_like_x", "odeint_fixed", "make_time_grid", "time_shift",
]


def create_transport(path_type="Linear", prediction="velocity", loss_weight=None,
                     train_eps=None, sample_eps=None, snr_type="uniform"):
    """Build a Transport with the reference's defaulting rules for the
    linear path: non-velocity -> (1e-3, 1e-3); velocity -> 0. The GVP and VP
    paths raise `NotImplementedError` (not ported yet)."""
    model_type = {"noise": ModelType.NOISE, "score": ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY)
    loss_type = {"velocity": WeightType.VELOCITY, "likelihood": WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE)
    path_type = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}[path_type]

    if model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:
        train_eps = 0
        sample_eps = 0

    return Transport(model_type=model_type, path_type=path_type, loss_type=loss_type,
                     train_eps=train_eps, sample_eps=sample_eps, snr_type=snr_type)
