"""Transport factory (counterpart of `lumina_t2x_tpu/transport/__init__.py`)."""

from .cfg import cfg_interval_wrapper, cfg_wrapper
from .path import GVPPath, LinearPath, VPPath, expand_t_like_x
from .solvers import (make_time_grid, odeint_adaptive, odeint_dopri8, odeint_fixed, sdeint,
                      time_shift)
from .transport import (ModelType, PathType, Sampler, Transport, WeightType, mean_flat,
                        sample_t)

__all__ = [
    "create_transport", "Transport", "Sampler", "ModelType", "PathType", "WeightType",
    "sample_t", "mean_flat", "LinearPath", "GVPPath", "VPPath", "expand_t_like_x",
    "odeint_fixed", "odeint_adaptive", "odeint_dopri8", "sdeint", "make_time_grid",
    "time_shift", "cfg_wrapper", "cfg_interval_wrapper",
]


def create_transport(path_type="Linear", prediction="velocity", loss_weight=None,
                     train_eps=None, sample_eps=None, snr_type="uniform"):
    """Build a Transport with the reference's defaulting rules: VP ->
    (1e-5, 1e-3); GVP and Linear with a non-velocity model -> (1e-3, 1e-3);
    velocity on GVP or Linear -> 0."""
    model_type = {"noise": ModelType.NOISE, "score": ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY)
    loss_type = {"velocity": WeightType.VELOCITY, "likelihood": WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE)
    path_type = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}[path_type]

    if path_type == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    elif model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if sample_eps is None else sample_eps
    else:  # velocity on GVP / Linear is stable everywhere
        train_eps = 0
        sample_eps = 0

    return Transport(model_type=model_type, path_type=path_type, loss_type=loss_type,
                     train_eps=train_eps, sample_eps=sample_eps, snr_type=snr_type)
