"""Quality metrics (counterpart of `lumina_t2x_tpu/eval`): FID, IS and
precision/recall over features (`fid.py`) and the FID InceptionV3
(`inception.py`)."""

from .fid import (compute_statistics, fid_from_feature_batches, frechet_distance,
                  inception_score, load_adm_npz, precision_recall)
from .inception import InceptionV3, load_fid_inception, random_fid_state_dict

__all__ = [
    "compute_statistics", "frechet_distance", "fid_from_feature_batches",
    "inception_score", "precision_recall", "load_adm_npz",
    "InceptionV3", "load_fid_inception", "random_fid_state_dict",
]
