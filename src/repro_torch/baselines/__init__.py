"""CF baselines the paper compares against (memory- and model-based)."""
from ..core.landmark_cf import fit_baseline  # memory-based full-matrix kNN
from .mf import (
    MFConfig,
    MFParams,
    fit_mf,
    irsvd_config,
    pmf_config,
    predict_mf,
    rsvd_config,
    svdpp_config,
)
from .bpmf import BPMFConfig, fit_predict_bpmf

__all__ = [
    "fit_baseline",
    "MFConfig",
    "MFParams",
    "fit_mf",
    "predict_mf",
    "rsvd_config",
    "irsvd_config",
    "pmf_config",
    "svdpp_config",
    "BPMFConfig",
    "fit_predict_bpmf",
]
