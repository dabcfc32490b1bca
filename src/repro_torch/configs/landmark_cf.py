"""Arch config 'landmark_cf': the paper's hyperparameters, the
reference registry's four CF shapes and the lifecycle's refresh
thresholds, as plain constants. ``configs/registry.py`` registers the
arch from ``MODEL``, ``SMOKE`` and ``SHAPES`` (this module imports no
registry, so the core and the lifecycle can read it on their own)."""
from ..core.types import LandmarkSpec
from ..lifecycle.policy import RefreshSpec
from .base import ShapeSpec

# the reproduced paper (Lima, Mello, Zimbrão 2017), §4.4
MODEL = LandmarkSpec(n_landmarks=20, selection="popularity", d1="cosine",
                     d2="cosine", k_neighbors=13)
SMOKE = LandmarkSpec(n_landmarks=8, selection="popularity")

# paper Table 1: MovieLens-1M users × items
ML1M_FIT = dict(n_users=6040, n_items=3952)
ML1M_PREDICT = dict(n_users=6040, n_items=3952, n_pairs=131072)
# the reference registry's other fit shapes: a Netflix 1M-rating cut, and
# the pod-scale cell at 1M users and 128 landmarks
NETFLIX1M_FIT = dict(n_users=8782, n_items=4577)
WEB_FIT = dict(n_users=1_048_576, n_items=65536, n_landmarks=128)
SHAPES = (
    ShapeSpec("ml1m_fit", "cf_fit", ML1M_FIT),
    ShapeSpec("netflix1m_fit", "cf_fit", NETFLIX1M_FIT),
    ShapeSpec("web_fit", "cf_fit", WEB_FIT,
              note="pod-scale cell: the |P|/n collective-payload reduction "
              "(DESIGN.md §3) at 1M users."),
    ShapeSpec("ml1m_predict", "cf_predict", ML1M_PREDICT),
)

# the continual-serving lifecycle: production drift/refresh thresholds, and
# a twitchy variant sized for the smoke replay (small reservoir, fires
# after two consecutive breaching evaluations) — the reference's values
REFRESH = RefreshSpec()
SMOKE_REFRESH = RefreshSpec(
    mae_ratio=1.15,  # holdout MAE on ~256 withheld ratings is noisy; the
    min_coverage_ratio=0.8,  # coverage drop is the reliable smoke signal
    max_foldin_frac=0.6,
    patience=2,
    cooldown_waves=1,
    min_holdout=16,
    reservoir=256,
    holdout_frac=0.25,
    max_skew=1.5,  # drifted arrivals pile onto few IVF cells within a
    rebalance_patience=1,  # wave or two — repack on the first breach
)
