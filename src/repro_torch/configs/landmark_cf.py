"""Arch config 'landmark_cf': the paper's hyperparameters and the
MovieLens-1M shapes, as plain constants (there is no LM registry here)."""
from ..core.types import LandmarkSpec

# the reproduced paper (Lima, Mello, Zimbrão 2017), §4.4
MODEL = LandmarkSpec(n_landmarks=20, selection="popularity", d1="cosine",
                     d2="cosine", k_neighbors=13)
SMOKE = LandmarkSpec(n_landmarks=8, selection="popularity")

# paper Table 1: MovieLens-1M users × items
ML1M_FIT = dict(n_users=6040, n_items=3952)
ML1M_PREDICT = dict(n_users=6040, n_items=3952, n_pairs=131072)
