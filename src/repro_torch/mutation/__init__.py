"""Write-path mutation on one device — in-place updates, GDPR deletion,
decremental repair and compaction (:mod:`.mutate`). The mesh variant comes
with the multi-GPU slice."""
from .mutate import (MutableState, compact_tombstones, drain_repairs,
                     fold_in_mutable, fold_in_rows, from_bucketed,
                     from_fitted, predict_pairs, recommend_topn,
                     remove_users, repair, update_ratings)

__all__ = [
    "MutableState", "from_bucketed", "from_fitted", "update_ratings",
    "remove_users", "repair", "drain_repairs", "compact_tombstones",
    "fold_in_rows", "fold_in_mutable", "predict_pairs", "recommend_topn",
]
