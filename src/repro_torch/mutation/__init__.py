"""Write-path mutation — in-place updates, GDPR deletion, decremental
repair and compaction, on one device (:mod:`.mutate`) and on a mesh
(:mod:`.sharded`)."""
from .mutate import (MutableState, compact_tombstones, drain_repairs,
                     fold_in_mutable, fold_in_rows, from_bucketed,
                     from_fitted, predict_pairs, recommend_topn,
                     remove_users, repair, update_ratings)
from .sharded import (MutableStateSharded, compact_tombstones_sharded,
                      drain_repairs_sharded, fold_in_rows_sharded,
                      from_sharded, remove_users_sharded, repair_sharded,
                      update_ratings_sharded)

__all__ = [
    "MutableState", "from_bucketed", "from_fitted", "update_ratings",
    "remove_users", "repair", "drain_repairs", "compact_tombstones",
    "fold_in_rows", "fold_in_mutable", "predict_pairs", "recommend_topn",
    "MutableStateSharded", "from_sharded", "update_ratings_sharded",
    "remove_users_sharded", "repair_sharded", "drain_repairs_sharded",
    "compact_tombstones_sharded", "fold_in_rows_sharded",
]
