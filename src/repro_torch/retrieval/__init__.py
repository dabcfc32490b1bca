"""IVF retrieval over the landmark embedding: a k-means coarse quantizer
(``kmeans``), an inverted-file index with fused probe search (``index``),
its mesh form (``sharded``), and the sidecar's metrics series
(``observe``)."""
from .index import (
    IVFIndex,
    IVFSpec,
    PAYLOAD_DTYPES,
    SCORERS,
    append,
    build_index,
    dequantize_payload,
    ensure_index_capacity,
    grow_capacity,
    place_plan,
    probe_cells,
    purge,
    quantize_payload,
    recall_at_k,
    resolve_ivf,
    resolve_scorer,
    score_recall_at_k,
    search,
    search_early_exit,
)
from .kmeans import (ASSIGN_BACKENDS, assign_clusters, init_centroids, kmeans,
                     resolve_assign_backend)
from .observe import publish_retrieval
from .sharded import (ShardedIVFIndex, append_sharded, build_index_sharded,
                      ensure_index_capacity_sharded, resolve_ivf_sharded,
                      search_early_exit_sharded, search_sharded, shard_index)

__all__ = [
    "IVFIndex", "IVFSpec", "PAYLOAD_DTYPES", "SCORERS", "ASSIGN_BACKENDS",
    "append", "assign_clusters", "build_index", "dequantize_payload",
    "ensure_index_capacity", "grow_capacity", "init_centroids", "kmeans",
    "place_plan", "probe_cells", "publish_retrieval", "purge",
    "quantize_payload",
    "recall_at_k",
    "resolve_assign_backend", "resolve_ivf", "resolve_scorer",
    "score_recall_at_k", "search",
    "search_early_exit", "ShardedIVFIndex", "append_sharded",
    "build_index_sharded", "ensure_index_capacity_sharded",
    "resolve_ivf_sharded", "search_early_exit_sharded", "search_sharded",
    "shard_index",
]
