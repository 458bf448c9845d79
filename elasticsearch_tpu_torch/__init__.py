"""PyTorch/CUDA port of the engine's batched serving planes (BM25, bool,
kNN, hybrid), its masked aggregation reductions and its per-segment search
path (mappings, segments, the query DSL's leaf and compound queries and
``ShardSearcher``).

The JAX package ``elasticsearch_tpu`` is the reference; this package keeps
its module names (``ops/sorted_merge.py``, ``index/segment.py``,
``search/shard_search.py``, ...) so each function has an obvious
counterpart. It imports ``torch`` and numpy only. The per-document device
work runs in nineteen hand-written CUDA kernels (eighteen sources under
``csrc/``, built at first use by ``kernels/build.py``); each kernel's
plain PyTorch version sits beside its wrapper and serves tensors that lie
on the CPU.
"""
