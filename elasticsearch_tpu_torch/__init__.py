"""PyTorch/CUDA port of the engine's batched serving planes (BM25, bool,
kNN, hybrid), its masked aggregation reductions, its per-segment search
path (mappings, segments, the query DSL's leaf and compound queries and
``ShardSearcher``) and its ML path (``xpack/ml.py``: trained-model
inference, the ``inference`` ingest processor, data frame analytics).

The JAX package ``elasticsearch_tpu`` is the reference; this package keeps
its module names (``ops/sorted_merge.py``, ``index/segment.py``,
``search/shard_search.py``, ...) so each function has an obvious
counterpart. It imports ``torch`` and numpy only. The per-document device
work runs in twenty-two hand-written CUDA kernels (twenty-one sources
under ``csrc/``, built at first use by ``kernels/build.py``); each kernel's
plain PyTorch version sits beside its wrapper and serves tensors that lie
on the CPU.
"""
