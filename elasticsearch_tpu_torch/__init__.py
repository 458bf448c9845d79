"""PyTorch/CUDA port of the engine's batched serving planes (BM25, bool,
kNN, hybrid) and its masked aggregation reductions.

The JAX package ``elasticsearch_tpu`` is the reference; this package keeps
its module names (``ops/sorted_merge.py``, ``ops/tiered_bm25.py``,
``parallel/dist_search.py``, ...) so each function has an obvious
counterpart. It imports ``torch`` and numpy only. The per-document device
work runs in fifteen hand-written CUDA kernels (fourteen sources under
``csrc/``, built at first use by ``kernels/build.py``); each kernel's
plain PyTorch version sits beside its wrapper and serves tensors that lie
on the CPU.
"""
