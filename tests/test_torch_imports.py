"""The PyTorch port stands alone: no JAX, explicit device, no silent host
fallback for CUDA tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "elasticsearch_tpu_torch"
BANNED = ("jax", "jaxlib", "elasticsearch_tpu")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import_anywhere_in_the_port(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _banned(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _guarded_imports(tree):
    """Imports inside a ``try`` whose handler catches their failure (an
    optional module with a fallback path)."""
    catches = {"Exception", "BaseException", "ImportError",
               "ModuleNotFoundError"}
    out = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        names = set()
        for h in node.handlers:
            types = h.type.elts if isinstance(h.type, ast.Tuple) else \
                [h.type]
            names |= {getattr(t, "id", None) for t in types}
        if None in names or names & catches:
            for stmt in node.body:
                out |= {id(n) for n in ast.walk(stmt)
                        if isinstance(n, ast.ImportFrom)}
    return out


def _resolves(pkg_dir: Path, parts) -> bool:
    target = pkg_dir.joinpath(*parts)
    return target.with_suffix(".py").is_file() or \
        (target / "__init__.py").is_file()


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_relative_imports_resolve_inside_the_port(path):
    """Every relative import names a module file of the port (a copied
    module that imports a reference module the port lacks fails here,
    even when no test reaches the import), unless a ``try`` around it
    catches the failure."""
    tree = ast.parse(path.read_text(), filename=str(path))
    guarded = _guarded_imports(tree)
    pkg = path.parent
    for node in ast.walk(tree):
        if not isinstance(node, ast.ImportFrom) or node.level == 0 \
                or id(node) in guarded:
            continue
        base = pkg
        for _ in range(node.level - 1):
            base = base.parent
        assert base == PORT or PORT in base.parents, \
            f"{path}:{node.lineno} imports beyond the package"
        parts = node.module.split(".") if node.module else []
        if parts:
            assert _resolves(base, parts), \
                f"{path}:{node.lineno} imports {'.' * node.level}" \
                f"{node.module}, which the port does not have"
        else:
            for a in node.names:
                assert _resolves(base, [a.name]) or \
                    (base / "__init__.py").is_file(), \
                    f"{path}:{node.lineno} imports {a.name}"


def test_port_runs_with_jax_blocked():
    code = f"""
import sys
for name in {BANNED!r}:
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np
import elasticsearch_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from elasticsearch_tpu_torch.parallel.dist_search import DistributedSearchPlane
from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
c = synthetic_csr_corpus_fast(np.random.RandomState(0), 2048, 128, 8)
c["term_ids"] = {{f"t{{t}}": t for t in range(128)}}
p = DistributedSearchPlane([c], "body", device="cpu", dense_threshold=100)
vals, hits, totals = p.search([["t0", "t5"], ["t40"]], k=5, with_totals=True)
assert len(hits[0]) == 5 and totals[0] > 0, (hits, totals)
assert not any(n.startswith("jax") for n in sys.modules if sys.modules[n])
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_segment_path_runs_with_jax_blocked():
    """The per-segment path (mapping, segment, query DSL, shard search)
    with JAX and the reference blocked; the mapping's lazy geometry import
    resolves to the port's own copy."""
    code = f"""
import sys
for name in {BANNED!r}:
    sys.modules[name] = None
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import SegmentBuilder
from elasticsearch_tpu_torch.search.shard_search import ShardSearcher
svc = MapperService({{"properties": {{"body": {{"type": "text"}},
                                      "area": {{"type": "geo_shape"}}}}}})
b = SegmentBuilder("_0")
b.add(svc.parse_document("1", {{"body": "hello world", "area": {{
    "type": "point", "coordinates": [1.0, 2.0]}}}}), seq_no=0)
b.add(svc.parse_document("2", {{"body": "goodbye"}}), seq_no=1)
r = ShardSearcher([b.build(device="cpu")], svc, device="cpu").search(
    {{"query": {{"match": {{"body": "hello"}}}}}})
assert r.total == 1 and r.hits[0].doc_id == "1", r
assert "elasticsearch_tpu_torch.search.geometry" in sys.modules
assert not any(n.startswith("jax") for n in sys.modules if sys.modules[n])
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def _tiny_shards():
    from elasticsearch_tpu_torch.utils.synth import synthetic_csr_corpus_fast
    c = synthetic_csr_corpus_fast(np.random.RandomState(1), 512, 64, 8)
    c["term_ids"] = {f"t{t}": t for t in range(64)}
    return [c]


def test_plane_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from elasticsearch_tpu_torch.device import resolve_device
    from elasticsearch_tpu_torch.parallel.dist_search import \
        DistributedSearchPlane
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistributedSearchPlane(_tiny_shards(), "body")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    plane = DistributedSearchPlane(_tiny_shards(), "body", device="cpu")
    assert plane.docs_dev.device.type == "cpu"
    with pytest.raises(RuntimeError):
        resolve_device(None)                 # None means the card
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    from elasticsearch_tpu_torch.kernels import build as kb
    from elasticsearch_tpu_torch.ops.fused_query import (
        bool_bm25_topk, fuse_rank, rescore_reorder)
    from elasticsearch_tpu_torch.ops.sorted_merge import \
        sparse_candidates_topk
    from elasticsearch_tpu_torch.ops.tiered_bm25 import dense_stream_topk
    from elasticsearch_tpu_torch.ops.topk import topk_merge
    meta = torch.device("meta")
    before = dict(kb.launches)
    with pytest.raises(ValueError):
        topk_merge(torch.empty(2, 4, device=meta),
                   torch.empty(2, 4, dtype=torch.int32, device=meta),
                   k=2, fill_id=8)
    with pytest.raises(ValueError):
        sparse_candidates_topk(
            torch.empty(1, 64, dtype=torch.int32, device=meta),
            torch.empty(1, 64, device=meta),
            torch.empty(2, 1, 3, dtype=torch.int32, device=meta),
            torch.empty(2, 1, 3, dtype=torch.int32, device=meta),
            torch.empty(2, 3, device=meta), n_pad=64, L=8, k=4)
    with pytest.raises(ValueError):
        dense_stream_topk(torch.empty(2, 1, 16, device=meta),
                          torch.empty(1, 1, 16, 64, dtype=torch.bfloat16,
                                      device=meta), k=4)
    i3 = torch.empty(2, 1, 3, dtype=torch.int32, device=meta)
    i1 = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        bool_bm25_topk(
            torch.empty(1, 64, dtype=torch.int32, device=meta),
            torch.empty(1, 64, device=meta), i3, i3,
            torch.empty(2, 3, device=meta),
            torch.empty(2, 3, dtype=torch.int32, device=meta), i1, i1, i1,
            i1, n_pad=64, L=8, k=4)
    v = torch.empty(2, 4, device=meta)
    i = torch.empty(2, 4, dtype=torch.int32, device=meta)
    f1 = torch.empty(2, device=meta)
    with pytest.raises(ValueError):
        fuse_rank(v, i, v, i, i1, i1, f1, f1, n_pad_t=8, n_pad_k=8, UP=8,
                  pad_id=16, fusion="rrf", similarity="cosine", k=4)
    with pytest.raises(ValueError):
        rescore_reorder(v, i, v, torch.empty(2, 4, dtype=torch.bool,
                                             device=meta), f1, f1, i1,
                        mode="total", k=4, pad_id=16)
    assert kb.launches == before


def test_kernel_build_needs_nvcc(monkeypatch):
    from elasticsearch_tpu_torch.kernels import build as kb
    monkeypatch.setattr(kb.shutil, "which", lambda name: None)
    monkeypatch.setattr(kb.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kb._nvcc()
    # the library name follows the sources and the flags
    a = kb._lib_path("topk_merge")
    monkeypatch.setattr(kb, "NVCC_FLAGS", kb.NVCC_FLAGS + ["-lineinfo"])
    assert kb._lib_path("topk_merge") != a
    assert a.parent == kb.BUILD_DIR
    assert set(kb.KERNELS) == {p.stem for p in kb.CSRC_DIR.glob("*.cu")}
