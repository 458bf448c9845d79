"""Murmur3 x86 32-bit hash, used for doc routing (a copy of
``elasticsearch_tpu/utils/murmur3.py``, pure Python only).

The reference routes ``doc_id → shard`` with Murmur3 over the routing key
(``cluster/routing/OperationRouting.java:242-256``, backed by
``Murmur3HashFunction``). Implemented from the public MurmurHash3 spec
(Austin Appleby, public domain). ``shard_for`` hashes the routing key's
UTF-16LE code units with seed 0 and takes the signed floorMod — BIT-EXACT
with the reference, because shard-coupled features (scroll slicing,
shard-partition terms) assert specific doc→shard placements. Changing the
hash invalidates on-disk shard assignments of previously written indexes.
"""

from __future__ import annotations

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """Murmur3 x86 32-bit of ``data`` (pure Python; the reference also
    has a C++ build of the same hash)."""
    h = seed & _MASK
    n = len(data)
    rounded = n - (n % 4)
    for i in range(0, rounded, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & _MASK
    k = 0
    tail = data[rounded:]
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _MASK
        k = _rotl32(k, 15)
        k = (k * _C2) & _MASK
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def shard_for(routing: str, num_shards: int, routing_partition_size: int = 1,
              partition_offset: int = 0) -> int:
    """doc → shard, BIT-EXACT with the reference
    (``OperationRouting.generateShardId`` + ``Murmur3HashFunction``: the
    hash runs over the routing key's UTF-16LE code units and the shard is
    the signed floorMod — shard-coupled behaviors like scroll slicing
    depend on landing on the same shards)."""
    h = murmur3_32(routing.encode("utf-16-le"))
    if routing_partition_size > 1:
        h = (h + partition_offset) % (1 << 32)
    if h >= 1 << 31:
        h -= 1 << 32            # java int; python % IS floorMod
    return h % num_shards
