"""MurmurHash3 (x86_32) feature hashing.

Reference: vw/VowpalWabbitMurmurWithPrefix.scala (77 LoC) — VW's murmur32
with a cached namespace-prefix state; features/*.scala hash `namespace^feature`
strings into a 2^num_bits weight table.

Host-side (strings never touch the device); the hashed (indices, values)
pairs are what feed the learners (and the GBDT's CSR path).  A copy of
the JAX package's `online/hashing.py`.
"""
from __future__ import annotations

__all__ = ["murmurhash3_32", "hash_feature", "FeatureHasher"]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def murmurhash3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3_x86_32, byte-exact with VW/scikit implementations."""
    h = seed & _M
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k = int.from_bytes(data[4 * i: 4 * i + 4], "little")
        k = (k * _C1) & _M
        k = _rotl(k, 15)
        k = (k * _C2) & _M
        h ^= k
        h = _rotl(h, 13)
        h = (h * 5 + 0xE6546B64) & _M
    tail = data[nblocks * 4:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * _C1) & _M
        k = _rotl(k, 15)
        k = (k * _C2) & _M
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    h ^= h >> 16
    return h


def hash_feature(name: str, namespace_seed: int, mask: int) -> int:
    return murmurhash3_32(name.encode("utf-8"), namespace_seed) & mask


class FeatureHasher:
    """Per-namespace hasher with memoized string hashes (the reference caches
    the murmur state of the namespace prefix; we cache full feature hashes —
    same asymptotics, simpler)."""

    def __init__(self, num_bits: int = 18, seed: int = 0):
        self.num_bits = int(num_bits)
        self.mask = (1 << self.num_bits) - 1
        self.seed = int(seed)
        self._cache: dict = {}

    def namespace_seed(self, namespace: str) -> int:
        key = ("\x00ns", namespace)
        if key not in self._cache:
            self._cache[key] = murmurhash3_32(namespace.encode("utf-8"), self.seed)
        return self._cache[key]

    def __call__(self, namespace: str, feature: str) -> int:
        key = (namespace, feature)
        if key not in self._cache:
            self._cache[key] = hash_feature(
                feature, self.namespace_seed(namespace), self.mask
            )
        return self._cache[key]
