"""KV block tiers below the device pool: G2 host DRAM and G3 disk (copy of
``dynamo_tpu.engine.kv_host_cache``).

G1 is the device pool's ``PageAllocator`` (``kv_cache.py``). A block it
evicts is offloaded here instead of dropped: the engine extracts it to the
host in the background, and a prefix hit on a spilled block onboards it
with an upload instead of recomputing its prefill.

Blocks are keyed by their chained block hash (``llm/tokens.py``), so a
block's content never changes under its key: the tiers need no
invalidation, only capacity eviction (LRU). An entry is the host parcel of
one page, [2, L, Nkv, page, D] bf16 bits (``kv_quant.BF16``), or for an
int8 pool the packed int8 + scales parcel [2, L, Nkv, page, D + 4] uint8
(``engine/kv_quant.py``), about half the bytes. A G3 file is
``{hash & (2**64 - 1):016x}.npy`` holding bf16 as uint16 or a packed
parcel as uint8, the reference's names and contents, so either package's
worker reopens the other's directory bit for bit.

The tiers are mutated by the engine thread and read by the KV plane's
connection threads serving peer G4 block fetches (``llm/kv_plane.py``
``block_provider``): one lock per tier covers its index and counters
(entries are immutable once stored, so only those need protecting).
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict

import numpy as np

from dynamo_tpu_torch.engine.kv_quant import BF16


class DiskKVCache:
    """G3: one file per block under a directory, LRU-evicted by
    capacity."""

    def __init__(self, directory: str, capacity_pages: int = 4096):
        self.dir = directory
        self.capacity = capacity_pages
        os.makedirs(directory, exist_ok=True)
        # hash -> path, in LRU order.
        self._index: OrderedDict[int, str] = OrderedDict()
        self._lock = threading.Lock()
        for name in sorted(os.listdir(directory)):
            if name.endswith(".npy"):
                try:
                    self._index[int(name[:-4], 16)] = os.path.join(directory,
                                                                   name)
                except ValueError:
                    continue
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.block_nbytes = 0  # last stored block's size (uniform per model)

    def __contains__(self, block_hash: int) -> bool:
        with self._lock:
            return block_hash in self._index

    def put(self, block_hash: int, kv: np.ndarray) -> None:
        with self._lock:
            if block_hash in self._index:
                self._index.move_to_end(block_hash)
                return
            self.puts += 1
            self.block_nbytes = kv.nbytes
        path = os.path.join(self.dir, f"{block_hash & (2**64 - 1):016x}.npy")
        # bf16 bits save as uint16, packed parcels as uint8.
        np.save(path, kv if kv.dtype == np.uint8 else kv.view(np.uint16))
        evicted: list[str] = []
        with self._lock:
            self._index[block_hash] = path
            while len(self._index) > self.capacity:
                _, old = self._index.popitem(last=False)
                evicted.append(old)
        for old in evicted:
            try:
                os.remove(old)
            except OSError:
                pass

    def get(self, block_hash: int) -> np.ndarray | None:
        with self._lock:
            path = self._index.get(block_hash)
            if path is None:
                self.misses += 1
                return None
        try:
            arr = np.load(path)
            if arr.dtype == np.uint16:  # bf16 stored as uint16
                arr = arr.view(BF16)
        except (OSError, ValueError):
            with self._lock:
                self._index.pop(block_hash, None)
                self.misses += 1
            return None
        with self._lock:
            if block_hash in self._index:
                self._index.move_to_end(block_hash)
            self.hits += 1
        return arr

    def hashes(self) -> list[int]:
        """Snapshot of the resident block hashes, LRU first."""
        with self._lock:
            return list(self._index)


class HostKVCache:
    """G2: a bounded host-DRAM block pool. What overflows its capacity
    cascades to the G3 disk tier when there is one."""

    def __init__(self, capacity_pages: int,
                 disk: DiskKVCache | None = None):
        self.capacity = capacity_pages
        self.disk = disk
        self._blocks: OrderedDict[int, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.spills_in = 0       # blocks offloaded into this tier
        self.demotions = 0       # G2 -> G3 capacity evictions
        self.block_nbytes = 0    # last stored block's size (uniform)

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def put(self, block_hash: int, kv: np.ndarray,
            promotion: bool = False) -> None:
        demoted: list[tuple[int, np.ndarray]] = []
        with self._lock:
            if block_hash in self._blocks:
                self._blocks.move_to_end(block_hash)
                return
            # Own the memory: a spilled block is a view into its flush's
            # page-locked extract buffer, which must not live as long as
            # the entry does.
            self._blocks[block_hash] = np.array(kv, copy=True)
            self.puts += 1
            self.block_nbytes = int(kv.nbytes)
            if not promotion:
                self.spills_in += 1
            while len(self._blocks) > self.capacity:
                demoted.append(self._blocks.popitem(last=False))
        if self.disk is not None:
            for old_hash, old_kv in demoted:
                self.disk.put(old_hash, old_kv)
                with self._lock:
                    self.demotions += 1

    def get(self, block_hash: int) -> np.ndarray | None:
        with self._lock:
            kv = self._blocks.get(block_hash)
            if kv is not None:
                self._blocks.move_to_end(block_hash)
                self.hits += 1
                return kv
        if self.disk is not None:
            kv = self.disk.get(block_hash)
            if kv is not None:
                # Promote back into DRAM (not an offload: spills_in stays).
                self.put(block_hash, kv, promotion=True)
                with self._lock:
                    self.hits += 1
                return kv
        with self._lock:
            self.misses += 1
        return None

    def clear(self) -> None:
        """Drop every tier (the admin clear_kv_blocks): G2's memory and
        the G3 files behind it."""
        with self._lock:
            self._blocks.clear()
        if self.disk is not None:
            with self.disk._lock:
                index, self.disk._index = dict(self.disk._index), \
                    OrderedDict()
            for path in index.values():
                try:
                    os.remove(path)
                except OSError:
                    pass

    def stats(self) -> dict:
        n_g2 = len(self._blocks)
        out = {"g2_blocks": n_g2, "g2_hits": self.hits,
               "g2_misses": self.misses, "g2_puts": self.puts,
               "g2_spills_in": self.spills_in,
               "g2_demotions": self.demotions,
               "g2_capacity": self.capacity,
               "g2_bytes": n_g2 * self.block_nbytes}
        if self.disk is not None:
            n_g3 = len(self.disk._index)
            out.update({"g3_blocks": n_g3,
                        "g3_hits": self.disk.hits,
                        "g3_misses": self.disk.misses,
                        "g3_puts": self.disk.puts,
                        "g3_capacity": self.disk.capacity,
                        "g3_bytes": n_g3 * self.disk.block_nbytes})
        return out

    def block_hashes(self, limit: int = 0) -> list[int]:
        """Snapshot of the resident G2 block hashes (inventory digests);
        ``limit`` > 0 caps the copy."""
        with self._lock:
            keys = list(self._blocks.keys())
        return keys[:limit] if limit else keys
