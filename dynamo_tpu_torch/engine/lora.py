"""Multi-tenant LoRA adapter store (counterpart of
``dynamo_tpu.engine.lora``): batched heterogeneous adapters on one base
model, the S-LoRA / Punica technique.

The runner holds one pair of stacks per target projection, ``A [L, S,
d_in, r]`` and ``B [L, S, r, d_out]`` with ``S = max_adapters + 1`` slots
(slot 0 is the base model: all zeros, no delta) and every adapter's rank
padded to ``lora_max_rank``, so every program adds the gathered low-rank
correction with fixed shapes: heterogeneous adapters batch into one decode
window and the programs stay the same whatever the tenant mix (adapter ids
are data, not part of a program key).

This module owns the placement over those slots: host copies of every
registered adapter are kept (a rank-8 adapter of an 8B model is tens of
MB), the device slots are the constrained resource, and ``acquire``
hot-loads on a miss with LRU eviction over slots no live request holds.
``pin`` exempts an adapter from eviction. Device work happens on the
engine thread (``acquire`` and ``release`` are called from admission and
finish); ``register`` is host work and safe from any thread, except that
re-registering a resident adapter rewrites its slot at once (live
reload).
"""

from __future__ import annotations

import collections
import threading

import torch

from dynamo_tpu_torch.engine.weights import _to_tensor
from dynamo_tpu_torch.runtime.errors import (AdapterNotFoundError,
                                             OverloadedError)
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("lora")


def _host_bf16(x) -> torch.Tensor:
    """A host weight as a bf16 CPU tensor: a torch tensor as it is (cast),
    a numpy array (bf16 bits or any float) converted."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.bfloat16)
    return _to_tensor(x, "cpu")


class AdapterStore:
    def __init__(self, runner, max_adapters: int, max_rank: int):
        if max_adapters < 1:
            raise ValueError(f"max_adapters must be >= 1, got {max_adapters}")
        self.runner = runner
        self.max_adapters = max_adapters
        self.max_rank = max_rank
        # (d_in, d_out) per target projection; registration checks host
        # weights against these.
        self.target_shapes = runner.config.lora_target_shapes()
        self.num_layers = runner.spec.num_layers
        self._lock = threading.Lock()
        #: name -> {"weights": {key: (A, B)}, "rank": int, "path": str|None}
        self._registry: dict[str, dict] = {}
        #: device slot s (1-based) serves self._slots[s - 1].
        self._slots: list[str | None] = [None] * max_adapters
        self._slot_of: dict[str, int] = {}
        self._refs: dict[str, int] = collections.defaultdict(int)
        self._pinned: set[str] = set()
        self._lru_clock = 0
        self._last_used: dict[str, int] = {}
        # Plain-int telemetry, read by status().
        self.loads_total = 0
        self.evictions_total = 0
        self.miss_total = 0
        self.requests_total: collections.Counter = collections.Counter()

    # -- host-side registry ---------------------------------------------------
    def register(self, name: str, path: str | None = None,
                 weights: dict | None = None) -> None:
        """Register an adapter by HF PEFT checkpoint directory or by a
        loaded ``{key: (A [L, d_in, r], B [L, r, d_out])}`` host tree
        (torch tensors or numpy arrays). Host work only: the upload waits
        for the first ``acquire`` (the hot-load)."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        if weights is None:
            if path is None:
                raise ValueError("register needs a path or weights")
            from dynamo_tpu_torch.engine.weights import load_lora_weights
            weights = load_lora_weights(self.runner.spec, path,
                                        self.max_rank)
        weights = {k: (_host_bf16(a), _host_bf16(b))
                   for k, (a, b) in weights.items()}
        rank = 0
        for key, (a, b) in weights.items():
            shape = self.target_shapes.get(key)
            if shape is None:
                raise ValueError(
                    f"adapter {name!r}: {key} is not a LoRA target for "
                    f"this model (targets: {sorted(self.target_shapes)})")
            d_in, d_out = shape
            want_a = (self.num_layers, d_in, self.max_rank)
            want_b = (self.num_layers, self.max_rank, d_out)
            if tuple(a.shape) != want_a or tuple(b.shape) != want_b:
                raise ValueError(
                    f"adapter {name!r}: {key} shapes {tuple(a.shape)}/"
                    f"{tuple(b.shape)} != expected {want_a}/{want_b}")
            # Effective rank: trailing all-zero columns are padding.
            nz = torch.nonzero(a.float().abs().sum(dim=(0, 1))).flatten()
            rank = max(rank, int(nz[-1]) + 1 if len(nz) else 0)
        with self._lock:
            replacing = name in self._registry
            self._registry[name] = {"weights": weights, "rank": rank,
                                    "path": path}
            if replacing and name in self._slot_of:
                # Live reload: the resident copy is stale; rewrite it in
                # place so in-flight acquires keep their slot id.
                self._upload_locked(name, self._slot_of[name])
        log.info("adapter %r registered (rank %d%s)%s", name, rank,
                 f", {path}" if path else "",
                 " [live-reloaded]" if replacing else "")

    def registered(self, name: str) -> bool:
        with self._lock:
            return name in self._registry

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._registry)

    # -- device-slot placement (ENGINE THREAD) --------------------------------
    def _full_weights(self, name: str) -> dict:
        """The whole per-target host set of an upload: projections the
        checkpoint does not cover get zeros, so a slot overwrite never
        leaves a previous tenant's deltas behind."""
        entry = self._registry[name]
        out = {}
        for key, (d_in, d_out) in self.target_shapes.items():
            pair = entry["weights"].get(key)
            if pair is None:
                pair = (torch.zeros((self.num_layers, d_in, self.max_rank),
                                    dtype=torch.bfloat16),
                        torch.zeros((self.num_layers, self.max_rank, d_out),
                                    dtype=torch.bfloat16))
            out[key] = pair
        return out

    def _upload_locked(self, name: str, slot: int) -> None:
        self.runner.set_adapter_slot(slot, self._full_weights(name))
        self.loads_total += 1

    def acquire(self, name: str) -> int:
        """Resolve an adapter name to its device slot, hot-loading on a
        miss (LRU eviction over unpinned slots no live request holds).
        Raises AdapterNotFoundError (unknown name: the front's 404) or
        OverloadedError (every slot held: retry later or elsewhere).
        Pairs with ``release``."""
        with self._lock:
            if name not in self._registry:
                raise AdapterNotFoundError(
                    f"adapter {name!r} is not registered on this worker "
                    f"(serving: {sorted(self._registry) or 'none'})")
            self.requests_total[name] += 1
            self._lru_clock += 1
            self._last_used[name] = self._lru_clock
            slot = self._slot_of.get(name)
            if slot is None:
                slot = self._place_locked(name)
            self._refs[name] += 1
            return slot

    def _place_locked(self, name: str) -> int:
        self.miss_total += 1
        free = next((i for i, n in enumerate(self._slots) if n is None),
                    None)
        if free is None:
            victims = [n for n in self._slots
                       if n is not None and not self._refs[n]
                       and n not in self._pinned]
            if not victims:
                raise OverloadedError(
                    f"all {self.max_adapters} adapter slots are held by "
                    f"live or pinned adapters; cannot hot-load "
                    f"{name!r}", retry_after_s=1.0)
            victim = min(victims, key=lambda n: self._last_used.get(n, 0))
            free = self._slot_of.pop(victim) - 1
            self._slots[free] = None
            self.evictions_total += 1
            log.info("adapter %r evicted from slot %d (LRU) for %r",
                     victim, free + 1, name)
        slot = free + 1
        self._upload_locked(name, slot)
        self._slots[free] = name
        self._slot_of[name] = slot
        log.info("adapter %r hot-loaded into slot %d", name, slot)
        return slot

    def release(self, name: str) -> None:
        """Drop one live-request reference (engine thread, at slot
        finish). The adapter stays resident until LRU pressure."""
        with self._lock:
            if self._refs.get(name, 0) > 0:
                self._refs[name] -= 1

    def pin(self, name: str) -> None:
        """Exempt from LRU eviction. Unknown names raise: a mistyped pin
        must not protect nothing."""
        with self._lock:
            if name not in self._registry:
                raise AdapterNotFoundError(f"cannot pin unknown adapter "
                                           f"{name!r}")
            self._pinned.add(name)

    def unpin(self, name: str) -> None:
        with self._lock:
            self._pinned.discard(name)

    def evict(self, name: str) -> bool:
        """Free an adapter's slot (admin). Refuses while live requests
        hold it; returns whether a slot was freed."""
        with self._lock:
            slot = self._slot_of.get(name)
            if slot is None or self._refs.get(name, 0):
                return False
            self._slot_of.pop(name)
            self._slots[slot - 1] = None
            self.evictions_total += 1
            return True

    @property
    def resident(self) -> int:
        return len(self._slot_of)

    def status(self) -> dict:
        """The ``adapters`` block of ``GPUEngine.kv_status()`` (the
        reference's /debug/kv)."""
        with self._lock:
            return {
                "max_adapters": self.max_adapters,
                "max_rank": self.max_rank,
                "registered": sorted(self._registry),
                "resident": dict(self._slot_of),
                "pinned": sorted(self._pinned),
                "active_refs": {n: r for n, r in self._refs.items() if r},
                "loads_total": self.loads_total,
                "evictions_total": self.evictions_total,
                "miss_total": self.miss_total,
                "requests_total": dict(self.requests_total),
            }
