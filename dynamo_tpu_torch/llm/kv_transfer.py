"""KV parcel serialization for disaggregated prefill -> decode transfer
(counterpart of ``dynamo_tpu.llm.kv_transfer``).

The prefill worker extracts the prompt's KV pages (a host parcel,
``engine/kv_quant.py``: bf16 ``[2, L, Nkv, n, page, D]`` or the packed
int8 form) and either stages them on its KV plane (``llm/kv_plane.py``)
and sends a ticket, or streams them INLINE over the request plane as
8 MiB ``kv_chunk`` response frames. The meta frame ``{"shape", "dtype",
"n_chunks"}`` and the chunk bytes are the JAX package's, so a decode
worker of either package assembles a parcel of either.
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator

import numpy as np

from dynamo_tpu_torch.engine.kv_quant import parcel_dtype, parcel_dtype_name

CHUNK_BYTES = 8 << 20  # 8 MiB response frames


def kv_to_chunks(kv: np.ndarray) -> tuple[dict, list[bytes]]:
    """Serialize a KV parcel: returns (meta, chunk list)."""
    raw = np.ascontiguousarray(kv).tobytes()
    chunks = [raw[i:i + CHUNK_BYTES] for i in range(0, len(raw), CHUNK_BYTES)]
    if not chunks:
        chunks = [b""]
    meta = {"shape": list(kv.shape), "dtype": parcel_dtype_name(kv),
            "n_chunks": len(chunks)}
    return meta, chunks


def kv_from_chunks(meta: dict, chunks: list[bytes]) -> np.ndarray:
    if len(chunks) != meta["n_chunks"]:
        raise ValueError(f"got {len(chunks)} KV chunks, the meta frame "
                         f"announced {meta['n_chunks']}")
    raw = bytearray().join(chunks)  # writable: torch uploads it as it is
    return np.frombuffer(raw, dtype=parcel_dtype(meta["dtype"])) \
        .reshape(meta["shape"])


async def collect_prefill_response(stream: AsyncIterator[dict],
                                   plane_client=None) -> tuple[int, np.ndarray]:
    """Assemble a prefill worker's response into (first_token, parcel).

    Two wire forms: a transfer TICKET (the parcel is staged on the
    worker's KV plane: pull the bulk bytes there), or inline chunks. The
    pull starts the moment the ticket lands: a chunk-streamed prefill
    worker sends its ticket before the first token, so the bytes cross
    while later chunks still compute. If the stream dies, the pull is
    cancelled."""
    chunks: list[bytes] = []
    meta = None
    ticket = None
    first_token = None
    pull_task: asyncio.Future | None = None
    try:
        async for out in stream:
            dp = out.get("disagg_params") or {}
            if "ticket" in dp:
                ticket = dp["ticket"]
                if pull_task is None and plane_client is not None:
                    pull_task = asyncio.ensure_future(
                        plane_client.pull(ticket))
            if "kv_chunk" in dp:
                chunks.append(dp["kv_chunk"])
            if "shape" in dp:
                meta = dp
            toks = out.get("token_ids") or []
            if toks:
                first_token = toks[0]
    except BaseException:
        if pull_task is not None:
            pull_task.cancel()
        raise
    if first_token is None or (meta is None and ticket is None):
        if pull_task is not None:
            pull_task.cancel()
        raise RuntimeError("incomplete disaggregated prefill response")
    if ticket is not None:
        if plane_client is None:
            raise RuntimeError(
                "prefill worker sent a KV-plane ticket but this worker "
                "has no plane client")
        return first_token, await pull_task
    return first_token, kv_from_chunks(meta, chunks)
