"""Frontend node: OpenAI HTTP front + discovery + preprocessor + router
(counterpart of ``dynamo_tpu.frontend``).

    python -m dynamo_tpu_torch.frontend --http-port 8000 --coordinator-url tcp://127.0.0.1:4222

connects to the coordinator (and fails with its connection error when it
cannot be reached), builds a ``ModelWatcher`` over the port's
``HttpService``, prints ``FRONTEND_READY port=N`` (``--http-port 0`` picks
a free port) and serves every model that workers of either package
register, until SIGINT or SIGTERM (exit 0). ``--router-mode kv`` routes
each request to the worker whose KV cache holds most of its prefix,
weighed against load (``llm/kv_router``), under the reference's
``--kv-overlap-score-weight``, ``--kv-router-temperature``,
``--no-kv-federation`` and ``--busy-threshold``. ``--tls-cert-path``
with ``--tls-key-path`` serves HTTPS. The front serves ``/metrics`` and
the debug routes; its ``/debug/timeline`` merges every worker's journal
(``TimelineCollector``) with its own, and ``/debug/fleet`` fans out over
the workers' status servers. The reference frontend's other flags are
refused with the ROADMAP item each waits for.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import signal

from dynamo_tpu_torch.launch import add_refused_flags, start_front
from dynamo_tpu_torch.llm.discovery import ROUTER_MODES
from dynamo_tpu_torch.llm.kv_router import make_kv_router_factory
from dynamo_tpu_torch.llm.timeline import TimelineCollector
from dynamo_tpu_torch.runtime import flight, journal
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


_OVERLOAD = "ROADMAP item 12a (overload admission and brownout)"
_SLO = "ROADMAP item 12a (the SLO plane and the request log)"
_CANARY = "ROADMAP item 12a (canary probes and circuit breakers)"

# The reference frontend's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords).
REFUSED_FLAGS = (
    ("--no-overload-defense", _OVERLOAD, {}),
    ("--overload-target-ms", _OVERLOAD, {"type": float}),
    ("--overload-max-concurrency", _OVERLOAD, {"type": int}),
    ("--default-deadline-ms", _OVERLOAD, {"type": float}),
    ("--no-slo", _SLO, {}),
    ("--slo-ttft-p99-ms", _SLO, {"type": float}),
    ("--slo-itl-p99-ms", _SLO, {"type": float}),
    ("--slo-error-rate", _SLO, {"type": float}),
    ("--request-log", _SLO, {"type": str}),
    ("--canary", _CANARY, {}),
    ("--canary-interval-s", _CANARY, {"type": float}),
    ("--canary-ttft-bound-ms", _CANARY, {"type": float}),
    ("--canary-gate-joins", _CANARY, {}),
    ("--grpc-port", "the ROADMAP item of the KServe gRPC front",
     {"type": int}),
)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="dynamo_tpu_torch OpenAI frontend")
    parser.add_argument("--http-host", default="0.0.0.0")
    parser.add_argument("--http-port", type=int, default=8000,
                        help="0 picks a free port")
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--coordinator-url", default=None,
                        help="default: DTPU_COORDINATOR_URL, else "
                             "tcp://127.0.0.1:4222")
    parser.add_argument("--router-mode", default="round_robin",
                        choices=ROUTER_MODES,
                        help="worker selection policy (kv = KV-cache-aware)")
    parser.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    parser.add_argument("--kv-router-temperature", type=float, default=0.0)
    parser.add_argument("--no-kv-federation", action="store_true",
                        help="score candidates by the radix index only "
                             "(no inventory-sketch overlap union)")
    parser.add_argument("--busy-threshold", type=float, default=None,
                        help="reject (503) when all workers exceed this "
                             "fraction of their KV blocks in use")
    parser.add_argument("--tls-cert-path", default=None,
                        help="serve HTTPS with this PEM certificate "
                             "(needs --tls-key-path)")
    parser.add_argument("--tls-key-path", default=None)
    add_refused_flags(parser, REFUSED_FLAGS)
    return parser.parse_args(argv)


def kv_router_factory(args: argparse.Namespace):
    """The KV router factory of ``--router-mode kv`` and its flags, else
    None."""
    if args.router_mode != "kv":
        return None
    return make_kv_router_factory(
        overlap_score_weight=args.kv_overlap_score_weight,
        temperature=args.kv_router_temperature,
        busy_threshold=args.busy_threshold,
        federation=not args.no_kv_federation)


async def run(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    loop = asyncio.get_running_loop()
    runtime = await DistributedRuntime.from_settings(cfg)
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    service = watcher = collector = None
    try:
        # Before discovery starts: the first worker_join events carry this
        # process's id, not the "proc" placeholder.
        journal.configure(worker=f"{runtime.instance_id:x}",
                          metrics=runtime.metrics)
        flight.configure(metrics=runtime.metrics,
                         config_fingerprint=dataclasses.asdict(cfg))
        collector = TimelineCollector(runtime)
        await collector.start()
        service, watcher = await start_front(
            runtime, args.http_host, args.http_port, args.router_mode,
            kv_router_factory(args), tls_cert_path=args.tls_cert_path,
            tls_key_path=args.tls_key_path,
            timeline_provider=collector.timeline_status)
        print(f"FRONTEND_READY port={service.port}", flush=True)
        await runtime.wait_for_shutdown()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
        if service is not None:
            await service.stop()
            await watcher.stop()
        if collector is not None:
            await collector.stop()
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
