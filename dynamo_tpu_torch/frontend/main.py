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
the workers' status servers.

The overload defense runs by default (``runtime/overload.py``): an
adaptive limiter around the generate routes (``--no-overload-defense``,
``--overload-target-ms``, ``--overload-max-concurrency``,
``--default-deadline-ms``, the rest via ``DTPU_OVERLOAD_*`` /
``[overload]``) and per-worker circuit breakers in the endpoint clients.
The SLO plane (``--no-slo``, ``--slo-ttft-p99-ms``, ``--slo-itl-p99-ms``,
``--slo-error-rate``; ``DTPU_SLO_*`` / ``[slo]``) answers ``/debug/slo``,
and ``--request-log PATH`` appends each request's accounting record as
JSONL. ``--canary`` probes every worker with known-answer greedy requests
(``llm/canary.py``; ``--canary-interval-s``, ``--canary-ttft-bound-ms``,
``--canary-gate-joins``, ``DTPU_CANARY_*``). ``--grpc-port`` is refused
with the ROADMAP item it waits for.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from dynamo_tpu_torch.launch import (GRPC, add_refused_flags,
                                     init_observability, make_limiter,
                                     start_front)
from dynamo_tpu_torch.llm.canary import (CanaryConfig, CanaryProber,
                                         apply_canary_env)
from dynamo_tpu_torch.llm.discovery import ROUTER_MODES
from dynamo_tpu_torch.llm.kv_router import make_kv_router_factory
from dynamo_tpu_torch.llm.timeline import TimelineCollector
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime


# The reference frontend's flags that the port does not serve:
# (flag, what it waits for, add_argument keywords).
REFUSED_FLAGS = (
    ("--grpc-port", GRPC, {"type": int}),
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
    # Overload defense; the rest via DTPU_OVERLOAD_* / [overload].
    parser.add_argument("--no-overload-defense", action="store_true",
                        help="no adaptive admission or shedding on the "
                             "HTTP front (breakers stay governed by "
                             "DTPU_OVERLOAD_BREAKER_ENABLED)")
    parser.add_argument("--overload-target-ms", type=float, default=None,
                        help="the TTFT target the admission limit adapts "
                             "against")
    parser.add_argument("--overload-max-concurrency", type=int, default=None)
    parser.add_argument("--default-deadline-ms", type=float, default=None,
                        help="the deadline of a request without an "
                             "x-request-deadline-ms header")
    # SLO plane; the rest via DTPU_SLO_* / [slo].
    parser.add_argument("--no-slo", action="store_true",
                        help="no SLO plane (SLIs, burn-rate alerts)")
    parser.add_argument("--slo-ttft-p99-ms", type=float, default=None,
                        help="TTFT target: 99%% of requests reach their "
                             "first token within it")
    parser.add_argument("--slo-itl-p99-ms", type=float, default=None,
                        help="ITL target: 99%% of inter-token gaps under it")
    parser.add_argument("--slo-error-rate", type=float, default=None,
                        help="availability target: the largest fraction of "
                             "requests that may fail")
    parser.add_argument("--request-log", default=None,
                        help="append per-request accounting records as "
                             "JSONL here")
    # Synthetic canary probes; the rest via DTPU_CANARY_*.
    parser.add_argument("--canary", action="store_true",
                        help="probe every worker with tiny known-answer "
                             "greedy requests; repeated failures open its "
                             "circuit breaker")
    parser.add_argument("--canary-interval-s", type=float, default=None)
    parser.add_argument("--canary-ttft-bound-ms", type=float, default=None)
    parser.add_argument("--canary-gate-joins", action="store_true",
                        help="hold a joining worker on breaker probation "
                             "until a canary probe passes")
    add_refused_flags(parser, REFUSED_FLAGS)
    return parser.parse_args(argv)


def apply_front_args(cfg: RuntimeConfig, args: argparse.Namespace) -> None:
    """The overload and SLO flags onto ``cfg``, as the reference frontend
    applies them."""
    ov = cfg.overload
    if args.no_overload_defense:
        ov.enabled = False
    if args.overload_target_ms is not None:
        ov.target_latency_ms = args.overload_target_ms
    if args.overload_max_concurrency is not None:
        ov.max_concurrency = args.overload_max_concurrency
    if args.default_deadline_ms is not None:
        ov.default_deadline_ms = args.default_deadline_ms
    if args.no_slo:
        cfg.slo.enabled = False
    if args.slo_ttft_p99_ms is not None:
        cfg.slo.ttft_p99_ms = args.slo_ttft_p99_ms
    if args.slo_itl_p99_ms is not None:
        cfg.slo.itl_p99_ms = args.slo_itl_p99_ms
    if args.slo_error_rate is not None:
        cfg.slo.error_rate = args.slo_error_rate
    if args.request_log is not None:
        cfg.slo.request_log_path = args.request_log


def canary_config(args: argparse.Namespace) -> CanaryConfig:
    """``DTPU_CANARY_*`` under the ``--canary*`` flags."""
    cfg = apply_canary_env(CanaryConfig())
    if args.canary:
        cfg.enabled = True
    if args.canary_interval_s is not None:
        cfg.interval_s = args.canary_interval_s
    if args.canary_ttft_bound_ms is not None:
        cfg.ttft_bound_ms = args.canary_ttft_bound_ms
    if args.canary_gate_joins:
        cfg.enabled = cfg.gate_joins = True
    return cfg


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
    apply_front_args(cfg, args)
    loop = asyncio.get_running_loop()
    runtime = await DistributedRuntime.from_settings(cfg)
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, runtime.shutdown)
    service = watcher = collector = canary = None
    try:
        # Before discovery starts: the first worker_join events carry this
        # process's id, not the "proc" placeholder.
        init_observability(cfg, runtime.metrics,
                           worker=f"{runtime.instance_id:x}")
        collector = TimelineCollector(runtime)
        await collector.start()
        ccfg = canary_config(args)
        hooks = None
        if ccfg.enabled:
            # The watcher's manager is the one the prober probes.
            def hooks(watcher):
                nonlocal canary
                canary = CanaryProber(watcher.manager, ccfg,
                                      metrics=runtime.metrics)
                watcher.on_join = canary.note_join
                watcher.on_leave = canary.note_leave
        service, watcher = await start_front(
            runtime, args.http_host, args.http_port, args.router_mode,
            kv_router_factory(args), tls_cert_path=args.tls_cert_path,
            tls_key_path=args.tls_key_path,
            timeline_provider=collector.timeline_status,
            overload=make_limiter(cfg, runtime.metrics),
            watcher_hooks=hooks)
        if canary is not None:
            canary.start()
        print(f"FRONTEND_READY port={service.port}", flush=True)
        await runtime.wait_for_shutdown()
    finally:
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.remove_signal_handler(sig)
        if canary is not None:
            await canary.stop()
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
