"""Mocker worker (copy of ``dynamo_tpu.backends.mocker``): serves the
engine simulator (``llm/mocker.py``) as a registered model, so KV
routing, overload, disaggregation, role flips and the planner run
without a card.

    python -m dynamo_tpu_torch.backends.mocker --coordinator-url tcp://127.0.0.1:4222
    python -m dynamo_tpu_torch.backends.mocker --mode prefill --coordinator-url ...
    python -m dynamo_tpu_torch.backends.mocker --standby --coordinator-url ...

``--mode prefill|decode|agg`` is the launch role; a ``SetRole``
directive (the planner, or the status server's POST /control/role)
flips it live through ``llm/reconfig.py``, and ``--standby`` parks it
until a promote directive (``llm/standby.py``). Its prefill role serves
the same simulator under the prefill component (registration, drain and
rewiring are real; KV parcels are the GPU worker's). It prints
``MOCKER_READY mode=<role|standby> port=N worker=<hex>`` and exits 0 on
SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio

from dynamo_tpu_torch.llm.kv_router.publisher import (KvEventPublisher,
                                                KvInventoryPublisher,
                                                WorkerMetricsPublisher)
from dynamo_tpu_torch.llm.mocker import MockerConfig, MockerEngine
from dynamo_tpu_torch.llm.model_card import (ModelRuntimeConfig, deregister_llm,
                                       register_llm)
from dynamo_tpu_torch.llm.reconfig import ROLES, RoleManager, ServingProfile
from dynamo_tpu_torch.llm.standby import ScaleAgent
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, make_test_tokenizer
from dynamo_tpu_torch.runtime import journal
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.journal import JournalPublisher


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="dynamo_tpu_torch mocker worker")
    parser.add_argument("--model-name", default="mock-model")
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--component", default="mocker")
    parser.add_argument("--endpoint", default="generate")
    parser.add_argument("--tokenizer", default=None)
    parser.add_argument("--num-kv-blocks", type=int, default=1024)
    parser.add_argument("--block-size", type=int, default=16)
    parser.add_argument("--max-num-seqs", type=int, default=64)
    parser.add_argument("--speedup-ratio", type=float, default=1.0)
    parser.add_argument("--host-blocks", type=int, default=0,
                        help="simulated host (G2) tier capacity: evicted "
                             "blocks demote here, stay in the inventory "
                             "digest, and serve peer pulls over the KV "
                             "plane (federation testing without a card)")
    parser.add_argument("--kv-plane", action="store_true",
                        help="run a KV plane server + G4 remote source "
                             "on this mocker (peer block pulls)")
    parser.add_argument("--migration-limit", type=int, default=0)
    parser.add_argument("--coordinator-url", default=None)
    parser.add_argument("--mode", default="agg", choices=list(ROLES),
                        help="launch role; runtime-reconfigurable via "
                             "SetRole (llm/reconfig.py)")
    parser.add_argument("--standby", action="store_true",
                        help="park as a pre-warmed standby: simulator "
                             "ready but DEREGISTERED, announced on a "
                             "standby/ lease key, joining the serving "
                             "fleet only on a planner promote "
                             "directive (llm/standby.py)")
    parser.add_argument("--prefill-component", default="prefill",
                        help="component the prefill role registers under")
    parser.add_argument("--lora", action="append", default=[],
                        metavar="NAME",
                        help="register NAME as a served LoRA adapter "
                             "name riding this mocker's base model "
                             "(repeatable; the simulator ignores the "
                             "adapter — this exercises the frontend "
                             "resolution / routing / accounting path "
                             "without a card)")
    return parser.parse_args(argv)


def make_profile_builder(runtime, engine, args, tokenizer):
    """Per-role serving profiles around ONE simulator engine, as
    ``backends.gpu.make_profile_builder`` builds them around a
    GPUEngine."""

    async def build(role: str) -> ServingProfile:
        prof = ServingProfile(role)
        if role == "prefill":
            endpoint = (runtime.namespace(None)
                        .component(args.prefill_component)
                        .endpoint(args.endpoint))
            server = await endpoint.serve_endpoint(engine.handler(),
                                                   graceful_shutdown=True)
            prof.add_server(server)
            return prof
        # decode/agg: the routable model endpoint + its model card.
        endpoint = (runtime.namespace(None).component(args.component)
                    .endpoint(args.endpoint))
        server = await endpoint.serve_endpoint(engine.handler(),
                                               graceful_shutdown=False)
        prof.add_server(server)
        await register_llm(
            runtime, endpoint, args.model_name, tokenizer,
            kv_cache_block_size=args.block_size,
            migration_limit=args.migration_limit,
            runtime_config=ModelRuntimeConfig(
                total_kv_blocks=args.num_kv_blocks,
                max_num_seqs=args.max_num_seqs))
        prof.add_closer(
            "model-card", lambda: deregister_llm(runtime, args.model_name))
        from dynamo_tpu_torch.llm.model_card import register_adapter
        for lname in getattr(args, "lora", None) or []:
            await register_adapter(
                runtime, endpoint, lname, args.model_name, tokenizer,
                kv_cache_block_size=args.block_size,
                migration_limit=args.migration_limit)
            prof.add_closer(f"adapter-card-{lname}",
                            lambda n=lname: deregister_llm(runtime, n))
        return prof

    return build


async def run(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(cfg)
    try:
        tokenizer = (Tokenizer.from_file(args.tokenizer) if args.tokenizer
                     else make_test_tokenizer())
        mocker_cfg = MockerConfig(
            num_kv_blocks=args.num_kv_blocks, block_size=args.block_size,
            max_num_seqs=args.max_num_seqs, speedup_ratio=args.speedup_ratio,
            host_blocks=args.host_blocks)
        ns = cfg.namespace
        kv_pub = KvEventPublisher(runtime, ns, args.component,
                                  runtime.instance_id)
        metrics_pub = WorkerMetricsPublisher(runtime, ns, args.component,
                                             runtime.instance_id)
        inventory_pub = KvInventoryPublisher(runtime, ns, args.component,
                                             runtime.instance_id)
        engine = MockerEngine(mocker_cfg, kv_pub, metrics_pub,
                              inventory_publisher=inventory_pub)
        inventory_pub.start_periodic(engine.inventory_digest)
        plane = None
        peer_watch_task = None
        if args.kv_plane:
            # The GPU worker's kvplane/ registration and peer watch at
            # mocker scale: the plane serves this worker's simulated
            # blocks, the remote source pulls the peers'.
            from dynamo_tpu_torch.llm.kv_plane import (KvPlaneServer,
                                                 RemoteBlockSource)
            plane = KvPlaneServer(block_provider=engine.host_block_provider)
            plane.start()
            coordinator = runtime.require_coordinator()
            await coordinator.kv_put(
                f"kvplane/{ns}/{runtime.instance_id:x}",
                {"addr": plane.address, "model": args.model_name},
                lease_id=coordinator.primary_lease_id)
            engine.remote_source = RemoteBlockSource(self_addr=plane.address)

            async def watch_peers() -> None:
                watch = await coordinator.watch_prefix(f"kvplane/{ns}/")
                peers = {item["k"]: item["v"]["addr"]
                         for item in watch.snapshot
                         if item["v"].get("model") == args.model_name}
                engine.remote_source.peers = [
                    a for a in peers.values() if a != plane.address]
                async for event in watch:
                    if event["event"] == "put" and \
                            event["value"].get("model") == args.model_name:
                        peers[event["key"]] = event["value"]["addr"]
                    elif event["event"] == "delete":
                        gone = peers.pop(event["key"], None)
                        if gone is not None:
                            # worker_leave/scale-in: drop the peer AND
                            # its breaker state now, not at TTL.
                            engine.remote_source.drop_peer(gone)
                    engine.remote_source.peers = [
                        a for a in peers.values() if a != plane.address]

            peer_watch_task = asyncio.create_task(watch_peers())
        # Decision plane: this worker's journal (role flips, preempts,
        # breaker views) rides the event plane into the frontend's
        # merged /debug/timeline.
        journal.configure(worker=f"{runtime.instance_id:x}",
                          metrics=runtime.metrics)
        journal_pub = JournalPublisher(runtime.require_coordinator(), ns,
                                       f"{runtime.instance_id:x}")
        journal_pub.start_periodic()
        roles = RoleManager(runtime,
                            make_profile_builder(runtime, engine, args,
                                                 tokenizer),
                            role=args.mode,
                            status_extra={"backend": "mocker",
                                          "model": args.model_name})
        # Autoscaling: every worker answers scale directives (retire);
        # --standby parks warm and deregistered until a promote.
        scale_agent = ScaleAgent(
            runtime, roles, standby=args.standby,
            status_extra={"backend": "mocker", "model": args.model_name},
            metrics=runtime.metrics)
        if not args.standby:
            await roles.start()
        await scale_agent.start()
        engine.start()
        status_server = None
        if cfg.system_enabled:
            from dynamo_tpu_torch.llm.fleet import register_status_server
            from dynamo_tpu_torch.runtime.health import SystemStatusServer
            status_server = SystemStatusServer(runtime, host=cfg.bind_host,
                                               port=cfg.system_port,
                                               role_manager=roles,
                                               kv_provider=engine.kv_status,
                                               perf_provider=engine.perf_status,
                                               scale_agent=scale_agent)
            await status_server.start()
            await register_status_server(
                runtime, status_server.port,
                extra={"backend": "mocker", "component": args.component,
                       "model": args.model_name})
        port = (roles.profile.servers[0].port
                if roles.profile and roles.profile.servers else 0)
        mode = "standby" if args.standby else args.mode
        print(f"MOCKER_READY mode={mode} port={port} "
              f"worker={runtime.instance_id:x}", flush=True)
        import signal
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, runtime.shutdown)
            except NotImplementedError:
                pass
        await runtime.wait_for_shutdown()
        journal_pub.stop_periodic()
        inventory_pub.stop_periodic()
        if peer_watch_task is not None:
            peer_watch_task.cancel()
        if plane is not None:
            plane.close()
        await engine.stop()
        if status_server is not None:
            await status_server.stop()
        await scale_agent.stop()
        await roles.stop()
    finally:
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
