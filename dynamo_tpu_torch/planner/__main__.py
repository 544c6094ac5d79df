"""``python -m dynamo_tpu_torch.planner``: the planner as a process (the
options of ``python -m dynamo_tpu.planner``).

    python -m dynamo_tpu_torch.planner --coordinator-url tcp://127.0.0.1:4222 --adjustment-interval 2
    python -m dynamo_tpu_torch.planner --reconfig --model-name llama-3-8b --prefill-component prefill
    python -m dynamo_tpu_torch.planner --autoscale --autoscale-role agg --autoscale-max 4

It reads the workers' ForwardPassMetrics stream through the coordinator
and scales the pools through the connector: ``--connector log`` (the
default) records the decisions only, ``--connector kube`` patches the
StatefulSets ``<graph>-<component>`` through the Kubernetes API
(``planner/kube.py``). ``--reconfig`` drives live role flips
(``DTPU_PLANNER_RECONFIG_*`` knobs) and ``--autoscale`` the worker count
through standby promotions and retirements (``DTPU_PLANNER_CAPACITY_*``).
It prints ``PLANNER_READY`` once it listens, then one ``PLANNER_STEP
{json}`` line per adjustment interval (that step's decision records and
the live workers each pool's metrics stream shows), and exits 0 on
SIGINT or SIGTERM.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal

from dynamo_tpu_torch.planner.capacity import CapacityConfig, apply_capacity_env
from dynamo_tpu_torch.planner.connector import FakeConnector
from dynamo_tpu_torch.planner.core import Planner, PlannerConfig
from dynamo_tpu_torch.planner.reconfig import ReconfigConfig, apply_reconfig_env
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.main")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo_tpu_torch SLA planner")
    p.add_argument("--namespace", default=None)
    p.add_argument("--decode-component", default="gpu")
    p.add_argument("--prefill-component", default=None,
                   help="set for disaggregated deployments")
    p.add_argument("--adjustment-interval", type=float, default=10.0)
    p.add_argument("--predictor", default="moving_average",
                   choices=["constant", "moving_average", "linear"])
    p.add_argument("--max-num-seqs-per-worker", type=int, default=32)
    p.add_argument("--target-utilization", type=float, default=0.8)
    p.add_argument("--prefill-capacity-tok-s", type=float, default=8000.0)
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=8)
    p.add_argument("--connector", default="log", choices=["log", "kube"])
    p.add_argument("--graph-name", default=None,
                   help="kube connector: the deploy_graph graph name "
                        "(StatefulSets are <graph>-<component>)")
    p.add_argument("--kube-url", default=None,
                   help="kube connector: API server base URL override "
                        "(default: in-cluster env)")
    p.add_argument("--coordinator-url", default=None)
    p.add_argument("--model-name", default=None,
                   help="served model name: enables the prefill-queue "
                        "depth signal for --reconfig")
    p.add_argument("--reconfig", action="store_true",
                   help="drive live prefill/decode role flips from SLO "
                        "pressure + prefill-queue depth (knobs via "
                        "DTPU_PLANNER_RECONFIG_*; llm/reconfig.py)")
    p.add_argument("--autoscale", action="store_true",
                   help="drive worker COUNT from the live capacity "
                        "model: promote pre-warmed standbys on "
                        "sustained SLO burn, retire the least-loaded "
                        "worker on sustained headroom (knobs via "
                        "DTPU_PLANNER_CAPACITY_*; planner/capacity.py)")
    p.add_argument("--autoscale-role", default="decode",
                   help="the role promoted standbys serve")
    p.add_argument("--autoscale-min", type=int, default=1)
    p.add_argument("--autoscale-max", type=int, default=8)
    return p.parse_args(argv)


async def run(args: argparse.Namespace) -> None:
    cfg = RuntimeConfig.from_settings()
    if args.coordinator_url:
        cfg.coordinator_url = args.coordinator_url
    if args.namespace:
        cfg.namespace = args.namespace
    runtime = await DistributedRuntime.from_settings(cfg)
    try:
        if args.connector == "kube":
            from dynamo_tpu_torch.planner.kube import (
                KubernetesAPI, KubernetesConnector)
            if not args.graph_name:
                raise SystemExit("--connector kube needs --graph-name")
            connector = KubernetesConnector(
                args.graph_name,
                api=KubernetesAPI(base_url=args.kube_url))
        else:
            connector = FakeConnector()
        planner = Planner(PlannerConfig(
            namespace=cfg.namespace,
            decode_component=args.decode_component,
            prefill_component=args.prefill_component,
            adjustment_interval_s=args.adjustment_interval,
            predictor=args.predictor,
            max_num_seqs_per_worker=args.max_num_seqs_per_worker,
            target_utilization=args.target_utilization,
            prefill_capacity_tok_s=args.prefill_capacity_tok_s,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            model_name=args.model_name,
            reconfig=apply_reconfig_env(
                ReconfigConfig(enabled=args.reconfig)),
            capacity=apply_capacity_env(CapacityConfig(
                enabled=args.autoscale, role=args.autoscale_role,
                component=args.decode_component,
                min_workers=args.autoscale_min,
                max_workers=args.autoscale_max)),
        ), connector, runtime=runtime)
        step = planner.step

        async def step_and_print() -> dict:
            out = await step()
            pools = {"decode": planner.decode, "prefill": planner.prefill}
            print("PLANNER_STEP " + json.dumps({
                "decisions": out,
                "live_workers": {name: pool.snapshot()["workers"]
                                 for name, pool in pools.items()
                                 if pool is not None}}, default=str),
                flush=True)
            return out
        planner.step = step_and_print
        await planner.start()
        print(f"PLANNER_READY connector={args.connector} "
              f"decode={args.decode_component} "
              f"prefill={args.prefill_component or '-'}", flush=True)
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, runtime.shutdown)
        await runtime.wait_for_shutdown()
        await planner.stop()
    finally:
        await runtime.close()


def main(argv=None) -> None:
    asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    main()
