"""Kubernetes connector (copy of ``dynamo_tpu.planner.kube``): planner
decisions become StatefulSet scale patches through the ``/scale``
subresource of the apps/v1 API.

Standard library only (``urllib`` and ``ssl``). The in-cluster settings
come from the service-account mount as the official client reads them;
a test points ``base_url`` at a fake API server.
"""

from __future__ import annotations

import asyncio
import json
import os
import ssl
import urllib.error
import urllib.request

from dynamo_tpu_torch.planner.connector import Connector
from dynamo_tpu_torch.runtime.logging import get_logger

log = get_logger("planner.kube")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def current_namespace(default: str = "default") -> str:
    """The pod's namespace when running in-cluster (service-account
    mount), else ``default`` (reference kube.py
    get_current_k8s_namespace)."""
    try:
        with open(os.path.join(SA_DIR, "namespace"), encoding="utf-8") as fh:
            return fh.read().strip()
    except FileNotFoundError:
        return default


class KubernetesAPI:
    """Minimal apps/v1 client for StatefulSet scale operations.

    ``base_url``/``token`` default to the in-cluster environment
    (KUBERNETES_SERVICE_HOST/PORT + the mounted service-account token and
    CA). Blocking I/O runs on executor threads behind the async API.
    """

    def __init__(self, base_url: str | None = None,
                 token: str | None = None,
                 namespace: str | None = None,
                 ca_file: str | None = None):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a cluster (no KUBERNETES_SERVICE_HOST) and no "
                    "base_url given")
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        if token is None:
            try:
                with open(os.path.join(SA_DIR, "token"),
                          encoding="utf-8") as fh:
                    token = fh.read().strip()
            except FileNotFoundError:
                token = None
        self.token = token
        self.namespace = namespace or current_namespace()
        if ca_file is None:
            default_ca = os.path.join(SA_DIR, "ca.crt")
            ca_file = default_ca if os.path.exists(default_ca) else None
        self._ssl = (ssl.create_default_context(cafile=ca_file)
                     if self.base_url.startswith("https") else None)

    # -- sync core (executor) ------------------------------------------------
    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json") -> dict:
        url = self.base_url + path
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=15,
                                        context=self._ssl) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode(errors="replace")[:500]
            raise KubeAPIError(exc.code, f"{method} {path}: {detail}") \
                from exc

    def _sts_path(self, name: str, sub: str = "") -> str:
        return (f"/apis/apps/v1/namespaces/{self.namespace}"
                f"/statefulsets/{name}{sub}")

    # -- async API ------------------------------------------------------------
    async def get_statefulset(self, name: str) -> dict | None:
        try:
            return await asyncio.get_running_loop().run_in_executor(
                None, self._request, "GET", self._sts_path(name))
        except KubeAPIError as exc:
            if exc.status == 404:
                return None
            raise

    async def get_replicas(self, name: str) -> int | None:
        try:
            scale = await asyncio.get_running_loop().run_in_executor(
                None, self._request, "GET", self._sts_path(name, "/scale"))
        except KubeAPIError as exc:
            if exc.status == 404:
                return None
            raise
        return int((scale.get("spec") or {}).get("replicas", 0))

    async def set_replicas(self, name: str, replicas: int) -> None:
        body = {"spec": {"replicas": int(replicas)}}
        await asyncio.get_running_loop().run_in_executor(
            None, lambda: self._request(
                "PATCH", self._sts_path(name, "/scale"), body,
                "application/merge-patch+json"))

    # -- generic manifests (deploy_graph re-render loop) ----------------------
    def _collection_path(self, manifest: dict) -> str:
        """Collection URL for a namespaced manifest. Plural = lowercased
        kind + 's' — correct for every kind the graph renderer emits
        (Deployment, StatefulSet, Service, ConfigMap, ServiceAccount,
        Role, RoleBinding)."""
        api = manifest.get("apiVersion", "v1")
        plural = manifest["kind"].lower() + "s"
        prefix = "/api/v1" if api == "v1" else f"/apis/{api}"
        return f"{prefix}/namespaces/{self.namespace}/{plural}"

    async def apply(self, manifest: dict) -> str:
        """Create-or-replace one manifest. Returns "created" |
        "replaced". (GET -> POST on 404, else PUT carrying the live
        resourceVersion — the stdlib-client equivalent of kubectl
        apply for the renderer's fully-specified manifests.)"""
        name = manifest["metadata"]["name"]
        base = self._collection_path(manifest)

        def do() -> str:
            try:
                cur = self._request("GET", f"{base}/{name}")
            except KubeAPIError as exc:
                if exc.status != 404:
                    raise
                self._request("POST", base, manifest)
                return "created"
            body = dict(manifest)
            md = dict(body.get("metadata") or {})
            rv = (cur.get("metadata") or {}).get("resourceVersion")
            if rv:
                md["resourceVersion"] = rv
            body["metadata"] = md
            self._request("PUT", f"{base}/{name}", body)
            return "replaced"

        return await asyncio.get_running_loop().run_in_executor(None, do)


class KubeAPIError(RuntimeError):
    def __init__(self, status: int, msg: str):
        super().__init__(msg)
        self.status = status


class KubernetesConnector(Connector):
    """Scales the StatefulSets deploy_graph.py renders: component ``c`` of
    graph ``g`` lives in StatefulSet ``g-c`` (deploy_graph._component_name).
    Reference: kubernetes_connector.py (set_component_replicas /
    add_component).

    Error discipline: an unreachable/flaky API server retries under the
    unified ``policies.KUBE_SCALE`` curve (runtime/retry.py, bounded);
    exhausting it journals a typed ``planner_decision`` failure and
    returns instead of raising into the planner's ``step()`` — the next
    adjustment interval re-decides from fresh signals, which is the
    correct retry for a scaling loop. Kubernetes API *rejections*
    (KubeAPIError: RBAC, bad namespace) are real configuration bugs
    and still propagate."""

    def __init__(self, graph_name: str, api: KubernetesAPI | None = None):
        self.graph_name = graph_name
        self.api = api or KubernetesAPI()
        self.scale_failures = 0

    def _sts(self, component: str) -> str:
        return f"{self.graph_name}-{component}"

    async def scale(self, component: str, replicas: int) -> None:
        from dynamo_tpu_torch.runtime import journal
        from dynamo_tpu_torch.runtime.journal import EventKind
        from dynamo_tpu_torch.runtime.retry import Backoff, policies
        name = self._sts(component)
        backoff = Backoff(policies.KUBE_SCALE)
        while True:
            try:
                await self.api.set_replicas(name, replicas)
                log.info("scaled %s -> %d replicas", name, replicas)
                return
            except KubeAPIError:
                raise  # API rejection: a config bug, not a transient
            except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
                if await backoff.sleep():
                    continue
                self.scale_failures += 1
                journal.emit(
                    EventKind.PLANNER_DECISION, action="scale_failed",
                    component=component, target=replicas,
                    error=f"{type(exc).__name__}: {exc}",
                    attempts=backoff.attempt)
                log.warning("scale %s -> %d failed after %d attempts: %s "
                            "(next interval retries)", name, replicas,
                            backoff.attempt, exc)
                return

    async def current(self, component: str) -> int | None:
        from dynamo_tpu_torch.runtime.retry import Backoff, policies
        backoff = Backoff(policies.KUBE_SCALE)
        while True:
            try:
                return await self.api.get_replicas(self._sts(component))
            except KubeAPIError:
                raise
            except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
                if await backoff.sleep():
                    continue
                log.warning("get_replicas %s failed: %s (treating as "
                            "unknown)", component, exc)
                return None
