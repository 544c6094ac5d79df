"""The port stands alone: no file of dynamo_tpu_torch/, and not
chip_smoke.py, imports jax or anything of the JAX package dynamo_tpu, nor
a package the card's machine lacks (aiohttp, prometheus_client, pydantic,
tokenizers, jinja2, msgpack, xxhash, regex, safetensors, ml_dtypes,
huggingface_hub), nor ``tomli`` (the port reads TOML with the standard
library's ``tomllib``)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "dynamo_tpu", "aiohttp", "prometheus_client",
             "pydantic", "tokenizers", "jinja2", "msgpack", "xxhash", "regex",
             "tomli", "safetensors", "ml_dtypes", "huggingface_hub"}


def _imported_roots(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_files_found():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("module", [
    "backends/gpu.py", "frontend/main.py", "frontend/__main__.py",
    "runtime/msgpack_lite.py", "runtime/frame.py", "runtime/retry.py",
    "runtime/config.py", "runtime/coordinator.py",
    "runtime/coordinator_client.py", "runtime/component.py",
    "runtime/service.py", "runtime/client.py", "runtime/distributed.py",
    "llm/migration.py"])
def test_scan_reaches_the_distributed_modules(module):
    assert ROOT / "dynamo_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "engine/safetensors_lite.py", "engine/hub.py", "engine/quant.py",
    "engine/weights.py", "llm/gguf.py"])
def test_scan_reaches_the_checkpoint_modules(module):
    assert ROOT / "dynamo_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("module", [
    "runtime/metrics.py", "runtime/tracing.py", "runtime/journal.py",
    "runtime/flight.py", "runtime/health.py", "runtime/http_server.py",
    "llm/recorder.py", "llm/fleet.py", "llm/timeline.py",
    "engine/kv_metrics.py"])
def test_scan_reaches_the_observability_modules(module):
    assert ROOT / "dynamo_tpu_torch" / module in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in PORT_FILES if p.parent != ROOT and p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              f"{sorted(FORBIDDEN)!r})\n"
            + "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
