"""Real checkpoints in the port: ``safetensors_lite``,
``ModelSpec.from_hf_config``, ``hub.resolve_model``, ``load_hf_weights``
and the entry points' ``--model DIR``, against the JAX package and HF
``transformers``.

Tiny random-init Llama (untied) and Qwen2 (tied, q/k/v biases)
checkpoints are built with ``save_pretrained`` (float32 files), as
``tests/test_golden_hf.py`` builds them, then rewritten as F16 and BF16
files and as two shards. Held:

- every leaf the port loads is bit-equal to the JAX ``load_hf_weights``
  leaf (F32 and F16 convert to bf16 by round-to-nearest-even on both
  sides), and with ``--quant int8`` to the JAX ``quantize_params`` of it;
- the port's safetensors reader reads what ``safetensors.numpy`` writes,
  ``safetensors.safe_open`` reads what the port writes, and unsupported
  dtypes, truncated headers and truncated data raise;
- ``from_hf_config`` equals the JAX one field by field (Llama, Qwen2,
  Mixtral), and ``resolve_model`` the JAX ``resolve_model(...,
  allow_download=False)`` on a preset, a directory and a hub cache tree,
  with the same error for an id the cache lacks;
- the port's teacher-forced logits of the loaded checkpoint pass
  ``test_golden_hf.py``'s margin rule against ``transformers`` in fp32;
- the launcher and the worker main serve a checkpoint directory as CPU
  subprocesses (the launcher with ``--quant int8``), each choosing the
  tokenizer in its reference's order; refusals name their cause.
"""

import dataclasses
import json
import os
import shutil

import jax
import ml_dtypes
import numpy as np
import pytest
import safetensors
import safetensors.numpy
import torch
import transformers
from test_torch_http import _call, sse_events
from test_torch_preprocessor import chat
from test_torch_worker import Proc

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import hub as jhub
from dynamo_tpu.engine import quant as jq
from dynamo_tpu.engine.weights import load_hf_weights as jload
from dynamo_tpu.llm.tokenizer import make_test_tokenizer as j_test_tokenizer
from dynamo_tpu_torch import launch
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import hub as thub
from dynamo_tpu_torch.engine import model as tmodel
from dynamo_tpu_torch.engine import safetensors_lite as sl
from dynamo_tpu_torch.engine.quant import QTensor
from dynamo_tpu_torch.engine.weights import load_hf_weights as tload
from dynamo_tpu_torch.llm import gguf
from dynamo_tpu_torch.llm.tokenizer import Tokenizer, make_test_tokenizer

torch.set_num_threads(1)

VOCAB = 384   # above the test tokenizer's 361 ids, so served prompts fit
MARGIN = 0.08  # test_golden_hf.py's bf16-vs-fp32 near-tie tolerance
DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16}


def _hf_config(kind):
    common = dict(vocab_size=VOCAB, hidden_size=128, intermediate_size=352,
                  num_hidden_layers=2, num_attention_heads=8,
                  num_key_value_heads=4, max_position_embeddings=2048,
                  rope_theta=10000.0, rms_norm_eps=1e-5)
    if kind == "llama":
        return transformers.LlamaConfig(tie_word_embeddings=False,
                                        attention_bias=False, **common)
    return transformers.Qwen2Config(tie_word_embeddings=True, **common)


def _rewrite(src: str, dst: str, dtype, shards: int = 1) -> None:
    """Copy checkpoint ``src`` to ``dst`` with its tensors as ``dtype`` in
    ``shards`` files."""
    os.makedirs(dst)
    shutil.copy(os.path.join(src, "config.json"), dst)
    tensors = safetensors.numpy.load_file(
        os.path.join(src, "model.safetensors"))
    names = sorted(tensors)
    for i in range(shards):
        part = {n: tensors[n].astype(dtype) for n in names[i::shards]}
        safetensors.numpy.save_file(
            part, os.path.join(dst, f"model-{i + 1:05d}-of-{shards:05d}"
                                    ".safetensors"), {"format": "pt"})


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """name -> (directory, HF model) for llama/qwen2 x F32/F16/BF16 and a
    two-shard BF16 copy of each."""
    out = {}
    for seed, kind in enumerate(("llama", "qwen2")):
        torch.manual_seed(seed)
        cls = (transformers.LlamaForCausalLM if kind == "llama"
               else transformers.Qwen2ForCausalLM)
        model = cls(_hf_config(kind)).eval()
        base = str(tmp_path_factory.mktemp(f"{kind}-F32"))
        model.save_pretrained(base, safe_serialization=True)
        out[f"{kind}-F32"] = (base, model)
        for name, dtype, shards in (("F16", np.float16, 1),
                                    ("BF16", ml_dtypes.bfloat16, 1),
                                    ("sharded", ml_dtypes.bfloat16, 2)):
            dst = str(tmp_path_factory.mktemp("ckpt") / f"{kind}-{name}")
            _rewrite(base, dst, dtype, shards)
            out[f"{kind}-{name}"] = (dst, model)
    return out


def _assert_tree_bits(jtree, ttree, path=""):
    assert set(jtree) == set(ttree), path
    for key, jv in jtree.items():
        tv, name = ttree[key], path + key
        if isinstance(jv, dict):
            _assert_tree_bits(jv, tv, name + ".")
        elif isinstance(jv, jq.QTensor):
            assert isinstance(tv, QTensor), name
            np.testing.assert_array_equal(tv.q.numpy(), jv.q, name)
            np.testing.assert_array_equal(tv.s.numpy().view(np.uint32),
                                          jv.s.view(np.uint32), name)
        else:
            assert tv.dtype == torch.bfloat16 and tv.is_contiguous(), name
            np.testing.assert_array_equal(
                tv.view(torch.int16).numpy().view(np.uint16),
                np.asarray(jv).view(np.uint16), name)


CKPTS = [f"{k}-{n}" for k in ("llama", "qwen2")
         for n in ("F32", "F16", "BF16", "sharded")]


@pytest.mark.parametrize("name", CKPTS)
def test_loaded_params_bit_equal_reference(checkpoints, name):
    path, _ = checkpoints[name]
    if name.endswith("sharded"):
        assert len([f for f in os.listdir(path)
                    if f.endswith(".safetensors")]) == 2
    jspec = jcfg.ModelSpec.from_hf_config(path)
    tspec = tcfg.ModelSpec.from_hf_config(path)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(jspec)
    params = tload(tspec, path, "cpu")
    _assert_tree_bits(jload(jspec, path), params)
    shapes = tmodel.param_shapes(tspec)
    assert ("lm_head" in params) == ("lm_head" in shapes) == \
        name.startswith("llama")
    assert ("bq" in params["layers"]) == name.startswith("qwen2")


@pytest.mark.parametrize("name", ["llama-F32", "qwen2-BF16"])
def test_loaded_int8_params_bit_equal_reference(checkpoints, name):
    path, _ = checkpoints[name]
    jspec = jcfg.ModelSpec.from_hf_config(path)
    tspec = dataclasses.replace(tcfg.ModelSpec.from_hf_config(path),
                                quant="int8")
    _assert_tree_bits(jq.quantize_params(jload(jspec, path)),
                      tload(tspec, path, "cpu"))


# -- safetensors_lite ----------------------------------------------------------

def _sample_tensors():
    rng = np.random.default_rng(3)
    return {
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 2)).astype(np.float32),
        "i8": rng.integers(-128, 128, (7,)).astype(np.int8),
        "u8": rng.integers(0, 256, (2, 2)).astype(np.uint8),
        "i16": rng.integers(-9, 9, (3,)).astype(np.int16),
        "i32": rng.integers(-9, 9, (3,)).astype(np.int32),
        "i64": rng.integers(-9, 9, (2,)).astype(np.int64),
        "bool": np.asarray([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.asarray(2.5, np.float32),
    }


def _np_of(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def test_reads_what_safetensors_writes(tmp_path):
    tensors = _sample_tensors()
    path = tmp_path / "a.safetensors"
    safetensors.numpy.save_file(tensors, str(path), {"format": "pt", "k": "v"})
    with sl.SafeOpen(path) as fh:
        assert sorted(fh.keys()) == sorted(tensors)
        assert fh.metadata() == {"format": "pt", "k": "v"}
    with sl.SafeOpen(path) as fh:
        for name, arr in tensors.items():
            got = fh.get_tensor(name)
            assert got.shape == arr.shape == fh.shape_of(name), name
            np.testing.assert_array_equal(_np_of(got), arr, name)
            del got


def test_safetensors_reads_what_the_port_writes(tmp_path):
    tensors = {k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
               if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v)
               for k, v in _sample_tensors().items()}
    path = tmp_path / "b.safetensors"
    sl.save_file(tensors, path, metadata={"format": "pt"})
    with safetensors.safe_open(str(path), framework="pt") as fh:
        assert fh.metadata() == {"format": "pt"}
        assert sorted(fh.keys()) == sorted(tensors)
        for name, t in tensors.items():
            back = fh.get_tensor(name)
            assert back.dtype == t.dtype and torch.equal(back, t), name
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0 and raw[8 + n - 1:8 + n] in (b" ", b"}")


def test_views_keep_the_mapping_open(tmp_path):
    path = tmp_path / "c.safetensors"
    sl.save_file({"x": torch.arange(6, dtype=torch.float32)}, path)
    fh = sl.SafeOpen(path)
    view = fh.get_tensor("x")
    with pytest.raises(BufferError):
        fh.close()
    assert view.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    del view
    fh.close()


@pytest.mark.parametrize("dtype", ["F64", "F8_E4M3", "F8_E5M2", "BF8"])
def test_unsupported_dtype_raises_naming_it(tmp_path, dtype):
    header = json.dumps({"w": {"dtype": dtype, "shape": [2],
                               "data_offsets": [0, 16]}}).encode()
    path = tmp_path / "d.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header
                     + bytes(16))
    with pytest.raises(ValueError, match=dtype):
        sl.SafeOpen(path)


@pytest.mark.parametrize("cut", ["length", "header", "data"])
def test_truncated_files_raise(tmp_path, cut):
    path = tmp_path / "e.safetensors"
    sl.save_file({"x": torch.ones(64)}, path)
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    keep = {"length": 5, "header": 8 + n // 2, "data": len(raw) - 4}[cut]
    path.write_bytes(raw[:keep])
    with pytest.raises(ValueError, match="truncated"):
        sl.SafeOpen(path)


def test_loader_errors_name_the_cause(checkpoints, tmp_path):
    path, _ = checkpoints["llama-BF16"]
    spec = tcfg.ModelSpec.from_hf_config(path)
    bad = tmp_path / "missing"
    shutil.copytree(path, bad)
    f = next(bad.glob("*.safetensors"))
    tensors = safetensors.numpy.load_file(str(f))
    del tensors["model.layers.1.mlp.up_proj.weight"]
    safetensors.numpy.save_file(tensors, str(f))
    with pytest.raises(KeyError, match="model.layers.1.mlp.up_proj.weight"):
        tload(spec, str(bad), "cpu")
    tensors["model.layers.1.mlp.up_proj.weight"] = np.zeros(
        (352, 128), np.float64)
    safetensors.numpy.save_file(tensors, str(f))
    with pytest.raises(ValueError, match="F64"):
        tload(spec, str(bad), "cpu")
    wrong = dataclasses.replace(spec, intermediate_size=300)
    with pytest.raises(ValueError, match="expected"):
        tload(wrong, path, "cpu")
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        tload(spec, str(tmp_path), "cpu")
    moe = dataclasses.replace(spec, num_experts=4)
    with pytest.raises(NotImplementedError, match="ROADMAP item 14"):
        tload(moe, path, "cpu")


# -- from_hf_config and resolve_model -------------------------------------------

@pytest.mark.parametrize("kind", ["llama", "qwen2", "mixtral"])
def test_from_hf_config_matches_reference(tmp_path, kind):
    if kind == "mixtral":
        cfg = transformers.MixtralConfig(
            vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2)
    else:
        cfg = _hf_config(kind)
    cfg.to_json_file(str(tmp_path / "config.json"))
    for path in (str(tmp_path), str(tmp_path / "config.json")):
        assert dataclasses.asdict(tcfg.ModelSpec.from_hf_config(path)) == \
            dataclasses.asdict(jcfg.ModelSpec.from_hf_config(path))
    spec = tcfg.ModelSpec.from_hf_config(str(tmp_path))
    assert spec.qkv_bias == (kind == "qwen2")
    assert spec.num_experts == (4 if kind == "mixtral" else 0)


@pytest.fixture
def hub_cache(tmp_path, monkeypatch, checkpoints):
    """A HF hub cache holding org/tiny-llama at main and at a commit."""
    import huggingface_hub.constants as hfc
    cache = tmp_path / "hub"
    commit = "0123456789abcdef0123456789abcdef01234567"
    repo = cache / "models--org--tiny-llama"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text(commit)
    snap = repo / "snapshots" / commit
    shutil.copytree(checkpoints["llama-BF16"][0], snap)
    monkeypatch.setenv("HF_HUB_CACHE", str(cache))
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf-home"))
    monkeypatch.setattr(hfc, "HF_HUB_CACHE", str(cache))
    return commit, str(snap)


def _resolve_both(model, revision=None):
    outs = []
    for fn in (lambda: thub.resolve_model(model, revision),
               lambda: jhub.resolve_model(model, revision,
                                          allow_download=False)):
        try:
            spec, path = fn()
            outs.append(("ok", dataclasses.asdict(spec), path))
        except FileNotFoundError as exc:
            outs.append(("FileNotFoundError", str(exc)))
    return outs


def test_resolve_model_matches_reference(hub_cache, checkpoints):
    commit, snap = hub_cache
    local = checkpoints["qwen2-F32"][0]
    for model, rev in (("tiny-test", None), ("llama-3-8b", None),
                       (local, None), ("org/tiny-llama", None),
                       ("org/tiny-llama", "main"), ("org/tiny-llama", commit)):
        port, ref = _resolve_both(model, rev)
        assert port == ref, (model, rev)
        assert port[0] == "ok"
    assert _resolve_both("org/tiny-llama")[0][2] == snap
    port, ref = _resolve_both("org/not-cached")
    assert port == ref and port[0] == "FileNotFoundError"
    assert "not in the local HF cache and downloads are disabled" in port[1]
    assert "hf-home" in port[1]
    port, ref = _resolve_both("org/tiny-llama", "no-such-branch")
    assert port == ref and port[0] == "FileNotFoundError"
    port, ref = _resolve_both(os.path.join(local, "nothing", "here"))
    assert port == ref and port[0] == "FileNotFoundError"
    for bad in ("org/bad--id", "bad id!"):
        port, ref = _resolve_both(bad)
        assert port[0] == ref[0] == "FileNotFoundError", bad
        assert "not a valid hub id" in port[1] and "not a valid hub id" in ref[1]


# -- the logits against transformers --------------------------------------------

def _port_stepwise_logits(spec, params, tokens, n_prefill=16):
    """Teacher-forced logits: a prefill of the first ``n_prefill`` tokens,
    then one decode window stepping through the rest; row i predicts
    tokens[n_prefill + i]."""
    page = 16
    steps = len(tokens) - n_prefill - 1
    shape = (spec.num_layers, spec.num_kv_heads, 8, page, spec.head_dim)
    kc = torch.zeros(shape, dtype=torch.bfloat16)
    vc = torch.zeros(shape, dtype=torch.bfloat16)
    tok = torch.tensor([tokens[:n_prefill]], dtype=torch.int32)
    pos = torch.arange(n_prefill, dtype=torch.int32)[None]
    logits, _, _ = tmodel.prefill_forward(
        params, spec, kc, vc, tok, pos, torch.tensor([[1]], dtype=torch.int32),
        torch.tensor([n_prefill], dtype=torch.int32))
    out = [logits[0]]
    kb = torch.zeros((spec.num_layers, spec.num_kv_heads, 1, steps,
                      spec.head_dim), dtype=torch.bfloat16)
    vb = torch.zeros_like(kb)
    table = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    hist = torch.tensor([n_prefill], dtype=torch.int32)
    for m in range(steps):
        i = n_prefill + m
        logits, k, v = tmodel.decode_window_step(
            params, spec, kc, vc, kb, vb, m,
            torch.tensor([tokens[i]], dtype=torch.int32),
            torch.tensor([i], dtype=torch.int32), table, hist)
        kb[:, :, :, m] = k.transpose(1, 2)
        vb[:, :, :, m] = v.transpose(1, 2)
        out.append(logits[0])
    return torch.stack(out).numpy()


@pytest.mark.parametrize("kind,seeds", [("llama", (0, 1, 2)),
                                        ("qwen2", (3, 4, 5))])
def test_loaded_logits_golden_against_transformers(checkpoints, kind, seeds):
    path, hf_model = checkpoints[f"{kind}-F32"]
    spec = tcfg.ModelSpec.from_hf_config(path)
    params = tload(spec, path, "cpu")
    for seed in seeds:
        prompt = np.random.default_rng(seed).integers(0, VOCAB, 16).tolist()
        with torch.no_grad():
            full = hf_model.generate(torch.tensor([prompt]), max_new_tokens=16,
                                     do_sample=False)[0].tolist()
        assert len(full) == 32
        ours = _port_stepwise_logits(spec, params, full)
        flips = 0
        for i in range(16):
            hf_tok, row = full[16 + i], ours[i]
            if int(np.argmax(row)) == hf_tok:
                continue
            gap = float(np.max(row) - row[hf_tok])
            assert gap < MARGIN, (seed, i, gap)
            flips += 1
        assert flips <= 4, f"{flips}/16 near-tie disagreements"


# -- the entry points ------------------------------------------------------------

def _other_tokenizer_gguf(path) -> str:
    """A GGUF tokenizer of the test vocab with few merges: it encodes the
    same text to more ids than the test tokenizer."""
    spec = json.loads(j_test_tokenizer().to_bytes())["model"]
    tokens = [t for t, _ in sorted(spec["vocab"].items(), key=lambda kv: kv[1])]
    merges = [m if isinstance(m, str) else " ".join(m)
              for m in spec["merges"][:20]]
    gguf.write_metadata(str(path), {"tokenizer.ggml.model": "gpt2",
                                    "tokenizer.ggml.tokens": tokens,
                                    "tokenizer.ggml.merges": merges})
    return str(path)


@pytest.fixture(scope="module")
def served_dir(checkpoints, tmp_path_factory):
    """The BF16 Llama checkpoint with the test tokenizer's tokenizer.json,
    and a second tokenizer as a GGUF file beside it."""
    d = tmp_path_factory.mktemp("served") / "tiny-llama"
    shutil.copytree(checkpoints["llama-BF16"][0], d)
    (d / "tokenizer.json").write_bytes(make_test_tokenizer().to_bytes())
    other = _other_tokenizer_gguf(d.parent / "other.gguf")
    return str(d), other


def test_tokenizer_order_of_each_entry_point(served_dir, tmp_path):
    ckpt, other = served_dir
    text = "hello world this is a test"
    test_ids = make_test_tokenizer().encode(text)
    other_ids = Tokenizer.from_file(other).encode(text)
    assert len(other_ids) > len(test_ids)
    bare = tmp_path / "bare"
    shutil.copytree(ckpt, bare, ignore=shutil.ignore_patterns("tokenizer*"))
    for first, want in ((True, test_ids), (False, other_ids)):
        assert launch.load_tokenizer(ckpt, other, first).encode(text) == want
        assert launch.load_tokenizer(ckpt, None, first).encode(text) == \
            test_ids
        assert launch.load_tokenizer(str(bare), other, first).encode(
            text) == other_ids
        assert launch.load_tokenizer(None, None, first).encode(text) == \
            test_ids
        with pytest.raises(FileNotFoundError, match="tokenizer.json"):
            launch.load_tokenizer(str(bare), None, first)


def test_entry_points_refuse_what_they_cannot_serve(tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty-cache"))
    with pytest.raises(SystemExit, match="not in the local HF cache"):
        launch.build_engine(launch.parse_args(["--model", "org/absent",
                                               "--device", "cpu"]))
    for name, cfg, words in (
            ("moe", transformers.MixtralConfig(
                vocab_size=VOCAB, hidden_size=64, intermediate_size=96,
                num_hidden_layers=1, num_attention_heads=4,
                num_key_value_heads=2, num_local_experts=4), "ROADMAP item 14"),
            ("qpk", transformers.LlamaConfig(
                vocab_size=VOCAB, hidden_size=256, intermediate_size=96,
                num_hidden_layers=1, num_attention_heads=16,
                num_key_value_heads=1), "more than 8 query heads")):
        d = tmp_path / name
        d.mkdir()
        cfg.to_json_file(str(d / "config.json"))
        # No safetensors: the refusal comes before any weight is read.
        with pytest.raises(ValueError, match=words):
            launch.build_engine(launch.parse_args(
                ["--model", str(d), "--device", "cpu", "--num-pages", "8"]))
    assert launch.parse_args(["--quant", "int8"]).quant == "int8"
    with pytest.raises(SystemExit):
        launch.parse_args(["--quant", "int4"])


def _chat(max_tokens=6):
    return chat(messages=[{"role": "user",
                           "content": "hello world this is a test"}],
                max_tokens=max_tokens, ignore_eos=True, stream=True,
                stream_options={"include_usage": True})


def _prompt_tokens(port, model):
    status, ctype, raw = _call(port, "POST", "/v1/chat/completions",
                               dict(_chat(), model=model))
    assert (status, ctype) == (200, "text/event-stream"), raw[:500]
    events = sse_events(raw)
    assert events[-1]["usage"]["completion_tokens"] == 6
    return events[-1]["usage"]["prompt_tokens"]


def test_launcher_and_worker_serve_a_checkpoint_dir(served_dir):
    """Both entry points as processes on the CPU with --model DIR and
    --tokenizer other.gguf: the launcher (with --quant int8) takes the
    checkpoint's tokenizer.json, the worker --tokenizer, which shows in
    the prompt token counts."""
    import time
    ckpt, other = served_dir
    common = ["--model", ckpt, "--device", "cpu", "--num-pages", "64",
              "--tokenizer", other]
    procs = []
    try:
        launcher = Proc("dynamo_tpu_torch.launch", "in=http", "out=gpu",
                        "--http-port", "0", "--quant", "int8", *common)
        coord = Proc("dynamo_tpu_torch.runtime.coordinator", "--host",
                     "127.0.0.1", "--port", "0")
        procs += [launcher, coord]
        url = f"tcp://127.0.0.1:{coord.port('COORDINATOR_READY')}"
        worker = Proc("dynamo_tpu_torch.backends.gpu", "--coordinator-url",
                      url, *common)
        front = Proc("dynamo_tpu_torch.frontend", "--http-host",
                     "127.0.0.1", "--http-port", "0", "--coordinator-url",
                     url)
        procs += [worker, front]
        lport = launcher.port("LAUNCH_READY in=http out=gpu")
        launcher.wait_line("from an engine on cpu")
        worker.wait_line("GPU_WORKER_READY mode=agg")
        worker.wait_line("from an engine on cpu")
        fport = front.port("FRONTEND_READY")
        name = "tiny-llama"
        deadline = time.monotonic() + 60
        while f'"{name}"'.encode() not in _call(fport, "GET",
                                                "/v1/models")[2]:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        via_launcher = _prompt_tokens(lport, name)
        via_worker = _prompt_tokens(fport, name)
        assert via_worker > via_launcher
        for proc in (launcher, worker, front, coord):
            assert proc.stop() == 0, proc.seen[-20:]
    finally:
        for proc in procs:
            proc.kill()
