"""The launcher's ``in=batch`` and ``in=text`` inputs in the port
(``python -m dynamo_tpu_torch.launch``) against the JAX launcher's, as
processes on the CPU.

- ``in=batch``: both launchers read the same JSONL (prompts, a messages
  row, a row with its own ``max_tokens``, a malformed line, a line that
  is not an object) over the same weights, a tiny Llama checkpoint
  written with ``transformers`` beside the test tokenizer, greedy. Their
  result rows have the same ``index``, ``text``, ``finish_reason`` and
  ``tokens`` (timings aside), in input order, and error rows in the same
  places; each summary line counts the rows' tokens and errors.
  ``--output-file`` moves the rows and ``--batch-concurrency`` bounds
  them.
- ``in=text``: with stdin piped, the console prints the reference's
  banner, answers each line and exits 0 at the empty line, and at EOF.
- ``in=grpc`` and ``out=dyn`` inputs stay refused.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
import transformers

from dynamo_tpu_torch import launch
from dynamo_tpu_torch.llm.tokenizer import make_test_tokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
BANNER = "dynamo-tpu text console — empty line or EOF exits"

JOBS = [
    {"prompt": "the quick brown fox"},
    {"messages": [{"role": "system", "content": "be terse"},
                  {"role": "user", "content": "hello world"}]},
    "{not json",
    {"prompt": "jumps over the lazy dog", "max_tokens": 3},
    [1, 2, 3],
    {"prompt": "a b c d e f g", "max_tokens": 6},
]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A two-layer Llama checkpoint (vocab 384, above the test
    tokenizer's ids) with the test tokenizer's ``tokenizer.json``."""
    torch.manual_seed(0)
    cfg = transformers.LlamaConfig(
        vocab_size=384, hidden_size=128, intermediate_size=352,
        num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
        max_position_embeddings=2048, rope_theta=10000.0, rms_norm_eps=1e-5,
        tie_word_embeddings=False, attention_bias=False)
    model = transformers.LlamaForCausalLM(cfg).eval().to(torch.bfloat16)
    d = tmp_path_factory.mktemp("ckpt") / "tiny-llama"
    model.save_pretrained(str(d), safe_serialization=True)
    (d / "tokenizer.json").write_bytes(make_test_tokenizer().to_bytes())
    return str(d)


def _write_jobs(path) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        for job in JOBS:
            fh.write((job if isinstance(job, str) else json.dumps(job))
                     + "\n\n")


def _run(package: str, argv: list[str], stdin: str | None = None):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               DTPU_LOG="warning")
    return subprocess.run([sys.executable, "-m", f"{package}.launch", *argv],
                          cwd=ROOT, env=env, input=stdin, text=True,
                          capture_output=True, timeout=TIMEOUT_S)


def _batch(package, out, checkpoint, inp, extra=()):
    argv = ["in=batch", "out=tpu" if package == "dynamo_tpu" else "out=gpu",
            "--model", checkpoint, "--num-pages", "64", "--input-file", inp,
            "--output-file", out, "--batch-max-tokens", "8", *extra]
    if package == "dynamo_tpu_torch":
        argv += ["--device", "cpu"]
    proc = _run(package, argv)
    assert proc.returncode == 0, proc.stderr[-3000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out, encoding="utf-8") as fh:
        rows = [json.loads(line) for line in fh]
    return summary, rows


def test_batch_rows_equal_the_jax_launchers(checkpoint, tmp_path):
    inp = tmp_path / "prompts.jsonl"
    _write_jobs(inp)
    j_summary, j_rows = _batch("dynamo_tpu", str(tmp_path / "j.jsonl"),
                               checkpoint, str(inp))
    t_summary, t_rows = _batch("dynamo_tpu_torch", str(tmp_path / "t.jsonl"),
                               checkpoint, str(inp),
                               ("--batch-concurrency", "2"))
    keys = ("index", "text", "finish_reason", "tokens", "error")
    assert [{k: r.get(k) for k in keys} for r in t_rows] == \
        [{k: r.get(k) for k in keys} for r in j_rows]
    assert [r["index"] for r in t_rows] == list(range(len(JOBS)))
    errors = [r["index"] for r in t_rows if "error" in r]
    assert errors == [2, 4]
    good = [r for r in t_rows if "error" not in r]
    assert [r["tokens"] for r in good] == [8, 8, 3, 6]
    assert all(r["finish_reason"] == "length" for r in good)
    assert all(r["elapsed_s"] >= r["ttft_s"] >= 0 for r in good)
    for summary, rows in ((t_summary, t_rows), (j_summary, j_rows)):
        assert summary["batch_prompts"] == len(JOBS)
        assert summary["errors"] == 2
        assert summary["output_tokens"] == sum(r["tokens"] for r in rows)
    assert t_summary["results"] == str(tmp_path / "t.jsonl")


def test_batch_default_output_file(tmp_path):
    inp = tmp_path / "few.jsonl"
    inp.write_text(json.dumps({"prompt": "hello", "max_tokens": 2}) + "\n")
    proc = _run("dynamo_tpu_torch", [
        "in=batch", "--model", "tiny-test", "--device", "cpu",
        "--num-pages", "16", "--input-file", str(inp)])
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = str(inp) + ".results.jsonl"
    assert json.loads(proc.stdout.strip().splitlines()[-1])["results"] == out
    with open(out, encoding="utf-8") as fh:
        rows = [json.loads(line) for line in fh]
    assert [(r["index"], r["tokens"]) for r in rows] == [(0, 2)]


@pytest.mark.parametrize("stdin,answers", [
    ("hello world\nthe quick brown fox\n\nnever read\n", 2),
    ("hello world", 1),
], ids=["empty-line", "eof"])
def test_text_console_answers_each_line_and_exits(stdin, answers):
    proc = _run("dynamo_tpu_torch", [
        "in=text", "out=gpu", "--model", "tiny-test", "--device", "cpu",
        "--num-pages", "16"], stdin=stdin)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.split("\n")
    assert lines[0] == BANNER
    # One line of answer per prompt line (the test tokenizer decodes few
    # of a random model's ids, so a line may be empty), then nothing.
    assert lines[1:] == lines[1:answers + 1] + [""]


def test_parse_args_of_the_inputs(capsys):
    args = launch.parse_args(["in=batch", "--input-file", "p.jsonl"])
    assert (args.input, args.output, args.batch_concurrency,
            args.batch_max_tokens, args.output_file) == (
        "batch", "gpu", 8, 128, None)
    assert launch.parse_args(["in=text", "out=mocker"]).input == "text"
    for argv, words in ((["in=batch"], "in=batch requires --input-file"),
                        (["in=text", "out=dyn"], "requires a local out="),
                        (["in=grpc"], "ROADMAP item 24 (the KServe gRPC"),
                        (["in=ftp"], "in= must be http|text|batch")):
        with pytest.raises(SystemExit):
            launch.parse_args(argv)
        assert words in capsys.readouterr().err
