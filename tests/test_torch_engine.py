"""The port's serving engine (ray_tpu_torch.llm) against the JAX engine, and
the port's guards: no JAX import, no quiet fall back to the CPU.

Both engines run the same converted weights in f32 on the CPU; greedy
tokens must be identical.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu_torch
from ray_tpu_torch import models as tm
from ray_tpu_torch.convert import params_from_jax
from ray_tpu_torch.llm import (
    EngineConfig,
    SamplingParams,
    TorchLLMEngine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["hello", "a longer prompt than the others", "x", "abc def",
           "zz top", "the quick brown fox"]


def _configs(name):
    if name == "gpt2":
        return (jm.GPT2Config.tiny(vocab_size=384, max_seq=64,
                                   dtype="float32"),
                tm.GPT2Config.tiny(vocab_size=384, max_seq=64,
                                   dtype="float32"))
    return (jm.LlamaConfig.tiny(vocab_size=384, dtype="float32"),
            tm.LlamaConfig.tiny(vocab_size=384, dtype="float32"))


def _engines(name, max_batch_size=2, max_seq_len=64):
    jcfg, tcfg = _configs(name)
    jeng = jllm.JaxLLMEngine(jllm.EngineConfig(
        model=jcfg, max_batch_size=max_batch_size, max_seq_len=max_seq_len))
    tree = jax.tree.map(np.asarray, jeng.params)
    teng = TorchLLMEngine(EngineConfig(
        model=tcfg, max_batch_size=max_batch_size, max_seq_len=max_seq_len,
        param_loader=lambda: params_from_jax(tree, tcfg, device="cpu"),
    ), device="cpu")
    return jeng, teng


@pytest.mark.parametrize("name", ["gpt2", "llama"])
def test_greedy_tokens_match_jax_engine(name):
    """More prompts than slots, so requests join slots mid-run."""
    jeng, teng = _engines(name)
    want = jeng.generate(PROMPTS, jllm.SamplingParams(max_tokens=7))
    got = teng.generate(PROMPTS, SamplingParams(max_tokens=7))
    assert [o["token_ids"] for o in got] == [o["token_ids"] for o in want]
    assert [o["num_generated"] for o in got] == \
        [o["num_generated"] for o in want]
    assert teng.stats.prefills == len(PROMPTS)
    assert teng.stats.tokens == sum(o["num_generated"] for o in got)
    assert not teng.has_unfinished()


def test_generate_stream_matches_jax_engine():
    jeng, teng = _engines("llama")
    for prompt in ("stream me", "b"):
        want = list(jeng.generate_stream(prompt,
                                         jllm.SamplingParams(max_tokens=6)))
        got = list(teng.generate_stream(prompt,
                                        SamplingParams(max_tokens=6)))
        assert "".join(got) == "".join(want)
        assert got == want
    assert not teng.has_unfinished()


def test_kv_cache_matches_full_forward():
    """Port of tests/test_llm.py::test_kv_cache_matches_full_forward: greedy
    decode through the KV cache matches re-running the whole prefix with
    gpt2_apply at every step."""
    _, tcfg = _configs("gpt2")
    engine = TorchLLMEngine(EngineConfig(model=tcfg, max_batch_size=4,
                                         max_seq_len=64), device="cpu")
    tok = engine.tokenizer
    [out] = engine.generate(["abc"], SamplingParams(max_tokens=6))
    ids = list(tok.encode("abc"))
    naive = []
    for _ in range(6):
        logits = tm.gpt2_apply(engine.params, torch.tensor([ids]), tcfg)
        nxt = int(torch.argmax(logits[0, -1]))
        naive.append(nxt)
        ids.append(nxt)
        if nxt == tok.EOS:
            break
    assert out["num_generated"] == len(naive)
    got = out["token_ids"] + (
        [tok.EOS] if out["num_generated"] > len(out["token_ids"]) else []
    )
    assert got == naive


def test_add_request_from_kv_matches_local_prefill():
    """A prompt prefilled outside the engine and handed over as KV pages
    decodes to the same tokens as the engine's own prefill."""
    _, tcfg = _configs("llama")
    engine = TorchLLMEngine(EngineConfig(model=tcfg, max_batch_size=2,
                                         max_seq_len=64), device="cpu")
    sp = SamplingParams(max_tokens=5)
    [want] = engine.generate(["handoff"], sp)
    ids = engine.tokenizer.encode("handoff")
    cache = tm.llama_init_cache(tcfg, 1, len(ids), device="cpu")
    logits, cache = tm.llama_prefill(engine.params, torch.tensor([ids]),
                                     torch.tensor([len(ids)]), cache, tcfg)
    meta = {"prompt_len": len(ids), "first_token": int(logits.argmax()),
            "sampling": sp}
    rid = engine.add_request_from_kv(meta, cache["k"].numpy(),
                                     cache["v"].numpy())
    got = "".join(engine.stream_request(rid))
    assert got == want["text"]


def test_cancel_and_sampling_paths():
    _, tcfg = _configs("gpt2")
    engine = TorchLLMEngine(EngineConfig(model=tcfg, max_batch_size=1,
                                         max_seq_len=64), device="cpu")
    first = engine.add_request("keep", SamplingParams(max_tokens=3))
    dropped = engine.add_request("drop", SamplingParams(max_tokens=3))
    engine.step()
    engine.cancel_request(dropped)
    while engine.has_unfinished():
        engine.step()
    assert first in engine._finished and dropped not in engine._finished
    outs = engine.generate(
        ["x", "y"], SamplingParams(max_tokens=8, temperature=1.0, top_k=5,
                                   top_p=0.9))
    assert all(1 <= o["num_generated"] <= 8 for o in outs)


def test_entry_points_need_a_gpu_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _configs("gpt2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLLMEngine(EngineConfig(model=tcfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.gpt2_init(torch.Generator(), tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.llama_init_cache(tm.LlamaConfig.tiny(), 1, 8)
    assert ray_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_no_jax_and_nothing_of_ray_tpu():
    """Every module of the port (the Serve layer and the OpenAI apps, the
    DAGs, Tune, jobs, the CLI, the dashboard, RLlib's algorithm base,
    DreamerV3 and the devtools among them), and chip_smoke.py, import without JAX or any module of
    the JAX package (checked in a fresh interpreter)."""
    code = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import ray_tpu_torch
# ``__main__`` runs the CLI when imported; ``scripts.cli`` is its code.
names = [m.name for m in pkgutil.walk_packages(ray_tpu_torch.__path__,
                                               "ray_tpu_torch.")
         if m.name != "ray_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
serving = {{"ray_tpu_torch.serve", "ray_tpu_torch.serve.api",
           "ray_tpu_torch.serve.controller", "ray_tpu_torch.serve.handle",
           "ray_tpu_torch.serve.grpc_ingress", "ray_tpu_torch.llm.serve_app",
           "ray_tpu_torch.llm.disagg", "ray_tpu_torch.dag.worker_loop",
           "ray_tpu_torch.tune.tuner", "ray_tpu_torch.job.sdk",
           "ray_tpu_torch.scripts.cli", "ray_tpu_torch.dashboard",
           "ray_tpu_torch.rllib.algorithm", "ray_tpu_torch.rllib.dreamerv3",
           "ray_tpu_torch.devtools.lint", "ray_tpu_torch.devtools.chaos",
           "ray_tpu_torch.devtools.sim_agent", "ray_tpu_torch.llm.tokenizer"}}
assert serving <= set(names), sorted(serving - set(names))
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "ray_tpu" or m.startswith("ray_tpu."))
print(len(names), bad)
assert not bad, bad
""".format(repo=REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 80


def _forbidden_imports(path):
    """Every ``import``/``from ... import`` of jax, jaxlib or ray_tpu (not
    ray_tpu_torch) in ``path``, at any depth: inside function bodies too,
    where importing the module alone never runs them."""
    import ast

    tree = ast.parse(open(path).read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "ray_tpu"):
                found.append(f"{path}:{node.lineno}: {name}")
    return found


def test_port_sources_import_no_jax_or_ray_tpu_at_any_depth():
    """An AST scan of every module of the port, of chip_smoke.py and of
    the port's tools."""
    pkg = os.path.join(REPO, "ray_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "profiler_window.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 20
    bad = [hit for path in sorted(paths) for hit in _forbidden_imports(path)]
    assert not bad, bad


def test_import_scan_finds_imports_in_function_bodies(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import ray_tpu_torch.llm\n"
                   "def f():\n"
                   "    from ray_tpu.util import flight_recorder\n"
                   "    import jax.numpy as jnp\n"
                   "    if True:\n"
                   "        import jaxlib\n"
                   "    from . import sibling\n")
    hits = _forbidden_imports(str(src))
    assert [h.split(": ")[1] for h in hits] == ["ray_tpu.util", "jax.numpy",
                                                "jaxlib"]
