"""``PrefillEngine``'s captured prefills against its eager ones, on a card.

For each model, one ``PrefillEngine`` (every prompt-length bucket captured
in its constructor), then at each bucket's edges, a prompt that fills the
bucket and one just past the bucket below (the most padding):

- the graph's logits and K/V pages against the same padded prefill run
  eagerly over the engine's static inputs (the same kernels: held at
  ``TOL``), and against the unpadded prefill over a cache of the prompt's
  own length, as ``PrefillEngine`` ran before its buckets (reported, with
  whether the greedy first token agrees);
- each bucket's replay and its eager padded prefill, timed by CUDA events
  on an idle card.

Prints each bucket's ``capture_s``, the largest differences, the times
and the engine's graph share, one JSON line a model, and the card's name
and power limit:

    python3 tools/prefill_graphs.py                 # GPT-2-large, TinyLlama
    python3 tools/prefill_graphs.py gpt2-large      # one of them
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

TOL = 2e-2  # bf16, as chip_smoke.py holds its kernels
ITERS = 10


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _models():
    from ray_tpu_torch.models import GPT2Config, LlamaConfig

    # GPT-2-large as the benchmark serves it (vocab padded to 50304), and
    # the TinyLlama shape chip_smoke.py serves (GQA, rotary positions).
    return {
        "gpt2-large": (GPT2Config(vocab_size=50304, max_seq=1024, n_layer=36,
                                  n_head=20, d_model=1280, dtype="bfloat16",
                                  attention="flash"), 1024),
        "tinyllama": (LlamaConfig.tinyllama_1b(attention="flash"), 2048),
    }


def _event_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check(name: str, cfg, max_seq_len: int) -> dict:
    import torch

    from ray_tpu_torch.llm import EngineConfig, PrefillEngine

    t0 = time.perf_counter()
    eng = PrefillEngine(EngineConfig(model=cfg, max_seq_len=max_seq_len,
                                     seed=0), device="cuda")
    made_s = time.perf_counter() - t0
    fam, gen = eng.family, torch.Generator().manual_seed(1)
    rows, problems = [], []
    below = 0
    for b in eng.buckets:
        for n in sorted({below + 1, b}):
            ids = torch.randint(0, cfg.vocab_size, (n,), generator=gen)
            logits, _, k, v, bucket = eng.run_ids(ids.tolist())
            eager = eng._run(b)  # the same padded prefill, eagerly
            cache = fam.init_cache(cfg, 1, n, eng.device)
            plain, cache = fam.prefill(
                eng.params, ids[None].to(eng.device),
                torch.tensor([n], device=eng.device), cache, cfg)
            row = {"bucket": bucket, "n": n,
                   "vs_eager_padded": {
                       "logits": _err(logits, eager),
                       "k": _err(k, eng._cache["k"][:, :, :, :n]),
                       "v": _err(v, eng._cache["v"][:, :, :, :n])},
                   "vs_unpadded": {
                       "logits": _err(logits, plain),
                       "k": _err(k, cache["k"]), "v": _err(v, cache["v"]),
                       "logits_scale": float(plain.abs().max()),
                       "same_first_token": bool(
                           logits.argmax() == plain.argmax())}}
            if bucket != b:
                problems.append(f"n={n} ran in bucket {bucket}, not {b}")
            if not all(torch.allclose(x.float(), y.float(), atol=TOL,
                                      rtol=TOL) for x, y in (
                    (logits, eager),
                    (k, eng._cache["k"][:, :, :, :n]),
                    (v, eng._cache["v"][:, :, :, :n]))):
                problems.append(f"n={n}: graph and eager padded differ: "
                                f"{row['vs_eager_padded']}")
            rows.append(row)
        below = b
    graph, times = eng._graphs, {}
    for b in eng.buckets:
        eng._inputs[0] = b  # a length inside the bucket
        times[b] = {"replay_ms": _event_ms(graph[b].replay),
                    "eager_ms": _event_ms(lambda: eng._run(b))}
    st = eng.stats()
    ran = st["graph_prefills"] + st["eager_prefills"]
    rep = {"model": name, "max_seq_len": max_seq_len,
           "buckets": eng.buckets, "capture_s": st["capture_s"],
           "capture_s_total": sum(st["capture_s"].values()),
           "engine_made_s": made_s,
           "static_cache_bytes": 2 * eng._cache["k"].numel()
           * eng._cache["k"].element_size(),
           "graph_share": st["graph_prefills"] / ran, "stats": st,
           "times": times, "rows": rows,
           "max_vs_eager_padded": max(max(r["vs_eager_padded"].values())
                                      for r in rows),
           "max_vs_unpadded_logits": max(r["vs_unpadded"]["logits"]
                                         for r in rows),
           "first_token_agrees": sum(r["vs_unpadded"]["same_first_token"]
                                     for r in rows),
           "prompts": len(rows), "problems": problems}
    del eng, graph
    torch.cuda.empty_cache()
    return rep


def main(argv) -> int:
    from ray_tpu_torch.ops import _build

    print("card", _card(), flush=True)
    _build.build()
    models = _models()
    failed = False
    for name in argv or list(models):
        rep = check(name, *models[name])
        print("prefill graphs " + json.dumps(rep), flush=True)
        failed = failed or bool(rep["problems"]) or rep["graph_share"] != 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
