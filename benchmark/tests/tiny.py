"""Tiny cells for the CPU tests: the real files' keys, shrunk widths."""

from benchmark import harness


def serve_cell(limit: float = 0.05, vocab: int = 500, **mix_overrides):
    cfg = harness.load_json(harness.HERE / "configs" / "gpt2-large.json")
    cfg = dict(cfg, n_layer=4, n_embd=256, n_head=4, n_ctx=256,
               vocab_size=vocab,
               assumed=dict(cfg["assumed"],
                            padded_vocab_size=-(-vocab // 64) * 64))
    mix = harness.load_json(harness.HERE / "traffic" / "serve-decode.json")
    mix = dict(mix, rate_per_s=4.0,
               prompt_tokens={"dist": "lognormal", "median": 16,
                              "sigma": 0.3, "min": 8, "max": 24},
               output_tokens={"dist": "lognormal", "median": 48,
                              "sigma": 0.4, "min": 8, "max": 100},
               engine={"max_batch_size": 8, "max_seq_len": 128},
               check_requests=8, trace_from=0.25, trace_seconds=1.0,
               **mix_overrides)
    return _cell("tiny.serve", cfg, mix, {"max_logit_gap": limit},
                 ["serve_tokens_per_s", "setup_s"],
                 ["prefill.ms_p50", "cb.occupancy", "decode.step_ms",
                  "serve.mfu", "device.idle.serve",
                  "flash_fwd.roofline.serve", "decode_attn.roofline.serve",
                  "router.ttft_p95_ms", "router.tpot_p95_ms"])


UNITS = {"serve_tokens_per_s": "tokens/s", "router.ttft_p95_ms": "ms",
         "router.tpot_p95_ms": "ms", "setup_s": "s", "prefill.ms_p50": "ms",
         "cb.occupancy": "slots", "decode.step_ms": "ms"}


def _cell(name, cfg, mix, limits, e2e, per_layer):
    units = {n: UNITS.get(n, "%") for n in e2e + per_layer}
    return {"name": name, "chips": 1, "config": cfg, "traffic": mix,
            "limits": limits,
            "end_to_end": [{"name": n, "unit": units[n]} for n in e2e],
            "per_layer": [{"name": n, "unit": units[n]}
                          for n in per_layer]}
