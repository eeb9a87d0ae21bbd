"""Plain GPT-2 in PyTorch, written from the published description
(Radford et al. 2019, "Language Models are Unsupervised Multitask
Learners", and the released ``config.json``): learned token and position
embeddings, pre-LN blocks (causal multi-head self-attention, then an MLP of
width 4E with the tanh GELU, each added to the residual), a final layer
norm, and the unembedding tied to the token table.

It computes in float32 with TF32 off, with no kernel, cache or batching of
the program's, and imports nothing of the program.  ``precision="fp8"``
runs the same arithmetic with every projection's inputs (activations and
weights) rounded to float8 e4m3 with one scale a tensor, the control that
has to come out as not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def strict_f32() -> None:
    """No TF32 in float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (its largest magnitude
    onto 448), back in float32; the gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


class GPT2Reference:
    """Float32 GPT-2 over ``weights`` (flat ``{name: tensor}``, the
    benchmark's layout), on ``device``."""

    def __init__(self, weights: Dict[str, torch.Tensor], n_head: int,
                 precision: str = "f32", requires_grad: bool = False):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        strict_f32()
        self.precision = precision
        self.n_head = n_head
        self.w = {k: v.detach().to(torch.float32).clone()
                  .requires_grad_(requires_grad) for k, v in weights.items()}
        self.n_layer = self.w["wqkv"].shape[0]

    def _mm(self, x, w):
        if self.precision == "fp8":
            x, w = _fp8(x), _fp8(w)
        return x @ w

    def _ln(self, x, g, b):
        return F.layer_norm(x, (x.shape[-1],), g, b, eps=1e-5)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] → final layer-normed hidden states [B, S, E]."""
        w = self.w
        bsz, s = tokens.shape
        e = w["wte"].shape[1]
        h, d = self.n_head, e // self.n_head
        x = w["wte"][tokens] + w["wpe"][:s][None]
        mask = torch.ones(s, s, dtype=torch.bool,
                          device=x.device).tril()
        for l in range(self.n_layer):
            a = self._ln(x, w["ln1_g"][l], w["ln1_b"][l])
            qkv = self._mm(a, w["wqkv"][l].reshape(e, 3 * e)) \
                + w["bqkv"][l].reshape(3 * e)
            q, k, v = qkv.view(bsz, s, 3, h, d).unbind(2)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
            scores = (q @ k.transpose(-1, -2)) / math.sqrt(d)
            scores = scores.masked_fill(~mask, float("-inf"))
            o = (scores.softmax(-1) @ v).transpose(1, 2).reshape(bsz, s, e)
            x = x + self._mm(o, w["wo"][l].reshape(e, e)) + w["bo"][l]
            m = self._ln(x, w["ln2_g"][l], w["ln2_b"][l])
            u = F.gelu(self._mm(m, w["wi"][l]) + w["bi"][l],
                       approximate="tanh")
            x = x + self._mm(u, w["wo2"][l]) + w["bo2"][l]
        return self._ln(x, w["lnf_g"], w["lnf_b"])

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] → next-token logits [B, S, V] (float32)."""
        return self._mm(self.hidden(tokens), self.w["wte"].t())


@torch.no_grad()
def served_gaps(ref: GPT2Reference, token_ids: List[int], prompt_len: int,
                pick: Optional[GPT2Reference] = None) -> torch.Tensor:
    """For each served token of one request (``token_ids`` = prompt then
    served tokens): how far the reference's logit of the token served lies
    below the reference's best.  With ``pick``, the token judged at each
    position is ``pick``'s first choice instead of the one served (the
    control: a lower precision's greedy choice on the same prefix)."""
    tokens = torch.tensor([token_ids[:-1]], dtype=torch.long,
                          device=ref.w["wte"].device)
    logits = ref.logits(tokens)[0, prompt_len - 1:]
    if pick is None:
        chosen = tokens.new_tensor(token_ids[prompt_len:])
    else:
        chosen = pick.logits(tokens)[0, prompt_len - 1:].argmax(-1)
    best = logits.max(-1).values
    return best - logits.gather(-1, chosen[:, None])[:, 0]

