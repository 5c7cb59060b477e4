"""Whether what the timed path served is correct.

Once the window has closed, a sample of the requests it finished, drawn
from the seed and with the longest of them in it, is run through the plain
reference (``reference/lm.py``), once over each prompt with its served
tokens. Each served token is greedy, so it should be the reference's best
next token up to rounding; the number compared is the widest gap by which a
served token's reference logit lies below the reference's best at its
position (``max_logit_gap``). Its limit is the cell's, in
``portbench/cells/<cell>.json``, set from the program's readings over a
dozen seeds and from the control's (``tools/control.py``).

The control is the reference in float8 (``Model(mode="fp8")``): at each
position of the same prompts and tokens, the gap of the token it puts
first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from harness.traffic import seed_words
from reference.lm import Model, no_tf32


@dataclasses.dataclass
class Sampled:
    rid: int
    prompt: np.ndarray
    output: list[int]


def sample(finished: list[tuple[int, np.ndarray, list[int]]], seed: int,
           min_tokens: int, max_requests: int) -> list[Sampled]:
    """The longest finished request (prompt plus output), then others in a
    seeded order until ``min_tokens`` served tokens or ``max_requests``."""
    if not finished:
        return []
    items = sorted(finished, key=lambda f: f[0])
    longest = max(items, key=lambda f: (len(f[1]) + len(f[2]), -f[0]))
    rest = [f for f in items if f[0] != longest[0]]
    order = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 4))).permutation(len(rest))
    picked = [longest]
    tokens = len(longest[2])
    for i in order:
        if tokens >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        tokens += len(rest[i][2])
    return [Sampled(*f) for f in picked]


def _sequence(s: Sampled, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tokens the reference reads (the prompt and every served token but
    the last), the positions whose next token was served, and those tokens."""
    p = len(s.prompt)
    seq = np.concatenate([s.prompt, np.asarray(s.output[:-1], np.int32)]).astype(np.int64)
    rows = torch.arange(p - 1, p - 1 + len(s.output), device=device)
    return torch.from_numpy(seq).to(device), rows, torch.tensor(s.output, device=device)


def _gap(ref: torch.Tensor, picked: torch.Tensor) -> torch.Tensor:
    """Per position: the reference's best logit minus its logit of ``picked``."""
    return ref.max(dim=-1).values - ref.gather(1, picked[:, None].long())[:, 0]


def served_gaps(config: dict, weights: dict, picked: list[Sampled], device,
                control: bool = False) -> dict:
    """The widest gap of the served tokens (and, with ``control``, of the
    float8 control's first choices) over the sampled requests."""
    ref = Model(config, weights, "f32")
    ctl = Model(config, weights, "fp8") if control else None
    served, ctl_gap, n = 0.0, 0.0, 0
    with torch.no_grad(), no_tf32():
        for s in picked:
            seq, rows, out = _sequence(s, device)
            logits = ref.logits(seq, rows)
            served = max(served, float(_gap(logits, out).max()))
            n += len(s.output)
            if ctl is not None:
                choice = ctl.logits(seq, rows).argmax(dim=-1)
                ctl_gap = max(ctl_gap, float(_gap(logits, choice).max()))
            del logits
    out = {"max_logit_gap": served, "tokens_compared": n, "requests_compared": len(picked)}
    if control:
        out["control_max_logit_gap"] = ctl_gap
    return out
