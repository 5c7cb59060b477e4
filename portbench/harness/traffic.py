"""The one traffic generator: it reads a mix's parameters from
``portbench/traffic/<name>.json`` and turns them, with the run's seed, into
requests.

Every request's sizes are drawn independently from the run's seed: its
prompt and output lengths, its document (when the mix shares documents)
and, in an open loop, the gap to the next arrival. Token ids are drawn
from the seed too, uniform over the vocabulary.

Keys of a mix file:

- ``loop``: ``closed`` (one client per lane; a client sends its next
  request once it sees its last one complete) or ``open`` (arrivals at
  ``rate_per_s``, whatever completes).
- ``prompt``, ``output``: a length distribution, ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` (rounded, then clipped to the ends)
  or ``{"dist": "uniform", "min", "max"}`` (integers, both ends
  included). With ``documents`` the prompt is the question that follows
  the document.
- ``max_total``: the most tokens of prompt plus output (the served
  context); an output that would pass it is cut to fit.
- ``documents`` (optional): ``{"count", "tokens", "zipf"}``: each request
  starts with one of ``count`` documents of ``tokens`` tokens, picked with
  Zipf(``zipf``) popularity.
- ``arrival`` (open loop): ``{"dist": "exponential", "rate_per_s"}``.
- ``ramp_s`` (open loop): seconds of arrivals before the window opens.

Other keys (``why``, ``source``, ``assumed``) document the mix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SEED_MASK = 2**64 - 1


def seed_words(seed: int, *salt: int) -> list[int]:
    """A SeedSequence entropy list for any whole seed (negative or past 64
    bits included), salted for one purpose."""
    s = seed & SEED_MASK
    return [s & 0xFFFFFFFF, s >> 32, *salt]


def draw_length(dist: dict, rng: np.random.Generator) -> int:
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "lognormal":
        v = float(dist["median"]) * np.exp(float(dist["sigma"]) * rng.standard_normal())
        return int(min(hi, max(lo, round(v))))
    if dist["dist"] == "uniform":
        return int(rng.integers(lo, hi + 1))
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


@dataclasses.dataclass
class Request:
    """One generated request: its tokens, and the tokens it shares with
    other requests at its start (a document)."""

    index: int
    prompt: np.ndarray  # int32
    output_len: int
    shared_len: int
    due: float = 0.0  # open loop: seconds after the stream's start


class Mix:
    """A traffic mix: its parameters."""

    def __init__(self, name: str, params: dict):
        self.name = name
        self.p = params
        self.loop = params["loop"]
        if self.loop not in ("closed", "open"):
            raise ValueError(f"mix {name}: loop must be closed or open")
        if self.loop == "open" and params["arrival"]["dist"] != "exponential":
            raise ValueError(f"unknown arrival distribution {params['arrival']['dist']!r}")
        self.docs = params.get("documents")
        if self.prompt_range()[1] >= int(params["max_total"]):
            raise ValueError(f"mix {name}: its longest prompt leaves no output")

    @property
    def rate_per_s(self) -> float:
        return float(self.p["arrival"]["rate_per_s"])

    @property
    def ramp_s(self) -> float:
        return float(self.p.get("ramp_s", 0.0))

    def prompt_range(self) -> tuple[int, int]:
        """The shortest and the longest prompt the mix can send, document
        included."""
        doc = int(self.docs["tokens"]) if self.docs else 0
        return doc + int(self.p["prompt"]["min"]), doc + int(self.p["prompt"]["max"])

    def stream(self, seed: int, vocab: int) -> "Stream":
        return Stream(self, seed, vocab)


class Stream:
    """The requests of one run, in order, each drawn from the seed."""

    def __init__(self, mix: Mix, seed: int, vocab: int):
        self.mix = mix
        self.vocab = vocab
        self._sizes = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 1)))
        self._tokens = np.random.default_rng(np.random.SeedSequence(seed_words(seed, 2)))
        docs = mix.docs
        self.documents = (
            [self._tokens.integers(0, vocab, int(docs["tokens"]), dtype=np.int64).astype(np.int32)
             for _ in range(int(docs["count"]))] if docs else []
        )
        if docs:
            w = 1.0 / np.arange(1, int(docs["count"]) + 1) ** float(docs["zipf"])
            self._popularity = w / w.sum()
        self._count = 0
        self._clock = 0.0

    def next(self) -> Request:
        p, rng = self.mix.p, self._sizes
        ask = draw_length(p["prompt"], rng)
        out = draw_length(p["output"], rng)
        doc = np.zeros(0, np.int32)
        if self.documents:
            doc = self.documents[int(rng.choice(len(self.documents), p=self._popularity))]
        gap = rng.exponential(1.0 / self.mix.rate_per_s) if self.mix.loop == "open" else 0.0
        tokens = self._tokens.integers(0, self.vocab, ask, dtype=np.int64).astype(np.int32)
        prompt = np.concatenate([doc, tokens])
        out = min(out, int(p["max_total"]) - len(prompt))
        req = Request(self._count, prompt, out, len(doc), self._clock)
        self._clock += gap
        self._count += 1
        return req

    def residuals(self, n: int) -> list[float]:
        """Fractions, uniform on (0, 1) from the seed: how much of its
        output each of a closed loop's first requests still has to make,
        so that the clients start spread over their requests' lives."""
        return [float(f) for f in 1.0 - self._sizes.random(n)]
