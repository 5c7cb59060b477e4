"""Each mix is deterministic in the seed, draws its sizes independently
from the seed, and stays within its stated ranges; the generator's shared
documents and open-loop arrivals follow their parameters."""

import json

import numpy as np
import pytest
from conftest import HERE

from harness.traffic import Mix

MIXES = sorted(p.stem for p in (HERE / "traffic").glob("*.json"))

# mixes the generator can read that no cell sends yet
DOCS = {"loop": "closed", "documents": {"count": 32, "tokens": 1536, "zipf": 1.0},
        "prompt": {"dist": "uniform", "min": 32, "max": 128},
        "output": {"dist": "uniform", "min": 16, "max": 64}, "max_total": 2048}
OPEN = {"loop": "open", "arrival": {"dist": "exponential", "rate_per_s": 2.5}, "ramp_s": 3.0,
        "prompt": {"dist": "lognormal", "median": 300, "sigma": 0.8, "min": 16, "max": 1500},
        "output": {"dist": "lognormal", "median": 100, "sigma": 0.8, "min": 2, "max": 500},
        "max_total": 2048}
INLINE = {"docs": DOCS, "open": OPEN}


def mix(name):
    if name in INLINE:
        return Mix(name, INLINE[name])
    return Mix(name, json.loads((HERE / "traffic" / f"{name}.json").read_text()))


def draw(m, seed, n, vocab=49152):
    s = m.stream(seed, vocab)
    return [s.next() for _ in range(n)], s


@pytest.mark.parametrize("name", MIXES + sorted(INLINE))
def test_same_seed_same_requests(name):
    m = mix(name)
    a, sa = draw(m, 2**31 + 7, 100)
    b, sb = draw(m, 2**31 + 7, 100)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt) and x.output_len == y.output_len and x.due == y.due
    assert sa.residuals(16) == sb.residuals(16)


@pytest.mark.parametrize("name", MIXES + sorted(INLINE))
def test_seeds_draw_their_own_sizes(name):
    m = mix(name)
    a, _ = draw(m, 1, 64)
    b, _ = draw(m, 2**40 + 3, 64)
    sizes = lambda rs: sorted((len(r.prompt), r.output_len) for r in rs)
    assert sizes(a) != sizes(b)


@pytest.mark.parametrize("name", MIXES + sorted(INLINE))
def test_within_ranges(name):
    m = mix(name)
    p = m.p
    reqs, stream = draw(m, -5, 400, vocab=1000)
    doc = int(p["documents"]["tokens"]) if "documents" in p else 0
    lo, hi = m.prompt_range()
    for r in reqs:
        ask = len(r.prompt) - doc
        assert p["prompt"]["min"] <= ask <= p["prompt"]["max"] and lo <= len(r.prompt) <= hi
        assert 1 <= r.output_len <= p["output"]["max"]
        assert len(r.prompt) + r.output_len <= p["max_total"]
        assert r.prompt.min() >= 0 and r.prompt.max() < 1000
        assert r.shared_len == doc
        if doc:
            assert any(np.array_equal(r.prompt[:doc], d) for d in stream.documents)
    assert all(0.0 < f <= 1.0 for f in stream.residuals(64))


def test_chat_lengths_follow_the_source():
    """The chat mix's medians are the trace's (prompt 1020, output 129),
    prompts several times the answers, and the 2048-token context cuts
    about 8% of prompts to 2032."""
    reqs, _ = draw(mix("chat"), 2**33 + 1, 4000)
    prompts = np.array([len(r.prompt) for r in reqs])
    outs = np.array([r.output_len for r in reqs])
    assert np.median(prompts) == pytest.approx(1020, rel=0.04)
    assert np.median(outs[prompts <= 1024]) == pytest.approx(129, rel=0.08)  # uncut
    assert np.median(outs) < 129  # the context's cut shortens outputs of long prompts
    assert np.mean(prompts) > 4 * np.mean(outs)
    assert np.mean(prompts == 2032) == pytest.approx(0.084, abs=0.015)
    assert outs.max() > 4 * np.median(outs)  # a heavy tail
    assert np.all(prompts + outs <= 2048)


def test_document_popularity_is_zipf():
    reqs, stream = draw(mix("docs"), 3, 4000)
    first = stream.documents[0]
    share = np.mean([np.array_equal(r.prompt[:1536], first) for r in reqs])
    assert share == pytest.approx(1 / 4.06, abs=0.03)  # 1 / H(32)


def test_open_arrivals_are_poisson():
    reqs, _ = draw(mix("open"), 9, 2000)
    gaps = np.diff([r.due for r in reqs])
    assert np.all(gaps > 0)
    assert np.mean(gaps) == pytest.approx(1 / 2.5, rel=0.08)
    assert np.std(gaps) == pytest.approx(np.mean(gaps), rel=0.1)  # exponential: cv 1

