"""Prompt tokens served from cached blocks over all prompt tokens admitted
in the window (window deltas of ``prefix_hit_tokens`` and
``prefill_tokens``)."""


def read(run):
    c = run.window.counters
    total = c["prefix_hit_tokens"] + c["prefill_tokens"]
    return 100.0 * c["prefix_hit_tokens"] / total if total else None
