"""The whole step's share of the card's bf16 peak: the model FLOPs of the
tokens computed inside the window (prompt tokens the cache did not serve,
and decode tokens: 2 x the matmul weights a token takes, the unembedding
included, plus QK and PV at each token's context), over the window's
seconds x 989 TFLOP/s (``work/``), the profiler's start and stop in a
traced run left out of them."""

from work.flops import matmul_params, span_attention_flops
from work.peaks import H100_SXM


def read(run):
    w, c = run.window, run.config
    block = int(c["engine"]["block_tokens"])
    decode_tokens = w.emitted - len(w.first_tokens)
    flops = 2 * matmul_params(c) * (w.counters["prefill_tokens"] + decode_tokens)
    for rid, s in w.served.items():
        a, b = s.out_at_open, w.out_at_close[rid]
        # the decode step that makes output j reads position prompt + j - 1
        flops += span_attention_flops(c, s.prompt_len + max(a, 1) - 1, s.prompt_len + b - 1)
        if s.t_first and w.in_window(s.t_first):
            cached = min(s.shared_len // block * block, s.prompt_len - 1)
            flops += span_attention_flops(c, cached, s.prompt_len)
    return 100.0 * flops / (w.active_seconds * H100_SXM["bf16_flops"])
