"""Values of the model code's ``DTensor``-only forms on a real process group.

The dry run walks these forms on ``meta`` stand-ins over a fake group,
which moves no data, so no value of theirs is seen there. Here the same
forms run over a real 2-process ``gloo`` group on the CPU (loopback only),
each against the plain form on the same seeded inputs: the vocab-sharded
lookup (``layers.embed``), unembedding (``layers.logits``' padded-vocab
``where``), cross entropy (its reduction-form log-softmax and ``_pick``'s
masked sum, whole and chunked), ``kernels.ops.sharded_matmul``'s values and
stated gradient placements (column then row parallel, and data parallel),
heads split and merged across shards, ``moe._scatter_last``'s one-hot sum,
``attention.cache_insert`` into a sharded cache, decode attention with its
heads split, the SSM layer's ops on each shard's heads (``ssd_chunked``
with its gradients, ``ssd_decode_step``, ``causal_conv``), and the two
attention variants of the mesh hooks, whose all-reduce and query slices
here move real data.

Run as a script, the file is one rank of that group:
``python tests/test_torch_mesh_forks.py RANK INIT_FILE OUT_JSON``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

WORLD = 2
# f32 on both sides, summed in other orders across the shards: the largest
# difference relative to 1 + the plain form's largest |value|
TOL = 1e-6
FORKS = ("embed", "logits", "cross_entropy", "chunked_softmax_xent", "dense_tp_loss",
         "dense_tp_grad_x", "dense_tp_grad_w1", "dense_tp_grad_w2", "dense_dp_grad_w",
         "split_heads", "merge_heads", "scatter_last", "cache_insert",
         "decode_attention_split_d", "decode_attention_split_d_window",
         "flash_attention_seq_sharded", "flash_attention_seq_sharded_window",
         "decode_attention_heads_split", "ssd_chunked_y", "ssd_chunked_state",
         "ssd_chunked_grad_x", "ssd_chunked_grad_b", "ssd_chunked_grad_a_log",
         "ssd_chunked_dp_grad_a_log",
         "ssd_decode_step_y", "ssd_decode_step_state", "causal_conv", "causal_conv_grad_w")


def _rank_main(rank: int, init_file: str, out: str) -> None:
    """One rank: every fork on a (1, 2) ('data', 'model') mesh (and a (2,)
    'data' mesh for the data-parallel product); rank 0 writes each fork's
    largest difference from the plain form, relative to 1 + the plain
    form's largest |value| (inf where the shapes differ)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    mesh = init_device_mesh("cpu", (1, WORLD), mesh_dim_names=("data", "model"))
    dp = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
    with implicit_replication():  # as the dry run walks its steps
        diffs = _forks(mesh, dp)
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(diffs, fh)
    dist.destroy_process_group()


def _forks(mesh, dp) -> dict[str, float]:
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from repro_torch.models import attention as attn
    from repro_torch.models import layers, moe, ssm

    rng = np.random.default_rng(0)
    R = Replicate()

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def dt(x, pl, m=mesh):
        return distribute_tensor(x, m, pl)

    diffs = {}

    def check(name, got, want):
        got = got.full_tensor() if isinstance(got, DTensor) else got
        diffs[name] = (float((got - want).abs().max() / (1 + want.abs().max()))
                       if got.shape == want.shape else float("inf"))

    vocab, pv, d = 18, 20, 8
    table, x = t(pv, d), t(2, 5, d)
    tokens = torch.from_numpy(rng.integers(0, vocab, (2, 5)))
    labels = torch.from_numpy(rng.integers(0, vocab, (2, 5)))
    table_v = dt(table, [R, Shard(0)])  # vocab-sharded over 'model'
    # the batch's leaves as the dry run lays them out: rows over 'data'
    tokens_d, labels_d = dt(tokens, [Shard(0), R]), dt(labels, [Shard(0), R])
    check("embed", layers.embed(tokens_d, table_v, torch.float32),
          layers.embed(tokens, table, torch.float32))
    lg = layers.logits(dt(x, [R, R]), table_v, vocab)
    check("logits", lg, layers.logits(x, table, vocab))
    check("cross_entropy", layers.cross_entropy(lg, labels_d, vocab),
          layers.cross_entropy(layers.logits(x, table, vocab), labels, vocab))
    check("chunked_softmax_xent",
          layers.chunked_softmax_xent(dt(x, [R, R]), table_v, labels_d, vocab, chunk=5),
          layers.chunked_softmax_xent(x, table, labels, vocab, chunk=5))

    # column- then row-parallel, forward and backward
    w1, w2 = t(d, 12), t(12, d)
    xs = [x.clone().requires_grad_(), dt(x, [R, R]).detach().requires_grad_()]
    ws = [(w1.clone().requires_grad_(), w2.clone().requires_grad_()),
          (dt(w1, [R, Shard(1)]).detach().requires_grad_(),
           dt(w2, [R, Shard(0)]).detach().requires_grad_())]
    losses = []
    for xi, (a, b) in zip(xs, ws):
        y = layers.dense(F.silu(layers.dense(xi, a)), b)
        loss = (y * y).sum()
        loss.backward()
        losses.append(loss)
    check("dense_tp_loss", losses[1], losses[0].detach())
    check("dense_tp_grad_x", xs[1].grad, xs[0].grad)
    check("dense_tp_grad_w1", ws[1][0].grad, ws[0][0].grad)
    check("dense_tp_grad_w2", ws[1][1].grad, ws[0][1].grad)
    # data parallel: x's rows split, w replicated, w's gradient a Partial sum
    w = t(d, 6)
    wp, wd = w.clone().requires_grad_(), dt(w, [R], dp).detach().requires_grad_()
    (layers.dense(x, wp) ** 2).sum().backward()
    (layers.dense(dt(x, [Shard(0)], dp), wd) ** 2).sum().backward()
    check("dense_dp_grad_w", wd.grad, wp.grad)

    h = t(2, 5, 12)
    check("split_heads", layers.split_heads(dt(h, [R, Shard(2)]), 3, 4),
          layers.split_heads(h, 3, 4))
    h4 = t(2, 5, 4, 8)
    check("merge_heads", layers.merge_heads(dt(h4, [R, Shard(3)])), layers.merge_heads(h4))

    probs = torch.softmax(t(2, 5, 6), dim=-1)
    top_g, top_i = torch.topk(probs, 2, dim=-1)
    check("scatter_last",
          moe._scatter_last(dt(probs, [R, R]), dt(top_i, [R, R]), dt(top_g, [R, R])),
          moe._scatter_last(probs, top_i, top_g))

    cache, new = t(2, 10, 2, 8), t(2, 1, 2, 8)
    cache_d = dt(cache, [R, Shard(3)])
    attn.cache_insert(cache_d, dt(new, [R, R]), torch.tensor(3))
    check("cache_insert", cache_d, attn.cache_insert(cache.clone(), new, torch.tensor(3)))

    q, k, v = t(2, 1, 4, 8), t(2, 10, 2, 8), t(2, 10, 2, 8)
    d_pl = [R, Shard(3)]  # the split-d layout: the head dim over 'model'
    for name, window in (("decode_attention_split_d", 0), ("decode_attention_split_d_window", 4)):
        got = attn.decode_attention_split_d(dt(q, d_pl), dt(k, d_pl), dt(v, d_pl),
                                            torch.tensor(7), window=window, mesh=mesh)
        check(name, got, attn.decode_attention(q, k, v, torch.tensor(7), window=window))
    q, k, v = t(2, 8, 4, 8), t(2, 8, 2, 8), t(2, 8, 2, 8)
    for name, window in (("flash_attention_seq_sharded", 0),
                         ("flash_attention_seq_sharded_window", 3)):
        got = attn.flash_attention_seq_sharded(dt(q, [R, R]), dt(k, [R, R]), dt(v, [R, R]),
                                               window=window, mesh=mesh)
        check(name, got, attn.flash_attention(q, k, v, window=window))
    # decode attention with the heads split over 'model' (an MoE decode)
    q, k, v = t(2, 1, 4, 8), t(2, 10, 2, 8), t(2, 10, 2, 8)
    h_pl = [R, Shard(2)]
    check("decode_attention_heads_split",
          attn.decode_attention(dt(q, h_pl), dt(k, h_pl), dt(v, h_pl), torch.tensor(7)),
          attn.decode_attention(q, k, v, torch.tensor(7)))

    # the SSM layer's ops on each shard's heads (channels), b and c whole
    bt, s, h, p, n = 2, 8, 4, 3, 5
    x, dt_, b, c = t(bt, s, h, p), torch.rand(bt, s, h) + 0.1, t(bt, s, n), t(bt, s, n)
    a_log, d_skip = t(h), t(h)
    plain = [x.clone().requires_grad_(), b.clone().requires_grad_(),
             a_log.clone().requires_grad_()]
    dist_ = [dt(x, [R, Shard(2)]).detach().requires_grad_(),
             dt(b, [R, Shard(2)]).detach().requires_grad_(),  # column-parallel in_b
             dt(a_log, [R, Shard(0)]).detach().requires_grad_()]
    outs = []
    for (xi, bi, ai), dt_i, ci, di in ((plain, dt_, c, d_skip),
                                       (dist_, dt(dt_, [R, Shard(2)]), dt(c, [R, R]),
                                        dt(d_skip, [R, Shard(0)]))):
        y, state = ssm.ssd_chunked(xi, dt_i, ai, bi, ci, di, 4)
        (y.to(torch.float32) ** 2).sum().backward()
        outs.append((y, state))
    check("ssd_chunked_y", outs[1][0], outs[0][0].detach())
    check("ssd_chunked_state", outs[1][1], outs[0][1].detach())
    check("ssd_chunked_grad_x", dist_[0].grad, plain[0].grad)
    check("ssd_chunked_grad_b", dist_[1].grad, plain[1].grad)
    check("ssd_chunked_grad_a_log", dist_[2].grad, plain[2].grad)
    # data parallel: the batch rows split, a_log's gradient a Partial sum
    a_dp = dt(a_log, [R], dp).detach().requires_grad_()
    y, _ = ssm.ssd_chunked(dt(x, [Shard(0)], dp), dt(dt_, [Shard(0)], dp), a_dp,
                           dt(b, [Shard(0)], dp), dt(c, [Shard(0)], dp), dt(d_skip, [R], dp), 4)
    (y.to(torch.float32) ** 2).sum().backward()
    check("ssd_chunked_dp_grad_a_log", a_dp.grad, plain[2].grad)
    hs, x1, dt1 = t(bt, h, p, n), t(bt, h, p), torch.rand(bt, h) + 0.1
    b1, c1 = t(bt, n), t(bt, n)
    got = ssm.ssd_decode_step(dt(hs, [R, Shard(1)]), dt(x1, [R, Shard(1)]),
                              dt(dt1, [R, Shard(1)]), dt(a_log, [R, Shard(0)]),
                              dt(b1, [R, R]), dt(c1, [R, R]), dt(d_skip, [R, Shard(0)]))
    want = ssm.ssd_decode_step(hs, x1, dt1, a_log, b1, c1, d_skip)
    check("ssd_decode_step_y", got[0], want[0])
    check("ssd_decode_step_state", got[1], want[1])
    u, w = t(bt, s, 6), t(4, 6)
    wp, wd = w.clone().requires_grad_(), dt(w, [R, Shard(1)]).detach().requires_grad_()
    got = ssm.causal_conv(dt(u, [Shard(0), Shard(2)]), wd)
    want = ssm.causal_conv(u, wp)
    check("causal_conv", got, want.detach())
    (got ** 2).sum().backward()
    (want ** 2).sum().backward()
    check("causal_conv_grad_w", wd.grad, wp.grad)
    return diffs


@pytest.fixture(scope="module")
def fork_diffs(tmp_path_factory):
    """Every fork's difference, from one run of the 2-process group."""
    tmp = tmp_path_factory.mktemp("gloo")
    out = tmp / "diffs.json"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo",
           "PYTHONPATH": os.pathsep.join([os.path.join(root, "src"),
                                          os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(tmp / "init"), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("fork", FORKS)
def test_dtensor_form_equals_the_plain_form(fork, fork_diffs):
    assert fork_diffs[fork] <= TOL, (fork, fork_diffs[fork])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
