"""Speculative decoding over the paged KV pool: drafters and resolution.

Port of ``repro.runtime.speculative`` for dense, vlm and MoE targets.
Decode re-reads the whole weight set to emit one token per lane. Speculate-and-verify buys
some of that back: a cheap drafter proposes a depth-``k`` chain per decode
lane, and the target scores every chain position in one batched call
(``lm.verify_chunk_paged``), accepting the longest prefix whose sampled
tokens match the proposals. A verify step yields 1 to ``k`` tokens.

The paper's packing supplies a drafter: the FCMP-packed 1/2-bit twin of a
dense arch keeps its attention weights and swaps the FFN matrices for
packed carriers. The self-drafting n-gram drafter is a suffix-match lookup
over the request's own prompt and output, with no model cost.

Token identity is structural: the verifier samples position ``m`` from the
target's own logits with the same (seed, rid, m)-keyed rng that plain
decode uses, and a position's logits depend only on accepted (identical)
earlier tokens. The drafter moves the acceptance rate, never the output.

Drafter eligibility, as in the reference::

    target family   model drafter (packed twin)   ngram drafter
    dense           yes                           yes
    vlm             yes                           yes
    moe             foreign dense arch only       yes
                    (experts never pack: no twin)

Compiled steps: on a CUDA scheduler the model drafter's decode step (one
graph over its static row table) and its prompt prefill (one graph at
``(1, max_len)``) run as ``runtime.steps.CapturedStep`` graphs in the
scheduler's memory pool (``Speculator.use_graphs``); on the CPU they run
eagerly.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.models import lm
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.runtime.steps import (
    CapturedStep,
    make_paged_serve_step,
    make_pool_prefill_step,
)

# families verify_chunk_paged serves (the reference's)
SPEC_FAMILIES = ("dense", "vlm", "moe")
# families whose FFN leaves pack into FCMP carriers -> model drafters
MODEL_DRAFT_FAMILIES = ("dense", "vlm")

NGRAM = "ngram"


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """CLI-level speculative knobs (``--speculate`` / ``--spec-depth`` /
    ``--spec-quant``). ``drafter`` is ``"ngram"`` or a canonical arch id;
    ``quant`` is the packed-carrier width of a model drafter (the twin's
    ``w_bits``)."""

    drafter: str
    depth: int = 4
    quant: int = 2


@dataclasses.dataclass(frozen=True)
class LaneDraft:
    """One decode lane's view, handed to the drafter each verify cycle."""

    slot: int
    rid: int
    pending: int  # last sampled token, not yet fed to the target
    out_len: int  # len(request.output): the next sample's rng position
    n_rows: int  # KV rows the target pool holds for this request
    history: np.ndarray  # prompt + output so far (pending included)


def _sample_keyed(row, sp: lm.SamplingParams, rid: int, pos: int) -> int:
    """The scheduler's (seed, rid, position)-keyed sampler, shared so a
    model drafter's proposals use the exact rng the verifier will."""
    rng = np.random.default_rng(np.random.SeedSequence([sp.seed, rid, pos]))
    return int(lm.sample_logits(row, sp, rng))


# --------------------------------------------------------------------------
# Drafter twins: FFN packing / dequantization
# --------------------------------------------------------------------------


def pack_ffn_params(params: lm.LMParams, bits: int) -> lm.LMParams:
    """The packed twin of a dense param set: FFN leaves swapped for FCMP
    carriers (``lm.pack_ffn``, on the host a layer at a time), the other
    leaves shared. Already-packed leaves (a quantized target) pass
    through."""
    tree = params.tree()
    tree["layers"] = {
        name: lm.pack_ffn(leaf, bits)
        if name in lm.FFN_LEAVES and not isinstance(leaf, dict)
        else leaf
        for name, leaf in tree["layers"].items()
    }
    return lm.LMParams(tree)


def dequantize_ffn_params(params: lm.LMParams, bits: int) -> lm.LMParams:
    """The dense counterpart of a packed twin: FFN leaves replaced by their
    decoded carrier values, so ``pack_ffn_params`` of the result round-trips
    its codes (quantization is idempotent on its own codebook). A dense
    leaf is packed first (``lm.pack_ffn``) and keeps its dtype; a packed
    leaf decodes to f32, as in the reference. Random weights have no
    trained drafter/target correlation, so this pairing (a dequantized
    target and its re-packed twin) is how a twin is served at high
    acceptance."""

    def dequant(w):
        p = w if isinstance(w, dict) else lm.pack_ffn(w, bits)
        codes = lm._unpack_codes(p["packed"], bits).to(torch.float32)
        vals = codes * 2.0 - 1.0 if bits == 1 else codes - 1.0
        out = vals * p["scale"][..., None, :]
        return out if isinstance(w, dict) else out.to(w.dtype)

    tree = params.tree()
    tree["layers"] = {
        name: dequant(leaf) if name in lm.FFN_LEAVES else leaf
        for name, leaf in tree["layers"].items()
    }
    return lm.LMParams(tree)


# --------------------------------------------------------------------------
# Resolution: --speculate <drafter> against a target config
# --------------------------------------------------------------------------


def compatible_drafters(cfg: ModelConfig, *, smoke: bool = False) -> list[str]:
    """Drafter names servable against ``cfg``: ``ngram`` plus every ported
    arch of a packable family whose vocab matches the target (logit rows
    must index the same token space)."""
    from repro_torch import configs

    out = [NGRAM]
    for arch in configs.ARCH_IDS:
        try:
            dcfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
        except ValueError:
            continue
        if dcfg.family in MODEL_DRAFT_FAMILIES and dcfg.vocab == cfg.vocab:
            out.append(arch)
    return out


@dataclasses.dataclass(frozen=True)
class ResolvedSpec:
    """A validated drafter choice for one target config.

    ``draft_cfg`` is the serving-size drafter config (None for ngram);
    ``draft_full_cfg`` the full-size one, which a fleet engine's virtual
    clock charges (``runtime.cluster.engine.StepCostModel.for_config``: a
    packed twin's FFN bytes are discounted there); ``twin`` marks a drafter
    of the target's own arch, built by packing the served params rather
    than drawing fresh ones."""

    spec: SpecConfig
    draft_cfg: ModelConfig | None
    draft_full_cfg: ModelConfig | None
    twin: bool

    def build(
        self,
        cfg: ModelConfig,
        params: lm.LMParams,
        *,
        slots: int,
        max_len: int,
        draft_params: lm.LMParams | None = None,
    ) -> "Speculator":
        """Per-engine drafter state. A foreign arch drafts with
        ``draft_params`` where given (the tests pass the reference's
        ``init_params(dcfg, key(0))`` draw), else with the port's seeded
        ``init_params(dcfg, 0)``: the acceptance may then differ from the
        reference's, the output may not."""
        if self.draft_cfg is None:
            return Speculator(NgramDrafter(), depth=self.spec.depth)
        if self.twin:
            dparams = pack_ffn_params(params, self.draft_cfg.w_bits)
        elif draft_params is not None:
            dparams = draft_params
        else:
            dparams = lm.init_params(self.draft_cfg, 0, device=params["embed"].device)
        drafter = ModelDrafter(self.draft_cfg, dparams, slots=slots, max_len=max_len)
        return Speculator(drafter, depth=self.spec.depth)


def resolve(cfg: ModelConfig, spec: SpecConfig, *, smoke: bool = False) -> ResolvedSpec:
    """Validate ``--speculate`` / ``--spec-depth`` / ``--spec-quant``
    against the target.

    Raises ``ValueError`` (the CLI's exit-2 path) with the reference's
    messages, listing the compatible drafters, when the arch is unknown,
    unpackable or vocab-mismatched, or the target family cannot verify.
    One check is the port's own: a twin of a target already packed at
    other bits than ``spec.quant`` (the reference passes the target's
    carriers through and then decodes them at ``spec.quant`` bits, which
    fails on their shape)."""
    if cfg.family not in SPEC_FAMILIES:
        raise ValueError(
            f"speculative decoding: family {cfg.family!r} has no draft-tree "
            f"verification path (SSM lane state cannot roll back a rejected "
            f"chain); serve one of {SPEC_FAMILIES} or drop --speculate"
        )
    if spec.depth < 2:
        raise ValueError(
            f"--spec-depth {spec.depth} proposes no draft tokens; "
            "use a depth >= 2 (or drop --speculate)"
        )
    if spec.quant not in (1, 2):
        raise ValueError(
            f"--spec-quant {spec.quant} is not a packed carrier width; "
            "FCMP packs 1- or 2-bit codes"
        )
    if spec.drafter == NGRAM:
        return ResolvedSpec(spec, None, None, twin=False)

    from repro_torch import configs

    options = ", ".join(compatible_drafters(cfg, smoke=smoke))
    try:
        arch = configs.canonical(spec.drafter)
        dcfg = configs.get_smoke_config(arch) if smoke else configs.get_config(arch)
        dfull = configs.get_config(arch)
    except ValueError:
        raise ValueError(
            f"unknown drafter arch {spec.drafter!r}; compatible drafters "
            f"for {cfg.name}: {options}"
        ) from None
    if dcfg.family not in MODEL_DRAFT_FAMILIES:
        raise ValueError(
            f"drafter arch {spec.drafter!r} (family {dcfg.family!r}) has no "
            f"packed twin — only {MODEL_DRAFT_FAMILIES} FFNs pack into FCMP "
            f"carriers; compatible drafters for {cfg.name}: {options}"
        )
    if dcfg.vocab != cfg.vocab:
        raise ValueError(
            f"drafter arch {spec.drafter!r} vocab {dcfg.vocab} != target "
            f"{cfg.name} vocab {cfg.vocab} — proposals would index a "
            f"different token space; compatible drafters: {options}"
        )
    twin = dcfg.name == cfg.name
    if twin and cfg.w_bits in (1, 2) and cfg.w_bits != spec.quant:
        raise ValueError(
            f"the {cfg.name} target is packed at {cfg.w_bits} bits, so its twin "
            f"shares those carriers and cannot draft at --spec-quant "
            f"{spec.quant}; use --spec-quant {cfg.w_bits} (or serve the target "
            "with --quant 0)"
        )
    return ResolvedSpec(spec, dataclasses.replace(dcfg, w_bits=spec.quant),
                        dataclasses.replace(dfull, w_bits=spec.quant), twin=twin)


# --------------------------------------------------------------------------
# Drafters
# --------------------------------------------------------------------------


class NgramDrafter:
    """Self-drafting suffix-match lookup over the request's own history.

    Proposes the continuation that followed the most recent earlier
    occurrence of the current suffix (longest suffix first, down to one
    token; last-token repetition when nothing matches). Deterministic and
    model-free, so any accepted token is pure profit.
    """

    is_model = False
    max_suffix = 8
    window = 512

    def start_lane(self, slot: int, prompt: np.ndarray) -> tuple[int, int]:
        return 0, 0

    def release_lane(self, slot: int) -> None:
        pass

    def accept(self, slot: int, n_rows: int) -> None:
        pass

    def _continuation(self, ctx: np.ndarray, n: int) -> np.ndarray:
        out = np.full((n,), int(ctx[-1]), np.int32)  # repeat-last fallback
        ln = len(ctx)
        for m in range(min(self.max_suffix, ln - 1), 0, -1):
            suffix = ctx[ln - m:]
            # most recent earlier occurrence of the suffix
            for s in range(ln - m - 1, -1, -1):
                if np.array_equal(ctx[s : s + m], suffix):
                    cont = ctx[s + m : s + m + n]
                    out[: len(cont)] = cont
                    if len(cont) < n and len(cont) > 0:
                        out[len(cont):] = int(cont[-1])
                    return out
        return out

    def propose(
        self, lanes: list[LaneDraft], k: int, sampling: lm.SamplingParams
    ) -> tuple[np.ndarray, int]:
        props = np.zeros((len(lanes), k - 1), np.int32)
        for j, ln in enumerate(lanes):
            ctx = ln.history[-self.window:]
            props[j] = self._continuation(np.asarray(ctx, np.int32), k - 1)
        return props, 0


@dataclasses.dataclass
class DrafterStats:
    """Host seconds of a model drafter's steps, each to its logits on the
    host (its round trip), beside their counts."""

    decode_steps: int = 0
    decode_s: float = 0.0
    prefills: int = 0
    prefill_s: float = 0.0


class ModelDrafter:
    """A packed-twin (or foreign-arch) model drafter with private KV.

    The drafter runs the paged decode step over its own fixed-geometry
    buffers of shape ``(L, 1 + slots * max_len, n_kv, hd)``: lane ``i``
    owns the rows ``[1 + i*S, 1 + (i+1)*S)`` (row 0 is the scratch row for
    prefill padding), so its row table is static and rollback is a clamp
    of the lane's length. The rollout feeds exactly the tokens the verifier
    feeds, so rows under the accepted prefix are already right and rows
    past it are overwritten by the next chain. The buffers are updated in
    place and never rebound, since a captured graph binds their addresses.
    """

    is_model = True

    def __init__(self, cfg: ModelConfig, params: lm.LMParams, *, slots: int, max_len: int):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.s = max_len
        self.device = params["embed"].device
        shape = (cfg.n_kv_cache_layers, 1 + slots * max_len, cfg.n_kv, cfg.hd)
        self.k = torch.zeros(shape, dtype=torch_dtype(cfg), device=self.device)
        self.v = torch.zeros(shape, dtype=torch_dtype(cfg), device=self.device)
        table = 1 + np.arange(slots)[:, None] * max_len + np.arange(max_len)
        self._row_table = torch.from_numpy(table.astype(np.int64)).to(self.device)
        self.lengths = np.zeros((slots,), np.int32)
        self._decode = make_paged_serve_step(cfg)
        self._prefill = make_pool_prefill_step(cfg)
        self._mempool = None
        self._decode_graph: CapturedStep | None = None
        self._prefill_graph: CapturedStep | None = None
        self.stats = DrafterStats()

    def use_graphs(self, mempool) -> None:
        """Run the decode and prefill steps as CUDA graphs in ``mempool``
        (the scheduler's), each captured at its first use."""
        if self.device.type != "cuda":
            raise ValueError(f"the drafter's steps are on {self.device}, which has no graphs")
        self._mempool = mempool

    @property
    def graphs(self) -> list[CapturedStep]:
        return [g for g in (self._decode_graph, self._prefill_graph) if g is not None]

    @staticmethod
    def _host_tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64))

    def _run_prefill(self, tokens: np.ndarray, last: int):
        if self._mempool is None:
            return self._prefill(
                self.params, self._host_tensor(tokens).to(self.device),
                self._host_tensor([last]).to(self.device),
            )
        if self._prefill_graph is None:
            # the closure holds what the graph binds, never the drafter
            prefill, params = self._prefill, self.params

            def whole(tok, last_idx):
                return prefill(params, tok, last_idx)

            self._prefill_graph = CapturedStep(
                whole, device=self.device, mempool=self._mempool
            )
        return self._prefill_graph(self._host_tensor(tokens), self._host_tensor([last]))

    def _run_decode(self, token: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        if self._mempool is None:
            return self._decode(
                self.params, self._host_tensor(token).to(self.device), self.k, self.v,
                self._row_table, self._host_tensor(lengths).to(self.device),
            )[0]
        if self._decode_graph is None:
            step, params, k, v, table = (
                self._decode, self.params, self.k, self.v, self._row_table
            )

            def decode(tok, lens):
                return step(params, tok, k, v, table, lens)[0]

            self._decode_graph = CapturedStep(
                decode, device=self.device, mempool=self._mempool
            )
        return self._decode_graph(self._host_tensor(token), self._host_tensor(lengths))

    def start_lane(self, slot: int, prompt: np.ndarray) -> tuple[int, int]:
        """Prefill the drafter's own KV for the prompt: one step padded to
        ``max_len`` (the target's prefix-cache hits do not transfer: the
        drafter's rows are its own model's). Returns (tokens, steps)."""
        t0 = time.perf_counter()
        p = len(prompt)
        padded = np.zeros((1, self.s), np.int32)
        padded[0, :p] = prompt
        _, ks, vs = self._run_prefill(padded, p - 1)
        rows = np.zeros((self.s,), np.int64)  # the padded tail -> scratch row 0
        rows[:p] = 1 + slot * self.s + np.arange(p)
        idx = torch.from_numpy(rows).to(self.device)
        self.k.index_copy_(1, idx, ks[:, 0].to(self.k.dtype))
        self.v.index_copy_(1, idx, vs[:, 0].to(self.v.dtype))
        self.lengths[slot] = p
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.prefills += 1
        self.stats.prefill_s += time.perf_counter() - t0
        return p, 1

    def release_lane(self, slot: int) -> None:
        self.lengths[slot] = 0

    def accept(self, slot: int, n_rows: int) -> None:
        """Settle a verified chain: the accepted prefix's rows were fed
        identically here and in the target, so rollback is a length clamp."""
        self.lengths[slot] = n_rows

    def propose(
        self, lanes: list[LaneDraft], k: int, sampling: lm.SamplingParams
    ) -> tuple[np.ndarray, int]:
        """Roll the drafter ``k`` steps: feed each lane's pending token,
        then its own proposals, sampling with the verifier's (seed, rid,
        position) rng keys, so greedy and seeded chains match wherever the
        logits agree. The k-th step emits no proposal: it writes the KV row
        of the last proposal, so a chain accepted whole leaves the
        drafter's cache complete. Each step's logits come back to the host
        (one round trip a step)."""
        token = np.zeros((self.slots, 1), np.int32)
        lengths = self.lengths.copy()
        for ln in lanes:
            if lengths[ln.slot] != ln.n_rows:
                raise RuntimeError(
                    f"drafter lane {ln.slot} holds {lengths[ln.slot]} rows; "
                    f"target holds {ln.n_rows} — mirror out of sync"
                )
            token[ln.slot, 0] = ln.pending
        props = np.zeros((len(lanes), k - 1), np.int32)
        steps = 0
        for step in range(k):
            t0 = time.perf_counter()
            logits = self._run_decode(token, lengths)
            rows = logits[:, 0, :].to(torch.float32).cpu().numpy()
            self.stats.decode_s += time.perf_counter() - t0
            self.stats.decode_steps += 1
            steps += 1
            for j, ln in enumerate(lanes):
                lengths[ln.slot] += 1
                if step < k - 1:
                    d = _sample_keyed(rows[ln.slot], sampling, ln.rid, ln.out_len + step)
                    props[j, step] = d
                    token[ln.slot, 0] = d
        return props, steps


class Speculator:
    """The scheduler-facing bundle: one drafter and the draft depth."""

    def __init__(self, drafter, *, depth: int):
        self.drafter = drafter
        self.depth = depth

    @property
    def is_model(self) -> bool:
        return self.drafter.is_model

    @property
    def name(self) -> str:
        if self.is_model:
            return f"{self.drafter.cfg.name}@w{self.drafter.cfg.w_bits}"
        return NGRAM

    @property
    def graphs(self) -> list[CapturedStep]:
        """The drafter's captured steps (none for a model-free drafter)."""
        return list(getattr(self.drafter, "graphs", ()))

    def use_graphs(self, mempool) -> None:
        """Compile a model drafter's steps into CUDA graphs in ``mempool``;
        a model-free drafter runs nothing on the card."""
        if self.is_model:
            self.drafter.use_graphs(mempool)

    def start_lane(self, slot: int, prompt: np.ndarray) -> tuple[int, int]:
        return self.drafter.start_lane(slot, prompt)

    def release_lane(self, slot: int) -> None:
        self.drafter.release_lane(slot)

    def accept(self, slot: int, n_rows: int) -> None:
        self.drafter.accept(slot, n_rows)

    def propose(self, lanes, k, sampling) -> tuple[np.ndarray, int]:
        return self.drafter.propose(lanes, k, sampling)


def build_speculator(
    cfg: ModelConfig,
    params: lm.LMParams,
    spec: SpecConfig,
    *,
    slots: int,
    max_len: int,
    smoke: bool = False,
    draft_params: lm.LMParams | None = None,
) -> Speculator:
    """One-shot resolve + build for single-engine callers (serve.py)."""
    return resolve(cfg, spec, smoke=smoke).build(
        cfg, params, slots=slots, max_len=max_len, draft_params=draft_params
    )
