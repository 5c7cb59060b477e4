"""AdamW: the port of ``repro.optim.adamw``, with the same defaults and the
same arithmetic.

A parameter tree is ``LMParams`` or a nested dict of tensors; the moments
are nested dicts of the same shape (``OptState(step, mu, nu)``, the
reference's NamedTuple), so the checkpoint keys match the reference's.
Moments are f32 whatever the parameter dtype. Non-float leaves (packed
uint8 carriers) are frozen and get scalar moments, and a leaf whose
gradient is None is left untouched, as the reference skips float0
tangents.

Unlike the reference, ``update`` works in place: each parameter's storage
and each moment is overwritten (``copy_``), so a step holds no second copy
of the parameters or the state; it returns the same parameter object and
a new ``OptState`` around the same moment tensors. A leaf of more than
``UPDATE_ELEMS`` elements is updated, and its gradient's square summed,
a block of its leading axis at a time (the update's arithmetic is
elementwise, so its bits do not change; the norm adds the blocks' sums),
so the step's f32 temporaries stay near ``UPDATE_ELEMS`` elements each,
not the size of a stacked expert leaf (4.3 GB each at 8 of olmoe's
layers). Every scalar (the
global gradient norm, the clip factor, the warm-up lr, the bias
corrections) stays a tensor on the parameters' device, so a step never
waits for the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

UPDATE_ELEMS = 1 << 28  # elements a block of a leaf's update touches, at most (1 GiB in f32)


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any  # first moment, f32, same tree as params
    nu: Any  # second moment, f32


def param_tree(params) -> dict[str, Any]:
    """A parameter tree as nested dicts of tensors (``LMParams.tree()``)."""
    return params.tree() if hasattr(params, "tree") else params


def _map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, keys in sorted order (the
    order of ``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _blocks(t: torch.Tensor) -> list[slice]:
    """Slices of ``t``'s leading axis of at most ``UPDATE_ELEMS`` elements
    each (one row at least); one slice of all of it when it is no larger."""
    if t.dim() == 0 or t.numel() <= UPDATE_ELEMS:
        return [slice(None)]
    rows = max(1, UPDATE_ELEMS // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _is_frozen(p: torch.Tensor, g) -> bool:
    return g is None or not p.is_floating_point()


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def init(self, params) -> OptState:
        def moment(p):
            if not p.is_floating_point():
                return torch.zeros((), dtype=torch.float32, device=p.device)
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        tree = param_tree(params)
        dev = leaves(tree)[0].device
        return OptState(
            torch.zeros((), dtype=torch.int32, device=dev),
            _map(moment, tree),
            _map(moment, tree),
        )

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads, state: OptState, params):
        """One step in place. ``grads`` is a tree like the parameters' with
        None for the leaves that take no gradient. Returns (params, new
        state)."""
        tree = param_tree(params)
        gs = [g for g in leaves(grads) if g is not None]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g[sl].to(torch.float32)))
                               for g in gs for sl in _blocks(g)))
        clip = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        step_f = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(self.b1, step_f)
        bc2 = 1.0 - torch.pow(self.b2, step_f)

        def upd_block(p, g, m, v, decay: bool):
            g = g.to(torch.float32) * clip
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * g * g)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if decay:
                delta = delta + self.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

        def upd(p, g, m, v):
            if _is_frozen(p, g):
                return
            # decay matrices only: p.ndim >= 2 on the stacked leaves, so the
            # reference decays the (L, d) norm gains ln1/ln2 and not the (d,)
            # final_norm; copied as it is
            decay = p.dim() >= 2
            for sl in _blocks(p):
                upd_block(p[sl], g[sl], m[sl], v[sl], decay)

        _map(upd, tree, grads, state.mu, state.nu)
        return params, OptState(step, state.mu, state.nu)
