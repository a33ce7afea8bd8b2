"""AdamW with a Warmup-Stable-Decay (WSD) schedule (MiniCPM,
arXiv:2404.06395; port of ``repro/training/optimizer.py``).

The optimizer state keeps float32 master weights and float32 first and
second moments; the model's parameters keep their own type (bfloat16 for
the weights) and are recast from the master each step, rounding to
nearest even.  The schedule and the bias corrections are computed in
float32 from the step counter, a 0-d int32 tensor on the parameters'
device, as the reference computes them (``step.astype(float32)``): in
Python floats they would be float64, and ``lr`` and every moment would
differ by an ulp.

:meth:`AdamW.update` is functional, as the reference's: it returns new
tensors and leaves its arguments as they were (the reference's launcher
donates the old buffers to XLA; here they are freed when the caller drops
them).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map, \
    tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class WSDSchedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    stable_steps: int = 1000
    decay_steps: int = 100
    final_frac: float = 0.1

    def __call__(self, step: Tensor) -> Tensor:
        """The learning rate at ``step`` (an integer tensor), float32 on
        the step's device."""
        s = step.to(torch.float32)
        warm = self.peak_lr * torch.clamp(
            s / max(self.warmup_steps, 1), max=1.0)
        t_decay = s - (self.warmup_steps + self.stable_steps)
        frac = torch.clamp(t_decay / max(self.decay_steps, 1), 0.0, 1.0)
        decay_mult = 1.0 - (1.0 - self.final_frac) * frac
        return torch.where(s < self.warmup_steps + self.stable_steps, warm,
                           self.peak_lr * decay_mult)


class AdamWState(NamedTuple):
    step: Tensor   # int32, 0-d
    master: Any    # float32 copy of the parameters
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    schedule: WSDSchedule = WSDSchedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
            master=tree_map(lambda p: p.detach().to(torch.float32,
                                                    copy=True), params),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
            v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, inplace: bool = False
               ) -> Tuple[Any, AdamWState]:
        """``(new params, new state)`` from the gradients (any float type)
        and the parameters (whose types the new ones keep).  ``inplace``
        writes the new values into ``state``'s and ``params``' tensors
        (the same values: each is computed whole, then copied in), as the
        reference's launcher donates the old buffers, so the old and new
        state are never held together."""
        if inplace:
            return self._update_inplace(grads, state, params)
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        s = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, s)
        bc2 = 1.0 - torch.pow(b2, s)

        def upd(g, m, v, master, p):
            g = g.to(torch.float32)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            mh = m2 / bc1
            vh = v2 / bc2
            new_master = master - lr * (
                mh / (torch.sqrt(vh) + self.eps)
                + self.weight_decay * master)
            return m2, v2, new_master, new_master.to(p.dtype)

        trees = (grads, state.m, state.v, state.master, params)
        out = [upd(*t) for t in zip(*map(tree_leaves, trees))]
        new = [tree_unflatten(params, [o[i] for o in out])
               for i in range(4)]
        return new[3], AdamWState(step=step, master=new[2], m=new[0],
                                  v=new[1])

    def _update_inplace(self, grads, state: AdamWState, params):
        step = state.step + 1
        lr = self.schedule(step)
        b1, b2 = self.b1, self.b2
        s = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, s)
        bc2 = 1.0 - torch.pow(b2, s)
        trees = (grads, state.m, state.v, state.master, params)
        for g, m, v, master, p in zip(*map(tree_leaves, trees)):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            master.copy_(master - lr * (
                (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                + self.weight_decay * master))
            p.copy_(master.to(p.dtype))
            del g
        state.step.copy_(step)
        return params, state
