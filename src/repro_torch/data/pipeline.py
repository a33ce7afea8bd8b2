"""Deterministic synthetic data pipeline (port of
``repro/data/pipeline.py``).

Batches are a pure function of (seed, step): any host can materialize any
step's batch at any time, so a restarted worker regenerates exactly the
batches it needs (no loader state to checkpoint beyond the step counter).
The draws go through ``core.prng``, bit-equal to the reference's
``jax.random`` calls: ``fold_in(PRNGKey(seed), step)``, int32
``randint`` tokens in ``[0, vocab)``, bfloat16 ``normal`` patches and
frames.

With ``mesh`` (an LM mesh) each rank gets its block of that global batch:
the rows of its coordinates over the data axes (``spec_for`` of
``"batch"``), bit-equal to a slice of the whole batch, which every rank
draws (a few int32 tokens a row).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    device: DeviceLike = "cuda"
    mesh: Any = None

    def batch_for_step(self, step: int) -> Dict[str, Tensor]:
        """The full global batch of one step, on :attr:`device` (with
        :attr:`mesh`, this rank's block of it)."""
        out = self._global_batch(step)
        if self.mesh is None:
            return out
        from repro_torch.distributed import sharding as shlib

        spec = shlib.spec_for((self.global_batch,), ("batch",), self.mesh)
        data = shlib.data_axes(self.mesh)
        if self.mesh.axis_size(data) > 1 and shlib.spec_axes(spec) != data:
            raise ValueError(
                f"a global batch of {self.global_batch} rows does not split "
                f"over the mesh's data axes {data}")
        return {k: shlib.block_of(v, spec, self.mesh).contiguous()
                for k, v in out.items()}

    def _global_batch(self, step: int) -> Dict[str, Tensor]:
        cfg = self.cfg
        dev = resolve_device(self.device)
        key = prng.fold_in(prng.PRNGKey(self.seed, device=dev), step)
        b, s = self.global_batch, self.seq_len
        out: Dict[str, Tensor] = {}
        if cfg.family == "audio":
            k1, k2 = prng.split(key)
            out["frames"] = prng.normal(k1, (b, s, cfg.frontend_dim),
                                        torch.bfloat16)
            out["labels"] = prng.randint(k2, (b, s), 0, cfg.vocab)
        elif cfg.family == "vlm":
            k1, k2 = prng.split(key)
            toks = prng.randint(k1, (b, s - cfg.n_patches), 0, cfg.vocab)
            out["tokens"] = toks
            out["patches"] = prng.normal(
                k2, (b, cfg.n_patches, cfg.frontend_dim), torch.bfloat16)
            out["labels"] = torch.roll(toks, -1, dims=1)
        else:
            toks = prng.randint(key, (b, s), 0, cfg.vocab)
            out["tokens"] = toks
            out["labels"] = torch.roll(toks, -1, dims=1)
        return out

    def abstract_batch(self) -> Dict[str, Tensor]:
        """Stand-ins of the batch's shapes and types on the ``meta``
        device (no allocation), as the reference's ``ShapeDtypeStruct``s."""
        cfg = self.cfg
        b, s = self.global_batch, self.seq_len

        def meta(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if cfg.family == "audio":
            return {"frames": meta((b, s, cfg.frontend_dim), torch.bfloat16),
                    "labels": meta((b, s))}
        if cfg.family == "vlm":
            s_text = s - cfg.n_patches
            return {"tokens": meta((b, s_text)),
                    "patches": meta((b, cfg.n_patches, cfg.frontend_dim),
                                    torch.bfloat16),
                    "labels": meta((b, s_text))}
        return {"tokens": meta((b, s)), "labels": meta((b, s))}
