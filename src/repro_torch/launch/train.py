"""LM training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --smoke --steps 50 --seq 128 --batch 8 --ckpt-dir build/ckpt \
        [--device cpu]

The reference's flags (``--arch --smoke --steps --seq --batch --accum
--remat --ckpt-dir --ckpt-every --grad-compress``) and its defaults: WSD
with a tenth of the steps warming up, eight tenths stable and a tenth
decaying; weights from ``params.init`` (seed 0); a resume from the newest
checkpoint (``latest_step``) of ``{"params", "opt"}``, saved every
``--ckpt-every`` steps by an ``AsyncCheckpointer``; a log line every 10
steps (and at the last).  ``--device`` defaults to ``cuda`` and raises
without a GPU.  ``--layers`` cuts the config's depth (the port's own
flag: a full-width model on fewer cards).

The reference's multi-device branch runs one process a device, under
``torchrun`` (or in a process group already joined):

    torchrun --nproc_per_node 4 -m repro_torch.launch.train \
        --arch phi3.5-moe-42b-a6.6b --layers 2 --seq 256 --batch 4

``choose_lm_mesh(world)`` picks the ``(data, model)`` mesh (4 ranks give
``(1, 4)``), ``launch.mesh.make_mesh`` lays the ranks out, and the
sharded train step (``make_train_step(mesh=)``) trains each rank's blocks
of the weights on its block of the batch; checkpoints hold the logical
arrays.  The group is NCCL where every rank has a card of its own and
gloo otherwise (several ranks sharing one card, or the CPU); rank 0
prints.  With one process and several visible cards it raises, pointing
at ``torchrun``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed.elastic import choose_lm_mesh
from repro_torch.distributed.grad_compress import DeltaEFCompressor
from repro_torch.launch.specs import params_specs
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamW, WSDSchedule
from repro_torch.training.steps import make_train_step


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--grad-compress", action="store_true",
                    help="delta+error-feedback int8 gradient compression")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: all)")
    return ap.parse_args(argv)


def _world() -> int:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _join(dev: torch.device):
    """Join (or keep) the process group and build the LM mesh: the rank's
    device, the mesh, this rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_mesh, make_mesh

    world = _world()
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if dev.type == "cuda":
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        backend = ("nccl" if dev.type == "cuda"
                   and torch.cuda.device_count() >= local_world else "gloo")
        init_process_mesh(backend)
    shape, axes = choose_lm_mesh(world)
    return dev, make_mesh(shape, axes, dev), dist.get_rank()


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    mesh, rank = None, 0
    if _world() > 1:
        dev, mesh, rank = _join(dev)
        if rank == 0:
            print(f"mesh: {mesh.shape}", flush=True)
    elif dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} visible cards and one process: "
            "the LM mesh runs one process a card, under torchrun "
            "(torchrun --nproc_per_node N -m repro_torch.launch.train ...), "
            "or make one card visible (CUDA_VISIBLE_DEVICES)")
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.full
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    opt = AdamW(schedule=WSDSchedule(
        warmup_steps=max(args.steps // 10, 1),
        stable_steps=max(args.steps * 8 // 10, 1),
        decay_steps=max(args.steps // 10, 1)))

    compressor = DeltaEFCompressor() if args.grad_compress else None
    step_fn = make_train_step(model, opt, accum_steps=args.accum,
                              remat=args.remat, grad_transform=compressor,
                              mesh=mesh, donate=True)
    pipe = SyntheticLM(cfg, seq_len=args.seq, global_batch=args.batch,
                       device=dev, mesh=mesh)

    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is None:
        params = model.load_params(P.init(model.spec, gen,
                                          device=dev)).params
    else:
        params = P.init(model.spec, gen, device=dev, mesh=mesh)
    opt_state = opt.init(params)
    grad_ctx = compressor.init(params) if compressor else None
    start = 0
    shardings = None
    if mesh is not None:
        sh = P.tree_map(lambda p: p.sharding,
                        params_specs(model, mesh))
        shardings = {"params": sh, "opt": type(opt_state)(
            step=None, master=sh, m=sh, v=sh)}
    ckpt = None
    if args.ckpt_dir:
        ckpt = (ck.AsyncCheckpointer(args.ckpt_dir) if mesh is None
                else _MeshSaver(args.ckpt_dir, shardings))
    if ckpt and ck.latest_step(args.ckpt_dir) is not None:
        start, restored, _ = ck.restore(
            args.ckpt_dir, like={"params": params, "opt": opt_state},
            shardings=shardings)
        params, opt_state = restored["params"], restored["opt"]
        if rank == 0:
            print(f"resumed from step {start}")

    metrics, log = None, []
    t0 = time.time()
    for i in range(start, args.steps):
        batch = pipe.batch_for_step(i)
        if compressor:
            params, opt_state, metrics, grad_ctx = step_fn(
                params, opt_state, batch, grad_ctx)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            tps = (args.batch * args.seq * (i + 1 - start)
                   / (time.time() - t0))
            row = {"step": i + 1, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "tokens_per_s": tps}
            log.append(row)
            if rank == 0:
                print(f"step {i+1:5d}  loss {row['loss']:.4f}  "
                      f"gnorm {row['grad_norm']:.3f}  tok/s {tps:.0f}",
                      flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()
    return {"start": start, "log": log, "params": params,
            "opt_state": opt_state, "grad_ctx": grad_ctx, "mesh": mesh}


class _MeshSaver:
    """Checkpoints from the LM mesh: a synchronous save of the logical
    arrays (every rank gathers, rank 0 writes)."""

    def __init__(self, ckpt_dir: str, shardings):
        self.ckpt_dir, self.shardings = ckpt_dir, shardings

    def save(self, step: int, tree) -> None:
        ck.save(self.ckpt_dir, step, tree, shardings=self.shardings)

    def wait(self) -> None:
        pass


if __name__ == "__main__":
    try:
        main()
    finally:
        from repro_torch.launch.mesh import close_process_mesh

        close_process_mesh()
