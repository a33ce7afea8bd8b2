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
without a GPU.  The reference's multi-device branch (``choose_lm_mesh``,
``activation_sharding``) waits for the LM mesh (ROADMAP A12): with more
than one visible card the launcher raises ``NotImplementedError`` rather
than train on one of them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ck
from repro_torch.distributed.grad_compress import DeltaEFCompressor
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
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            f"{torch.cuda.device_count()} visible cards: training over "
            "several needs the LM mesh (ROADMAP A12: distributed/"
            "sharding.py, choose_lm_mesh); make one visible "
            "(CUDA_VISIBLE_DEVICES)")
    spec = get(args.arch)
    cfg = spec.smoke if args.smoke else spec.full
    model = build_model(cfg)
    opt = AdamW(schedule=WSDSchedule(
        warmup_steps=max(args.steps // 10, 1),
        stable_steps=max(args.steps * 8 // 10, 1),
        decay_steps=max(args.steps // 10, 1)))

    compressor = DeltaEFCompressor() if args.grad_compress else None
    step_fn = make_train_step(model, opt, accum_steps=args.accum,
                              remat=args.remat, grad_transform=compressor)
    pipe = SyntheticLM(cfg, seq_len=args.seq, global_batch=args.batch,
                       device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.load_params(P.init(model.spec, gen, device=dev)).params
    opt_state = opt.init(params)
    grad_ctx = compressor.init(params) if compressor else None
    start = 0
    ckpt = ck.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and ck.latest_step(args.ckpt_dir) is not None:
        start, restored, _ = ck.restore(
            args.ckpt_dir, like={"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
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
            print(f"step {i+1:5d}  loss {row['loss']:.4f}  "
                  f"gnorm {row['grad_norm']:.3f}  tok/s {tps:.0f}",
                  flush=True)
        if ckpt and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state})
    if ckpt:
        ckpt.wait()
    return {"start": start, "log": log, "params": params,
            "opt_state": opt_state, "grad_ctx": grad_ctx}


if __name__ == "__main__":
    main()
