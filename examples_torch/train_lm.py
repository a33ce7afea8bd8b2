"""End-to-end LM training on the PyTorch port (the port of
``examples/train_lm.py``): a ~25M-parameter OLMo-family model with a WSD
schedule, async checkpoints and a resume from the newest one.

    PYTHONPATH=src python examples_torch/train_lm.py [--steps 200] \
        [--ckpt-dir DIR] [--device cpu]

``--device`` defaults to ``cuda`` and raises without a GPU.  Without
``--ckpt-dir`` the checkpoints go to a temporary directory that is
removed at the end; with one, a second run resumes where the first
stopped.
"""

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import get
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ck
from repro_torch.models import params as P
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamW, WSDSchedule
from repro_torch.training.steps import make_train_step


def config():
    """~25M params: the olmo family between its smoke and full sizes."""
    return dataclasses.replace(
        get("olmo-1b").smoke, n_layers=4, d_model=256, n_heads=8,
        n_kv_heads=8, d_ff=1024, vocab=8192)


def main(device="cuda", steps=200, ckpt_dir=None, ckpt_every=50, seq=128,
         batch=8, seed=0) -> dict:
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        return _train(dev, steps, ckpt_dir or tmp, ckpt_every, seq, batch,
                      seed)


def _train(dev, steps, ckpt_dir, ckpt_every, seq, batch, seed) -> dict:
    cfg = config()
    model = build_model(cfg)
    opt = AdamW(schedule=WSDSchedule(
        peak_lr=3e-4, warmup_steps=20, stable_steps=steps - 60,
        decay_steps=40, final_frac=0.1))
    pipe = SyntheticLM(cfg, seq_len=seq, global_batch=batch, device=dev)
    step_fn = make_train_step(model, opt, remat="none")
    ckpt = ck.AsyncCheckpointer(ckpt_dir, keep=2)

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.load_params(P.init(model.spec, gen, device=dev)).params
    opt_state = opt.init(params)
    start = ck.latest_step(ckpt_dir)
    if start is not None:
        start, restored, _ = ck.restore(
            ckpt_dir, like={"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        print(f"resumed from step {start}")
    else:
        start = 0
        print(f"fresh start: {P.count_params(model.spec) / 1e6:.1f}M "
              "params")

    m, losses = None, []
    t0 = time.time()
    for i in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state,
                                       pipe.batch_for_step(i))
        if (i + 1) % 20 == 0:
            losses.append(float(m["loss"]))
            tps = batch * seq * (i + 1 - start) / (time.time() - t0)
            print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  tok/s {tps:.0f}")
        if (i + 1) % ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt_state})
    ckpt.wait()
    final = float(m["loss"]) if m is not None else None
    if final is not None:
        print(f"done; final loss {final:.4f} (checkpoints in {ckpt_dir})")
    return {"start": start, "losses": losses, "final_loss": final,
            "seconds": time.time() - t0,
            "params": P.count_params(model.spec),
            "latest": ck.latest_step(ckpt_dir)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(device=a.device, steps=a.steps, ckpt_dir=a.ckpt_dir,
         ckpt_every=a.ckpt_every, seq=a.seq, batch=a.batch)
