"""Phase 25 of ``chip_smoke.py`` alone: the LM mesh on one card.  Four
ranks (one process each, a gloo group whose CUDA tensors go through
pinned host buffers: NCCL refuses two ranks on one device) share the
card and run phi3.5-moe at full width (d 4096, 32 heads on 8 KV heads,
16 experts top-2, expert d_ff 6400, vocab 32064) cut to 2 layers:

(a) ``launch.train.main`` on the ``(1, 4)`` mesh ``choose_lm_mesh(4)``
    gives, two steps on ``SyntheticLM``'s blocks; then three steps of the
    same mesh timed one by one (the launcher's clock holds the first
    step's set-up: pinned buffers, the allocator's first segments);
(b) a step of ``make_train_step(mesh=)`` on a ``(2, 2)`` mesh, gated
    against the same step emulated rank by rank in this
    process, the collectives as index moves of stacked blocks
    (:func:`emulated_moe`, :func:`emulated_grads`): ``moe_apply_ep`` routes
    each rank's tokens with a capacity of its own, so one device's step
    is not the oracle.  The emulation lives here, never on the main path;
(c) olmo-1b (full width, 2 layers) one ``(2, 2)`` step against its
    one-device step;
(d) serving on the ``(1, 4)`` mesh: ``Model.gather`` once, a prefill of
    4 x 256 tokens (the shard body; attention on the kernel, B5) and 8
    greedy decode steps (the dense decode body), the logits against the
    emulation's on the same tokens, every B5 launch against its plain
    version, and rank 0's launch inputs timed here against the plain
    version and SDPA with their bound.

Times are four processes time-sharing one card over a host-memory wire:
no NCCL figure and no multi-card figure.  A failing rank or gate fails
the run.  It needs a CUDA card (``--device cpu --small`` runs the same
phase at the smoke sizes on the CPU, without launches):

    python3 tools/lm_mesh_phase.py
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import shutil
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.distributed import collectives as col  # noqa: E402
from repro_torch.distributed import sharding as shlib  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn_ranks  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import params as P  # noqa: E402
from repro_torch.models.layers import mm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training import optimizer, steps  # noqa: E402

MOE, DENSE = "phi3.5-moe-42b-a6.6b", "olmo-1b"
LAYERS = 2
OUT = ROOT / "build" / "lm_mesh"
SAMPLES = 1 << 16          # master elements compared a leaf a rank
NEW_TOKENS = 8
# (2, 2) step against its emulation, and olmo's mesh step against one
# device's: the loss, the global gradient norm (summed in another order),
# the master where AdamW's first step g / (|g| + eps) is not at a sign
# flip of a near-zero gradient
LOSS_TOL, GNORM_TOL, MASTER_OFF_SHARE = 1e-3, 2e-2, 1e-2
LOGITS_TOL = 0.06          # serving, bf16 logits against the emulation


def sizes(small: bool) -> dict:
    if small:
        return dict(seq=32, batch=4, prompt=32, launch_steps=2)
    return dict(seq=256, batch=4, prompt=256, launch_steps=2)


def config(name: str, small: bool):
    spec = get(name)
    return spec.smoke if small else dataclasses.replace(spec.full,
                                                        n_layers=LAYERS)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _comm_seconds() -> float:
    return sum(s["seconds"] for s in col.STATS.values())


def _comm_summary() -> dict:
    return {op: dict(s, dtypes=dict(s["dtypes"]))
            for op, s in col.STATS.items()}


def sample(t: torch.Tensor) -> torch.Tensor:
    """Every ``stride``-th element of a leaf's block (at most SAMPLES),
    copied to float32 on its device."""
    flat = t.detach().reshape(-1)
    stride = max(1, flat.numel() // SAMPLES)
    return flat[::stride].to(torch.float32, copy=True)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def _profiled(fn):
    """``fn()`` under ``torch.profiler``: its result and the top ops by
    self host time and by self device time (ms)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        out = fn()
    ev = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    top = {
        "host": {e.key[:80]: e.self_cpu_time_total / 1e3 for e in sorted(
            ev, key=lambda e: -e.self_cpu_time_total)[:12]},
        "device": {e.key[:80]: dev_us(e) / 1e3 for e in sorted(
            ev, key=lambda e: -dev_us(e))[:12]},
        "device_total_ms": sum(dev_us(e) for e in ev) / 1e3}
    return out, top


def _timed_steps(step, params, state, pipe, n, dev, profile=False):
    """``n`` steps; each one's host seconds (synchronised), the share in
    the staged collectives, the metrics, and the state after step 1;
    ``profile``: the last step under the profiler."""
    rows, first = [], None
    for i in range(n):
        col.reset_stats()
        _sync(dev)
        t0 = time.perf_counter()
        batch = pipe.batch_for_step(i)
        top = None
        if profile and i == n - 1:
            (params, state, m), top = _profiled(
                lambda: step(params, state, batch))
        else:
            params, state, m = step(params, state, batch)
        _sync(dev)
        dt = time.perf_counter() - t0
        rows.append(dict(seconds=dt, comm_seconds=_comm_seconds(),
                         comm_share=_comm_seconds() / dt,
                         loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]),
                         comm=_comm_summary(), profile=top))
        if i == 0:
            first = [sample(a).cpu() for a in P.tree_leaves(state.master)]
    return params, state, rows, first


def rank_train(name, shape, small, seed, dev, n_steps, profile=False):
    cfg = config(name, small)
    model = build_model(cfg)
    mesh = make_mesh(shape, ("data", "model"), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = P.init(model.spec, gen, device=dev, mesh=mesh)
    opt = optimizer.AdamW()
    state = opt.init(params)
    step = steps.make_train_step(model, opt, mesh=mesh, donate=True)
    sz = sizes(small)
    pipe = SyntheticLM(cfg, seq_len=sz["seq"], global_batch=sz["batch"],
                       seed=seed, device=dev, mesh=mesh)
    _reset_peak(dev)
    params, state, rows, first = _timed_steps(step, params, state, pipe,
                                              n_steps, dev, profile)
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            raise RuntimeError(f"{name} {shape}: {r}")
    return dict(steps=rows, peak_bytes=_peak(dev), key=mesh.key(),
                master_samples=first)


def rank_serve(small, seed, dev):
    """Prefill + greedy decode on the (1, 4) mesh; every B5 launch gated
    against its plain version here."""
    cfg = config(MOE, small)
    model = build_model(cfg)
    mesh = make_mesh((1, 4), ("data", "model"), dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    blocks = P.init(model.spec, gen, device=dev, mesh=mesh)
    sz = sizes(small)
    b, s = sz["batch"], sz["prompt"]
    prompt = SyntheticLM(cfg, seq_len=s, global_batch=b, seed=seed + 1,
                         device=dev).batch_for_step(0)["tokens"]
    _reset_peak(dev)
    col.reset_stats()
    decode = steps.make_serve_decode_step(model)
    with shlib.activation_sharding(mesh):
        t0 = time.perf_counter()
        params = model.gather(blocks)
        _sync(dev)
        gather_s = time.perf_counter() - t0
        del blocks
        cache = model.init_cache(b, s + NEW_TOKENS, device=dev)
        cs.reset_all_launches()
        with cs.Capture(fa, ["flash_attention"]) as cap:
            col.reset_stats()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": prompt}, cache,
                                          backend="kernel")
            _sync(dev)
            prefill_s = time.perf_counter() - t0
            prefill_comm = _comm_seconds()
            out_logits = [logits.float().cpu()]
            tokens = [logits[:, -1].argmax(-1)]
            decode_s, decode_comm = [], []
            for i in range(NEW_TOKENS):
                col.reset_stats()
                t0 = time.perf_counter()
                logits, cache = decode(params, cache, tokens[-1][:, None],
                                       s + i)
                _sync(dev)
                decode_s.append(time.perf_counter() - t0)
                decode_comm.append(_comm_seconds())
                out_logits.append(logits.float().cpu())
                tokens.append(logits[:, -1].argmax(-1))
        launches = {k: n for k, n in cs.all_launches().items() if n}
    errs = []
    for i, (args, kw, out) in enumerate(cap.calls["flash_attention"]):
        plain = fa.flash_attention_plain(*args, causal=kw["causal"])
        errs.append(cs._attn_err(out, plain, f"lm mesh serve B5 call {i}"))
    calls = cap.calls["flash_attention"]
    for t in out_logits:
        if not torch.isfinite(t[..., :cfg.vocab]).all():
            raise RuntimeError("lm mesh serve: logits not finite")
    return dict(gather_seconds=gather_s, prefill_seconds=prefill_s,
                prefill_comm_seconds=prefill_comm, decode_seconds=decode_s,
                decode_comm_seconds=decode_comm, launches=launches,
                b5_calls=len(calls), b5_max_abs_err=max(errs, default=0.0),
                peak_bytes=_peak(dev), prompt=prompt.cpu(),
                tokens=torch.stack(tokens, 1).cpu(), logits=out_logits,
                b5_first=tuple(a.cpu() for a in calls[0][0]) if calls
                else None)


def rank_main(rank: int, world: int, dev_type: str, small: bool,
              seed: int, profile: bool = False) -> None:
    """One rank of phase 25: (a) the launcher, (b) the (2, 2) steps, (c)
    olmo's (2, 2) step, (d) serving; its results to ``OUT/rank<r>.pt``."""
    torch.set_num_threads(1 if dev_type == "cpu" else 2)
    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank}
    sz = sizes(small)
    argv = ["--arch", MOE, "--layers", str(LAYERS), "--steps",
            str(sz["launch_steps"]), "--seq", str(sz["seq"]), "--batch",
            str(sz["batch"]), "--device", dev_type]
    if small:
        argv.append("--smoke")
    _reset_peak(dev)
    col.reset_stats()
    t0 = time.perf_counter()
    out = launch_train.main(argv)
    _sync(dev)
    # the launcher's own clock: its steps' seconds from its tokens/s
    steps_s = (sz["launch_steps"] * sz["batch"] * sz["seq"]
               / out["log"][-1]["tokens_per_s"])
    res["launcher"] = dict(seconds=time.perf_counter() - t0, log=out["log"],
                           mesh=dict(out["mesh"].shape),
                           step_seconds=steps_s / sz["launch_steps"],
                           comm_share=_comm_seconds() / steps_s,
                           comm=_comm_summary(), peak_bytes=_peak(dev))
    del out
    # the launcher's mesh timed step by step (its own clock holds the first
    # step's set-up); with ``profile`` rank 0's last step traced
    res["moe_1x4"] = rank_train(MOE, (1, 4), small, seed, dev, 3,
                                profile=profile and rank == 0)
    t1 = time.perf_counter()
    res["moe_2x2"] = rank_train(MOE, (2, 2), small, seed, dev, 1)
    t2 = time.perf_counter()
    res["dense_2x2"] = rank_train(DENSE, (2, 2), small, seed, dev, 1)
    t3 = time.perf_counter()
    res["serve"] = rank_serve(small, seed, dev)
    res["part_seconds"] = dict(launcher=t1 - t0, moe_2x2=t2 - t1,
                               dense_2x2=t3 - t2,
                               serve=time.perf_counter() - t3)
    torch.save(res, OUT / f"rank{rank}.pt")


# ---------------------------------------------------------------------------
# The emulation (this process): the mesh's collectives as index moves
# ---------------------------------------------------------------------------

def emulated_moe(params, cfg, x, ep: int):
    """``moe_apply_ep`` of one data row's tokens ``x (B, S, D)`` over
    ``ep`` model ranks, each rank's body run in turn on whole weights:
    the dispatch ``all_to_all`` is owner ``g`` stacking chunk ``g`` of
    every rank's ``(E, C, D)``, the return one each rank stacking its
    chunk of every owner's output, the decode body's ``psum`` the ranks'
    partials added in rank order."""
    m = cfg.moe
    e, e_loc = m.n_experts, m.n_experts // ep
    b, s, d = x.shape
    w = [params[k] for k in ("w_gate", "w_up", "w_down")]
    own = [slice(g * e_loc, (g + 1) * e_loc) for g in range(ep)]
    aux = torch.zeros((), device=x.device)
    if s % ep:
        xt = x.reshape(b * s, d)
        _, _, gate = moe_mod._route_local(params["router"], cfg, xt)
        y = None
        for g in range(ep):
            h = F.silu(mm("td,edf->tef", xt, w[0][own[g]]).float()).to(
                xt.dtype) * mm("td,edf->tef", xt, w[1][own[g]])
            ye = mm("tef,efd->ted", h, w[2][own[g]])
            part = mm("ted,te->td", ye.float(), gate[0, :, own[g]])
            y = part if y is None else y + part
        return y.to(x.dtype).reshape(b, s, d), aux
    sl = s // ep
    t = b * sl
    c = moe_mod.capacity(cfg, t)
    routed = []
    for r in range(ep):
        xt = x[:, r * sl:(r + 1) * sl].reshape(t, d)
        _, topk_i, gate = moe_mod._route_local(params["router"], cfg, xt)
        w_ec, idx_ec = moe_mod.top_k(gate.transpose(1, 2), c)
        live = w_ec > 0.0
        xe = xt[idx_ec[0]] * live[0, ..., None].to(xt.dtype)
        routed.append((xe.reshape(ep, e_loc, c, d), w_ec, idx_ec, live,
                       topk_i))
    back = [[None] * ep for _ in range(ep)]
    for g in range(ep):
        xa = torch.stack([routed[r][0][g] for r in range(ep)])
        xa = xa.transpose(0, 1).reshape(e_loc, ep * c, d)
        ya = moe_mod._experts(xa, *(wi[own[g]] for wi in w))
        ya = ya.reshape(e_loc, ep, c, d).transpose(0, 1)
        for r in range(ep):
            back[r][g] = ya[r]
    ys = []
    for r in range(ep):
        _, w_ec, idx_ec, live, topk_i = routed[r]
        ye = torch.stack(back[r]).reshape(1, e, c, d)
        ye = ye * (w_ec * live.float())[..., None].to(ye.dtype)
        ys.append(moe_mod._combine(ye, idx_ec, live, topk_i)[0].reshape(
            b, sl, d))
    return torch.cat(ys, dim=1), aux


@contextmanager
def emulating(ep: int):
    """The model's MoE blocks through :func:`emulated_moe`."""
    orig = moe_mod.moe_apply_ep
    moe_mod.moe_apply_ep = functools.partial(emulated_moe, ep=ep)
    try:
        yield
    finally:
        moe_mod.moe_apply_ep = orig


def emulated_grads(model, params, batch, shape):
    """The gradients of one train step of the mesh ``shape`` emulated:
    each data block's share of the global mean loss (its tokens' loss over
    the global token count) backpropagated in turn, its gradients added in
    data-rank order (the reduce-scatter's); and the loss and the norm of
    the summed gradient."""
    n_data, ep = shape
    leaves = P.tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    tree = P.tree_unflatten(params, live)
    bsz, seq = batch["labels"].shape
    rows = bsz // n_data
    count = torch.tensor(float(bsz * seq), device=leaves[0].device)
    loss, acc = None, None
    with emulating(ep), torch.enable_grad():
        for d in range(n_data):
            blk = {k: v[d * rows:(d + 1) * rows] for k, v in batch.items()}
            logits = model.logits(tree, blk, remat="dots").float()
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, blk["labels"][..., None].long())[..., 0]
            share = torch.sum(nll * torch.ones_like(nll)) / count
            g = torch.autograd.grad(share, live, materialize_grads=True)
            acc = list(g) if acc is None else [a + b for a, b in zip(acc, g)]
            loss = share.detach() if loss is None else loss + share.detach()
            del g, logits, nll, share
    gnorm = torch.sqrt(sum(torch.sum(a.float() ** 2) for a in acc))
    return acc, dict(loss=float(loss), grad_norm=float(gnorm))


def _master_gate(label, ranks, key, specs, mesh, lr, want_fn):
    """The ranks' sampled master blocks after the step against
    ``want_fn(leaf index, spec, coords)`` (the same samples of the
    reference's): the share of elements off by more than 1e-6, each within
    2 lr (AdamW's first step at a flipped sign)."""
    n = off = 0
    worst = 0.0
    for r in ranks:
        coords = dict(zip(mesh.axis_names, r[key]["key"]))
        for i, (spec, got) in enumerate(zip(specs,
                                            r[key]["master_samples"])):
            dlt = (want_fn(i, spec, coords).cpu() - got).abs()
            n += dlt.numel()
            off += int((dlt > 1e-6).sum())
            worst = max(worst, float(dlt.max()))
    if worst > 2 * lr + 1e-6 or off > MASTER_OFF_SHARE * n:
        cs.fail(f"{label}: master off at {off} of {n} sampled elements, "
                f"worst {worst} (limits {MASTER_OFF_SHARE} of them, "
                f"2 lr = {2 * lr})")
    return dict(master_off=off, master_sampled=n, master_worst=worst)


def _step_gate(label, want, ranks, key):
    got = ranks[0][key]["steps"][0]
    for r in ranks:
        s = r[key]["steps"][0]
        if s["loss"] != got["loss"] or s["grad_norm"] != got["grad_norm"]:
            cs.fail(f"{label}: ranks disagree on the step's metrics")
    l_rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    g_rel = abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"]
    if l_rel > LOSS_TOL or g_rel > GNORM_TOL:
        cs.fail(f"{label}: loss {got['loss']} vs {want['loss']}, grad norm "
                f"{got['grad_norm']} vs {want['grad_norm']}")
    return dict(loss=got["loss"], want_loss=want["loss"], loss_rel=l_rel,
                grad_norm=got["grad_norm"], want_grad_norm=want["grad_norm"],
                grad_norm_rel=g_rel)


def check_train(name, shape, small, seed, dev, ranks, key, emulate):
    """The ranks' first step on ``shape`` against the emulated step
    (``emulate``) or one device's; with the emulation AdamW runs on the
    sampled elements alone (it is elementwise), so the whole optimizer
    state of the full-width model is never held here."""
    cfg = config(name, small)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = P.init(model.spec, gen, device=dev)
    opt = optimizer.AdamW()
    sz = sizes(small)
    batch = SyntheticLM(cfg, seq_len=sz["seq"], global_batch=sz["batch"],
                        seed=seed, device=dev).batch_for_step(0)
    mesh = col.Mesh(("data", "model"), shape)
    specs = P.tree_leaves(shlib.tree_specs(model.spec, mesh))
    leaves = P.tree_leaves(params)
    t0 = time.perf_counter()
    if emulate:
        grads, want = emulated_grads(model, params, batch, shape)

        def want_fn(i, spec, coords):
            g = sample(shlib.block_of(grads[i], spec, mesh, coords))
            p = sample(shlib.block_of(leaves[i], spec, mesh, coords))
            return opt.update({"x": g}, opt.init({"x": p}), {"x": p}
                              )[1].master["x"]
    else:
        state = opt.init(params)
        _, state, m = steps.make_train_step(model, opt)(params, state, batch)
        want = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
        masters = P.tree_leaves(state.master)

        def want_fn(i, spec, coords):
            return sample(shlib.block_of(masters[i], spec, mesh, coords))
    _sync(dev)
    seconds = time.perf_counter() - t0
    label = f"lm mesh {name} {shape} step"
    row = _step_gate(label, want, ranks, key)
    lr = float(opt.schedule(torch.tensor(1)))
    row.update(_master_gate(label, ranks, key, specs, mesh, lr, want_fn),
               reference_seconds=seconds)
    return row


def check_serve(small, seed, dev, ranks):
    """The (1, 4) mesh's prefill and decode logits (rank 0's) against the
    emulation fed the same tokens; every rank's tokens equal."""
    cfg = config(MOE, small)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    params = P.init(model.spec, gen, device=dev)
    got = ranks[0]["serve"]
    for r in ranks[1:]:
        if not torch.equal(r["serve"]["tokens"], got["tokens"]):
            cs.fail("lm mesh serve: the ranks' greedy tokens differ")
    prompt = got["prompt"].to(dev)
    b, s = prompt.shape
    cache = model.init_cache(b, s + NEW_TOKENS, device=dev)
    decode = steps.make_serve_decode_step(model)
    tokens = got["tokens"].to(dev)
    worst, flips = 0.0, 0
    with emulating(4), torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt}, cache,
                                      backend="kernel")
        want = [logits]
        for i in range(NEW_TOKENS):
            logits, cache = decode(params, cache, tokens[:, i:i + 1], s + i)
            want.append(logits)
    for w, g in zip(want, got["logits"]):
        w = w.float().cpu()[..., :cfg.vocab]
        g = g[..., :cfg.vocab]
        worst = max(worst, float((w - g).abs().max()))
        top2 = w.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * LOGITS_TOL
        flips += int(((w.argmax(-1) != g.argmax(-1)) & clear).sum())
    if worst > LOGITS_TOL or flips:
        cs.fail(f"lm mesh serve: logits off by {worst} (limit {LOGITS_TOL}),"
                f" {flips} greedy tokens apart at a clear margin")
    return dict(logits_max_abs_err=worst, token_flips=flips)


def b5_row(args):
    """B5 at the serving prefill's shape (rank 0's first launch): kernel,
    plain, SDPA and the bound."""
    q, k, v = (a.cuda() for a in args)
    bh, sq, hd = q.shape
    ms = cs.cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
    plain_ms = cs.cuda_ms(lambda: fa.flash_attention_plain(
        q, k, v, causal=True), 5)
    lib_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=True), 20)
    b_ms, b_by, nbytes, nops = cs.attention_bound(
        bh, sq, k.shape[1], hd, v.shape[2], True, q.dtype)
    return dict(shape=[bh, sq, hd], ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                bytes=nbytes, ops=nops)


def run(seed: int = 0, device: str = "cuda", small: bool = False,
        profile: bool = False) -> dict:
    """Phase 25: the ranks, then the gates in this process; ``profile``
    traces rank 0's last ``(1, 4)`` step."""
    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        _build.build("flash_attention")     # once, before the ranks load it
    shutil.rmtree(OUT, ignore_errors=True)
    OUT.mkdir(parents=True)
    spawn_ranks(rank_main, 4, str(OUT / "store"),
                args=(device, small, seed, profile), timeout_s=400.0)
    ranks = [torch.load(OUT / f"rank{r}.pt", weights_only=False)
             for r in range(4)]
    ranks_s = time.perf_counter() - t0
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    out = {"card": card, "ranks_seconds": ranks_s, "layers": LAYERS,
           **{k: v for k, v in sizes(small).items()}}
    for r in ranks:
        for row in r["launcher"]["log"]:
            if not (math.isfinite(row["loss"])
                    and math.isfinite(row["grad_norm"])):
                cs.fail(f"lm mesh launcher: rank {r['rank']} {row}")
        if r["launcher"]["mesh"] != {"data": 1, "model": 4}:
            cs.fail(f"lm mesh launcher: mesh {r['launcher']['mesh']}")
    out["launcher"] = [dict(r["launcher"]) for r in ranks]
    out["rank_part_seconds"] = [r["part_seconds"] for r in ranks]
    out["moe_2x2"] = check_train(MOE, (2, 2), small, seed, dev, ranks,
                                 "moe_2x2", True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["dense_2x2"] = check_train(DENSE, (2, 2), small, seed, dev, ranks,
                                   "dense_2x2", False)
    out["serve"] = check_serve(small, seed, dev, ranks)
    for key in ("moe_2x2", "dense_2x2"):
        out[key]["ranks"] = [dict(steps=r[key]["steps"],
                                  peak_bytes=r[key]["peak_bytes"])
                             for r in ranks]
    out["moe_1x4"] = {"ranks": [dict(steps=r["moe_1x4"]["steps"],
                                     peak_bytes=r["moe_1x4"]["peak_bytes"])
                                for r in ranks]}
    out["serve"]["ranks"] = [
        {k: v for k, v in r["serve"].items()
         if k not in ("prompt", "tokens", "logits", "b5_first")}
        for r in ranks]
    if dev.type == "cuda":
        for r in out["serve"]["ranks"]:
            if r["launches"].get("flash_attention_wgmma", 0) != LAYERS or \
                    r["b5_calls"] != LAYERS:
                cs.fail(f"lm mesh serve: B5 launches {r['launches']} "
                        f"({r['b5_calls']} calls) != {LAYERS}")
        out["b5"] = b5_row(ranks[0]["serve"]["b5_first"])
    out["seconds"] = time.perf_counter() - t0
    shutil.rmtree(OUT, ignore_errors=True)
    report(out)
    return out


def report(out: dict) -> None:
    gib = 2 ** 30
    for r, row in enumerate(out["launcher"]):
        log = row["log"][-1]
        print(f"[lm mesh] (a) launcher rank {r}: mesh {row['mesh']}, "
              f"{row['seconds']:.2f}s with the weights' draw, "
              f"{1e3 * row['step_seconds']:.1f} ms a step over "
              f"{out['launch_steps']} (its tokens/s), "
              f"{100 * row['comm_share']:.1f}% in the staged collectives; "
              f"last loss {log['loss']:.4f}, grad norm "
              f"{log['grad_norm']:.4f}; peak {row['peak_bytes'] / gib:.2f} "
              "GiB", flush=True)
    for r, row in enumerate(out["moe_1x4"]["ranks"]):
        print(f"[lm mesh] (a') (1, 4) rank {r}: " + ", ".join(
            f"step {i + 1} {1e3 * st['seconds']:.1f} ms "
            f"({100 * st['comm_share']:.1f}% in the collectives)"
            for i, st in enumerate(row["steps"]))
            + f"; peak {row['peak_bytes'] / gib:.2f} GiB", flush=True)
    top = out["moe_1x4"]["ranks"][0]["steps"][-1]["profile"]
    if top is not None:
        print(f"[lm mesh] (1, 4) rank 0's last step traced: device "
              f"{top['device_total_ms']:.1f} ms of kernels; top host "
              f"{top['host']}; top device {top['device']}", flush=True)
    for key in ("moe_2x2", "dense_2x2"):
        g = out[key]
        print(f"[lm mesh] ({'b' if key == 'moe_2x2' else 'c'}) {key}: loss "
              f"{g['loss']:.6f} vs {g['want_loss']:.6f} (rel "
              f"{g['loss_rel']:.3g}), grad norm {g['grad_norm']:.6f} vs "
              f"{g['want_grad_norm']:.6f} (rel {g['grad_norm_rel']:.3g}); "
              f"master off at {g['master_off']} of {g['master_sampled']} "
              f"sampled elements, worst {g['master_worst']:.3g}", flush=True)
        for r, row in enumerate(g["ranks"]):
            st = row["steps"][-1]
            print(f"[lm mesh]   rank {r}: step {len(row['steps'])} "
                  f"{1e3 * st['seconds']:.1f} ms (host, synchronised), "
                  f"{100 * st['comm_share']:.1f}% in the staged "
                  f"collectives; peak {row['peak_bytes'] / gib:.2f} GiB",
                  flush=True)
    s = out["serve"]
    for r, row in enumerate(s["ranks"]):
        dec = row["decode_seconds"]
        print(f"[lm mesh] (d) serve rank {r}: gather "
              f"{row['gather_seconds']:.3f}s, prefill "
              f"{1e3 * row['prefill_seconds']:.1f} ms "
              f"({1e3 * row['prefill_comm_seconds']:.1f} in collectives), "
              f"decode {1e3 * sum(dec) / len(dec):.1f} ms a step "
              f"({1e3 * sum(row['decode_comm_seconds']) / len(dec):.1f} in "
              f"collectives); B5 launches {row['launches']}, max err vs "
              f"plain {row['b5_max_abs_err']:.3g}; peak "
              f"{row['peak_bytes'] / gib:.2f} GiB", flush=True)
    print(f"[lm mesh] (d) serve vs emulation: logits max abs err "
          f"{s['logits_max_abs_err']:.3g}, token flips {s['token_flips']}",
          flush=True)
    if "b5" in out:
        b = out["b5"]
        print(f"[lm mesh] B5 at {b['shape']}: {b['ms']:.4f} ms, plain "
              f"{b['plain_ms']:.4f}, SDPA {b['library_ms']:.4f}, bound "
              f"{b['bound_ms']:.4f} ({b['bound_by']})", flush=True)
    parts = out["rank_part_seconds"][0]
    print(f"[lm mesh] phase 25: {out['seconds']:.1f}s (ranks "
          f"{out['ranks_seconds']:.1f}s; rank 0: " + ", ".join(
              f"{k} {v:.1f}s" for k, v in parts.items()) + ")", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the smoke configs (a CPU check of the phase)")
    ap.add_argument("--profile", action="store_true",
                    help="trace rank 0's last (1, 4) step")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("lm_mesh_phase: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(cs.card_line(), flush=True)
    out = run(args.seed, args.device, args.small, args.profile)
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
