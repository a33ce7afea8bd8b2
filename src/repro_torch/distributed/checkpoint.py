"""Fault-tolerant checkpoints: atomic, verified, mesh-independent (port of
``repro/distributed/checkpoint.py``).

* :func:`save` writes every array leaf of a tree of dicts, lists,
  tuples and NamedTuples (an optimizer state) to ``leaf_%05d.npy`` under
  ``.tmp_step_<step>_<pid>``, with a ``manifest.json`` (step, leaf keys,
  shapes, dtypes, a crc32 a leaf, user extras), then publishes it by
  renaming the directory to ``step_<step:010d>``: a crashed writer never
  corrupts the newest checkpoint.  Leaves go in the reference's order (a
  dict's keys sorted, a NamedTuple's fields in order, as
  ``jax.tree_util`` flattens), keyed by their ``/``-joined path, and
  bfloat16 is widened to float32 with its dtype recorded, so a directory
  either package writes restores in the other.
* :func:`restore` verifies the manifest and every leaf's crc32 and rolls
  back past corrupt or torn steps to the newest one that verifies.
* :class:`AsyncCheckpointer` snapshots to host memory at once and writes
  on a thread, re-raising the thread's error at the next call.
* :func:`save_abm` stores an ABM state logically: the flattened live
  agents (``core.reshard.flatten_state``), the engine carry and the
  occupancy histogram, so ``distributed.elastic.elastic_restore_abm``
  restores it onto any device count.  On a process mesh the agents are
  gathered to rank 0, which writes; every rank waits at a barrier.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import warnings
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointCorrupt(RuntimeError):
    """A checkpoint directory failed verification: missing or unparsable
    manifest, unreadable array leaf, or a per-leaf checksum mismatch."""


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs in ``jax.tree_util``'s order: a dict's items
    by sorted key, a NamedTuple's by field in its order and keyed by the
    field's name (``opt/step``, ``opt/m/...``: jax's ``GetAttrKey``), a
    list's or tuple's by index; keys ``/``-joined."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array to write, and its dtype's name (bfloat16
    widened to float32, its name kept)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr, name


def save(ckpt_dir: str, step: int, tree: Any,
         extras: Optional[Dict] = None, keep: int = 3,
         shardings: Any = None) -> str:
    """Synchronous atomic checkpoint save.  Returns the published path.

    ``shardings``: from an LM mesh, a tree of ``tree``'s structure whose
    leaves are ``sharding.NamedSharding`` (None: a replicated leaf); each
    leaf is then this rank's block, and the checkpoint holds the logical
    (whole) array: every rank gathers each leaf in turn, rank 0 writes,
    and all wait for the publish at a barrier."""
    mesh = None
    if shardings is not None:
        sh = [v for _, v in _flatten_with_paths(shardings)]
        mesh = next((x.mesh for x in sh if x is not None), None)
    writer = mesh is None or mesh.rank == 0
    base = pathlib.Path(ckpt_dir)
    tmp = base / f".tmp_step_{step:010d}_{os.getpid()}"
    final = base / f"step_{step:010d}"
    if writer:
        base.mkdir(parents=True, exist_ok=True)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
    manifest = {"step": step, "extras": extras or {}, "leaves": []}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        if mesh is not None and sh[i] is not None:
            leaf = _whole(leaf, sh[i])
        if not writer:
            continue
        arr, dtype_name = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape),
             "dtype": dtype_name,
             # restore verifies it: a torn write or corrupted storage is
             # detected, not loaded
             "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes())})
    if writer:
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        _prune(base, keep)
    if mesh is not None and mesh.size > 1:
        import torch.distributed as dist

        dist.barrier()
    return str(final)


@torch.no_grad()
def _whole(block: torch.Tensor, sharding) -> torch.Tensor:
    """The whole tensor of this rank's ``block`` (every rank calls it)."""
    from repro_torch.distributed.sharding import gather_block

    return gather_block(block, sharding.spec, sharding.mesh)


def _prune(base: pathlib.Path, keep: int):
    steps = sorted(p for p in base.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep] if keep else []:
        shutil.rmtree(p, ignore_errors=True)


def _sweep_stale_tmp(base: pathlib.Path) -> List[str]:
    """Remove the ``.tmp_step_*_<pid>`` directories whose writer process
    is dead (the atomic rename never publishes them); a live pid's (a
    concurrent writer) stay."""
    removed = []
    if not base.exists():
        return removed
    for p in base.glob(".tmp_step_*"):
        if not p.is_dir():
            continue
        pid_s = p.name.rsplit("_", 1)[-1]
        if not pid_s.isdigit():
            continue
        pid = int(pid_s)
        alive = pid == os.getpid()
        if not alive:
            try:
                os.kill(pid, 0)
                alive = True
            except ProcessLookupError:
                alive = False
            except PermissionError:  # exists, owned by someone else
                alive = True
            except OSError:
                alive = False
        if not alive:
            shutil.rmtree(p, ignore_errors=True)
            removed.append(str(p))
    return removed


def _snapshot(tree):
    """A host copy of every leaf of ``tree``, now."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_snapshot(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


class AsyncCheckpointer:
    """Snapshot to host memory synchronously, write to disk on a thread.

    A background write that fails is recorded and re-raised from the next
    :meth:`wait` or :meth:`save`.  Construction sweeps the stale temporary
    directories of dead writers (:func:`_sweep_stale_tmp`)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None
        self.swept = _sweep_stale_tmp(pathlib.Path(ckpt_dir))

    def _write(self, step: int, host_tree, extras) -> None:
        def work():
            try:
                self.last_path = save(self.ckpt_dir, step, host_tree,
                                      extras, self.keep)
            except BaseException as e:  # noqa: BLE001 - re-raised at wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None):
        self.wait()
        self._write(step, _snapshot(tree), extras)

    def save_abm(self, step: int, engine, state,
                 extras: Optional[Dict] = None):
        """Async :func:`save_abm` (one process): the logical snapshot runs
        now, only the disk write overlaps the next steps."""
        self.wait()
        tree, merged = _abm_snapshot(engine, state, extras)
        self._write(step, tree, merged)

    def wait(self) -> Optional[str]:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return self.last_path


def _delta_meta(cfg) -> Optional[Dict]:
    """JSON-able record of an engine's aura-codec config (None if absent),
    with the reference's keys."""
    if cfg is None:
        return None
    qdtype = cfg.qdtype
    if isinstance(qdtype, torch.dtype):
        qdtype = torch.empty((), dtype=qdtype).numpy().dtype
    return {
        "enabled": bool(cfg.enabled),
        "qdtype": np.dtype(qdtype).name,
        "refresh_interval": int(cfg.refresh_interval),
        "scale": None if cfg.scale is None else float(cfg.scale),
    }


def _abm_snapshot(engine, state, extras: Optional[Dict] = None,
                  comm=None) -> Tuple[Optional[Dict], Dict]:
    """The logical (mesh-independent) checkpoint tree and extras of an ABM
    state.  On a process mesh (``comm``) every rank calls it; only rank 0
    gets the tree (the others None)."""
    from repro_torch.core.reshard import flatten_state, occupancy_histogram

    hist = occupancy_histogram(engine.geom, state, comm=comm)
    flat = flatten_state(engine.geom, state, comm,
                         dst=None if comm is None else 0)
    geom = engine.geom
    abm_meta = {
        "it": None if flat is None else int(flat.it),
        "dropped_total": None if flat is None else int(flat.dropped_total),
        "cell_size": float(geom.cell_size),
        "ndim": int(geom.ndim),
        "global_cells": list(geom.global_cells),
        "cap": int(geom.cap),
        "boundary": list(geom.boundary),
        "box_factor": int(geom.box_factor),
        "dt": float(engine.dt),
        "attr_names": None if flat is None else sorted(flat.attrs),
        # the live cuts and the ownership mode a restore re-cuts with (it
        # cuts a fresh plan from the histogram: the device count may
        # differ); checkpoints without these keys restore as "equal"
        "partition": ([list(c) for c in geom.partition.cuts]
                      if geom.uneven else None),
        "ownership": "rcb" if geom.uneven else "equal",
        # the aura codec a restore re-applies by default, so a replay of
        # the quantized closed loop stays bit-exact
        "delta": _delta_meta(getattr(engine, "delta_cfg", None)),
    }
    if flat is None:
        return None, {"abm": abm_meta, **(extras or {})}
    tree = {
        "positions": flat.positions,
        "attrs": {k: np.asarray(v) for k, v in sorted(flat.attrs.items())},
        "gid_counters": flat.gid_counters,
        "base_key": flat.base_key,
        "histogram": hist,
    }
    return tree, {"abm": abm_meta, **(extras or {})}


def save_abm(ckpt_dir: str, step: int, engine, state,
             extras: Optional[Dict] = None, keep: int = 3,
             mesh=None) -> str:
    """Checkpoint an ABM :class:`SimState` logically: the flattened live
    agents, the engine carry (iteration, spawn counters, RNG root) and the
    occupancy histogram.  The checkpoint is mesh-independent: a restore
    is a re-shard whose plan comes from the stored histogram.  With a
    process ``mesh`` every rank of it calls it: the agents are gathered to
    the mesh group's rank 0 and the histogram is the all-reduced one; that
    rank writes after every rank has reached a barrier, and every rank
    waits for the write at a second one.  Returns the published path on
    every rank."""
    if mesh is None:
        tree, merged = _abm_snapshot(engine, state, extras)
        return save(ckpt_dir, step, tree, extras=merged, keep=keep)
    comm = engine._comm(mesh)
    tree, merged = _abm_snapshot(engine, state, extras, comm)
    comm.barrier()
    path = str(pathlib.Path(ckpt_dir) / f"step_{step:010d}")
    if tree is not None:
        path = save(ckpt_dir, step, tree, extras=merged, keep=keep)
    comm.barrier()
    return path


def _step_dirs(base: pathlib.Path) -> List[pathlib.Path]:
    out = []
    for p in base.iterdir():
        if not (p.is_dir() and p.name.startswith("step_")):
            continue
        suffix = p.name.split("_", 1)[1]
        if suffix.isdigit():
            out.append(p)
    return sorted(out)


def _load_verified(path: pathlib.Path) -> Tuple[Dict, List[np.ndarray]]:
    """Load (manifest, arrays) from one checkpoint directory, verifying
    the per-leaf checksums where present.  Raises
    :class:`CheckpointCorrupt` on a missing or unparsable manifest, an
    unreadable leaf or a checksum mismatch."""
    mpath = path / "manifest.json"
    if not mpath.exists():
        raise CheckpointCorrupt(f"{path}: missing manifest.json")
    try:
        manifest = json.loads(mpath.read_text())
        leaves = manifest["leaves"]
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointCorrupt(
            f"{path}: unparsable manifest.json ({e})") from e
    arrays = []
    for leaf in leaves:
        try:
            arr = np.load(path / leaf["file"])
        except Exception as e:  # torn/truncated/missing .npy
            raise CheckpointCorrupt(
                f"{path}: unreadable leaf {leaf.get('file')} "
                f"[{leaf.get('key')}] ({e})") from e
        want = leaf.get("crc32")  # absent on legacy checkpoints
        if want is not None:
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != want:
                raise CheckpointCorrupt(
                    f"{path}: checksum mismatch on leaf "
                    f"{leaf['file']} [{leaf.get('key')}] "
                    f"(crc32 {got:#010x} != manifest {want:#010x})")
        arrays.append(arr)
    return manifest, arrays


def latest_step(ckpt_dir: str) -> Optional[int]:
    """Newest plausibly usable step: directories without a parsable
    ``manifest.json`` are skipped with a warning; checksums are verified
    at :func:`restore`."""
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    for p in reversed(_step_dirs(base)):
        try:
            json.loads((p / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            warnings.warn(
                f"skipping checkpoint {p.name} in {ckpt_dir}: "
                f"missing/corrupt manifest.json ({e})", stacklevel=2)
            continue
        return int(p.name.split("_", 1)[1])
    return None


def _unflatten(like, leaves: List) -> Any:
    """Rebuild ``like``'s structure from leaves in its flatten order."""
    it = iter(leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(rec(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return next(it)

    return rec(like)


def restore(ckpt_dir: str, step: Optional[int] = None, like: Any = None,
            device=None, shardings: Any = None) -> Tuple[int, Any, Dict]:
    """Restore a checkpoint.

    With ``step=None`` the newest checkpoint that verifies (manifest,
    every leaf, checksums) is used: corrupt ones are skipped newest to
    oldest with a warning naming each.  An explicit ``step`` that fails
    verification raises :class:`CheckpointCorrupt`.  Without ``like`` the
    tree comes back as a flat ``{key: array}`` dict; with ``like`` (a tree
    of the same structure) as that tree, each leaf a tensor of ``like``'s
    leaf's dtype (on ``device``, or the leaf's).  ``shardings`` (a tree of
    ``like``'s structure of ``sharding.NamedSharding``, None for a whole
    leaf) places this rank's block of each leaf: the device defaults to
    the mesh's, and ``like`` may hold ``meta`` tensors
    (``params.abstract_sharded``)."""
    base = pathlib.Path(ckpt_dir)
    if step is not None:
        manifest, arrays = _load_verified(base / f"step_{step:010d}")
    else:
        if not base.exists():
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        manifest = arrays = None
        for path in reversed(_step_dirs(base)):
            try:
                manifest, arrays = _load_verified(path)
                break
            except CheckpointCorrupt as e:
                warnings.warn(
                    f"skipping corrupt checkpoint {path.name}: {e}",
                    stacklevel=2)
        if manifest is None:
            raise FileNotFoundError(
                f"no usable checkpoints in {ckpt_dir} (all candidates "
                "failed verification)")

    if like is None:
        flat = {leaf["key"]: arr
                for leaf, arr in zip(manifest["leaves"], arrays)}
        return manifest["step"], flat, manifest["extras"]

    leaves = [v for _, v in _flatten_with_paths(like)]
    if len(leaves) != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves, the tree "
                         f"expects {len(leaves)}")

    places = [None] * len(leaves)
    if shardings is not None:
        places = [v for _, v in _flatten_with_paths(shardings)]
        if device is None:
            device = next(p.mesh.device for p in places if p is not None)

    def cast(a, ref, place):
        t = torch.from_numpy(np.array(a, copy=True))
        if place is not None:
            t = place.block(t).clone()
        if isinstance(ref, torch.Tensor):
            return t.to(device=device or ref.device, dtype=ref.dtype)
        return t.to(device) if device is not None else t

    return (manifest["step"],
            _unflatten(like, [cast(a, ref, p) for a, ref, p in
                              zip(arrays, leaves, places)]),
            manifest["extras"])
