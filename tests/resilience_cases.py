"""Inputs shared by ``tests/test_torch_resilience.py`` and its JAX oracle
subprocess (numpy only, so both import it): the faults planted for the
guard-word comparisons, the mesh cases and the supervised plans."""

from __future__ import annotations

import numpy as np

# The reference's resilience tests' mechanics (tests/test_resilience.py:
# soft repulsion/adhesion 2.0/0.4, same type only, max_step 0.5, radius
# 2.0) is cell_clustering's behaviour at adhesion 0.4, in both packages.
ADHESION = 0.4


def init_data(n: int = 300, seed: int = 0, size: float = 32.0):
    """tests/test_resilience.py's ``_init_data``."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, size - 0.5, size=(n, 2)).astype(np.float32)
    attrs = {"diameter": np.full((n,), 1.0, np.float32),
             "ctype": rng.integers(0, 2, size=(n,)).astype(np.int32)}
    return pos, attrs


def plant(arrays: dict, domain_x: float, kinds=("nan", "domain", "slab",
                                                 "dup")) -> dict:
    """A copy of a state's arrays (the reference's global layout, keyed by
    field path) with one fault of each of ``kinds`` planted on live slots
    spread through the layout: a NaN position, a position at x = -0.5 (out
    of the domain and of its slab), a position moved half the domain
    along x (into another device's slab on a mesh), and a duplicated gid
    (the last live slot takes the identity of the one at three quarters)."""
    a = {k: np.array(v, copy=True) for k, v in arrays.items()}
    valid = a["soa.valid"]
    pos = a["soa.attrs.pos"]
    live = [tuple(int(c) for c in i) for i in np.argwhere(valid)]
    n = len(live)
    if "nan" in kinds:
        pos[live[0]] = np.nan
    if "domain" in kinds:
        pos[live[n // 4] + (0,)] = np.float32(-0.5)
    if "slab" in kinds:
        x = pos[live[n // 2] + (0,)]
        pos[live[n // 2] + (0,)] = np.float32((x + domain_x / 2) % domain_x)
    if "dup" in kinds:
        for name in ("soa.attrs.gid_rank", "soa.attrs.gid_count"):
            a[name][live[-1]] = a[name][live[(3 * n) // 4]]
    return a


# Guard-word cases on the 2x2 mesh: (make_sim keywords, overlap).
MESH_GUARD_CASES = {
    "equal_off": (dict(interior=(6, 6), mesh_shape=(2, 2)), "off"),
    "equal_on": (dict(interior=(6, 6), mesh_shape=(2, 2)), "on"),
    "uneven_off": (dict(widths=((4, 8), (5, 7))), "off"),
    "uneven_on": (dict(widths=((4, 8), (5, 7))), "on"),
}
MESH_GUARD_AGENTS = (200, 3)      # (agents, seed)
MESH_DOMAIN_X = 24.0              # 12 cells of 2.0 along x

# Supervised plans: (make_sim keywords, faults as Fault kwargs, plan
# seed, Supervised kwargs, steps).  The local ones run JAX in process;
# the mesh ones in the oracle subprocess.
LOCAL_PLANS = {
    "nan_recovery": (dict(), [dict(step=7, kind="nan_attrs", frac=0.1)],
                     42, dict(every=5, keep=9), 12),
    "raise_via_facade": (dict(), [dict(step=4, kind="raise")], 0,
                         dict(every=4, keep=9), 8),
    "torn_checkpoint": (dict(), [dict(step=10, kind="torn_checkpoint"),
                                 dict(step=12, kind="raise")], 0,
                        dict(every=5, keep=9), 15),
    "retry_exhaustion": (dict(), [dict(step=6, kind="raise"),
                                  dict(step=7, kind="raise"),
                                  dict(step=8, kind="raise")], 0,
                         dict(every=5, keep=9, max_retries=2), 12),
}
MESH_PLANS = {
    "halo_2x1": (dict(interior=(8, 16), mesh_shape=(2, 1)),
                 [dict(step=6, kind="halo_slab", axis=0)], 3,
                 dict(every=4, keep=9), 10),
    "halo_2x1_overlap": (dict(interior=(8, 16), mesh_shape=(2, 1),
                              overlap="on"),
                         [dict(step=6, kind="halo_slab", axis=0)], 3,
                         dict(every=4, keep=9), 10),
    "device_loss_2x2": (dict(interior=(8, 8), mesh_shape=(2, 2)),
                        [dict(step=6, kind="device_loss", survivors=2)], 0,
                        dict(every=4, keep=9), 10),
}

# The reference run each mesh plan's log is compared with: its overlapped
# halo fault is held to the same log as the monolithic sweep's (as
# tests/test_resilience.py holds it), so the oracle runs that plan once.
JAX_MESH_PLAN = {"halo_2x1": "halo_2x1", "halo_2x1_overlap": "halo_2x1",
                 "device_loss_2x2": "device_loss_2x2"}

# The event fields compared with the reference's log (wall times, error
# texts and paths are the run's own).
LOG_FIELDS = ("kind", "step", "iteration", "retry", "error_type",
              "failed_at", "rolled_back_to", "devices", "replay_steps",
              "retries", "reason")


def log_view(log) -> list:
    return [{k: e[k] for k in LOG_FIELDS if k in e} for e in log]
