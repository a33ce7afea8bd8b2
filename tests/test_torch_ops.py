"""``kernels.ops.neighborhood_pair_sweep`` of the port against the JAX
package's, on the CPU.

The reference's op runs the TPU kernel ``pair_sweep_kernel`` on gathered
slabs, here in interpret mode as the reference's tests run it; the port's
runs its plain version on a CPU tensor (the card's kernel,
``neighborhood_pair_sweep_kernel``, is held to that plain version in
``tests/test_torch_kernel.py`` and ``chip_smoke.py``).  Every law and
stack the kernel has, at D = 2 and 3, closed and toroidal: self slabs
``(C, K)`` against neighbourhood slabs ``(C, 3^D K)`` made from a seed
with numpy, each cell's own slots among its neighbours (the self pairs
the gids exclude).  Floats to 1e-5, counts exactly.
"""

import numpy as np
import pytest
import torch

import repro.core.behaviors as jbeh
import repro.kernels.ops as jops
import repro.sims.cell_clustering as jcc
import repro.sims.epidemiology as jepi
import repro.sims.oncology as jonc
import repro.sims.sir_mechanics as jsm
import repro.sims.tumor_spheroid as jts
import repro_torch.core.behaviors as tbeh
import repro_torch.kernels.ops as tops
import repro_torch.sims.cell_clustering as tcc
import repro_torch.sims.epidemiology as tepi
import repro_torch.sims.oncology as tonc
import repro_torch.sims.sir_mechanics as tsm
import repro_torch.sims.tumor_spheroid as tts
from repro_torch.kernels.neighbor_interaction import law_for
from torch_parity import assert_close

C, K = 6, 4
SIDE = 6.0          # the box the positions fill (and wrap in, toroidal)


def _soft(pkg):
    beh = pkg[0]
    return (beh.soft_repulsion_adhesion,
            {"repulsion": 2.0, "adhesion": 0.6, "same_type_only": 1.0}, 2.0)


def _fn(pair_fn, params, radius):
    return lambda pkg: (getattr(pkg[pair_fn[0]], pair_fn[1]), params, radius)


def _behavior(make):
    def get(pkg):
        b = make(pkg)
        return b.pair_fn, b.params, b.radius
    return get


# law -> (the package modules -> (pair_fn, params, radius)); each package
# is (behaviors, cell_clustering, epidemiology, oncology, tumor_spheroid,
# sir_mechanics)
LAWS = {
    "soft_repulsion_adhesion": _soft,
    "same_type": _fn((1, "_same_type_pair"), {}, 2.0),
    "epidemiology": _fn((2, "_pair"), {}, 2.0),
    "oncology": _fn((3, "_pair"),
                    {"repulsion": 1.5, "adhesion": 0.3,
                     "same_type_only": 0.0}, 2.0),
    "crowd": _fn((4, "_crowd_pair"), {}, 1.5),
    "gated_epidemiology": _fn((5, "_gated_sir_pair"), {"sir_radius": 1.2},
                              2.0),
    "stack(soft_repulsion_adhesion,epidemiology)": _behavior(
        lambda pkg: pkg[5].behavior()),
    "stack(soft_repulsion_adhesion,crowd)": _behavior(
        lambda pkg: pkg[4].behavior()),
    "stack(soft_repulsion_adhesion,gated_epidemiology)": _behavior(
        lambda pkg: pkg[5].ensemble_behavior(pkg[5].ensemble_defaults())),
}
JAX = (jbeh, jcc, jepi, jonc, jts, jsm)
PORT = (tbeh, tcc, tepi, tonc, tts, tsm)


def slabs(ndim: int, seed: int):
    """numpy self slabs (C, K) and neighbourhood slabs (C, 3^D K): every
    column a law reads; each cell's own slots sit in the middle block of
    its neighbourhood, as ``gather_neighborhood`` puts them."""
    rng = np.random.default_rng(seed)
    nk = 3 ** ndim * K

    def cols(n):
        return {
            "pos": rng.uniform(0.0, SIDE, (C, n, ndim)).astype(np.float32),
            "gid_rank": rng.integers(0, 2, (C, n)).astype(np.int32),
            "gid_count": rng.integers(0, 1000, (C, n)).astype(np.int32),
            "diameter": rng.uniform(0.8, 1.2, (C, n)).astype(np.float32),
            "ctype": rng.integers(0, 2, (C, n)).astype(np.int32),
            "state": rng.integers(0, 3, (C, n)).astype(np.int32),
        }

    ai, aj = cols(K), cols(nk)
    vi = rng.random((C, K)) < 0.7
    vj = rng.random((C, nk)) < 0.6
    mid = (3 ** ndim // 2) * K
    for name in ai:
        aj[name][:, mid:mid + K] = ai[name]
    vj[:, mid:mid + K] = vi
    return ai, aj, vi, vj


@pytest.mark.parametrize("boundary", ["closed", "toroidal"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("law", sorted(LAWS))
def test_neighborhood_pair_sweep_matches_jax(law, ndim, boundary):
    import jax.numpy as jnp

    ai, aj, vi, vj = slabs(ndim, seed=len(law) + 10 * ndim)
    box = (SIDE,) * ndim if boundary == "toroidal" else None
    jfn, jparams, radius = LAWS[law](JAX)
    tfn, tparams, tradius = LAWS[law](PORT)
    assert tradius == radius and law_for(tfn).name == law
    want = jops.neighborhood_pair_sweep(
        {n: jnp.asarray(a) for n, a in ai.items()},
        {n: jnp.asarray(a) for n, a in aj.items()},
        jnp.asarray(vi), jnp.asarray(vj), pair_fn=jfn, radius=radius,
        params=jparams, box=box, interpret=True)
    got = tops.neighborhood_pair_sweep(
        {n: torch.from_numpy(a) for n, a in ai.items()},
        {n: torch.from_numpy(a) for n, a in aj.items()},
        torch.from_numpy(vi), torch.from_numpy(vj), pair_fn=tfn,
        radius=radius, params=tparams, box=box, block_cells=4,
        interpret=True)
    assert set(got) == set(want) == {n for n, _ in law_for(tfn).outputs}
    counted = 0
    for name, w in want.items():
        w = np.asarray(w)
        # forces to 1e-5 (FLOAT_TOL), counts exactly
        count = name.split(".")[-1] != "force"
        assert_close(got[name], w, name, exact=count)
        if count:
            counted += int(w.sum())
        assert np.abs(w).sum() > 0, f"{name}: no pair counted"
    if law != "soft_repulsion_adhesion":
        assert counted > 0


def test_unknown_pair_fn_runs_on_the_cpu_only():
    """A pair function without a device law runs its plain version on a
    CPU tensor (as JAX's op runs any pair_fn)."""
    ai, aj, vi, vj = slabs(2, seed=3)

    def near(attrs_i, attrs_j, disp, dist2, params):
        return {"near": torch.ones_like(dist2)}

    got = tops.neighborhood_pair_sweep(
        {n: torch.from_numpy(a) for n, a in ai.items()},
        {n: torch.from_numpy(a) for n, a in aj.items()},
        torch.from_numpy(vi), torch.from_numpy(vj), pair_fn=near,
        radius=2.0, params={})
    assert got["near"].shape == (C, K) and got["near"].sum() > 0
    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        law_for(near)
