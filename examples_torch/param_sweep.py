"""Parameter sweep + ABC calibration through the scenario server on the
PyTorch port (the port of ``examples/param_sweep.py``).

1. **Sweep** - a grid over the infection rate ``beta`` of the
   ``sir_mechanics`` family, every point streamed as S/I/R frames from
   shared ensemble batches (one lane launch of the ``pair_sweep`` kernel a
   step for a batch on the card).
2. **Calibration** - approximate Bayesian computation (ABC rejection with
   a shrinking tolerance): a hidden "true" beta gives an observed attack
   rate; each round submits a batch of candidate betas, keeps those whose
   simulated attack rate lands within tolerance, and resamples around
   them.  The accepted cloud's mean is the fitted beta.

    PYTHONPATH=src python examples_torch/param_sweep.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.launch.serve import (
    ScenarioRequest, ScenarioServer, sir_mechanics_family,
)


def attack_rate(handle) -> float:
    """Final fraction of agents ever infected (I + R at the horizon)."""
    _, final = handle.frames[-1]
    final = np.asarray(final)
    return float(final[1] + final[2]) / float(final.sum())


def run_batch(server, betas, steps, seed0=0, stream_every=0):
    rids = [server.submit(ScenarioRequest(
                family="sir_mechanics", params={"beta": float(b)},
                steps=steps, stream_every=stream_every, seed=seed0 + i))
            for i, b in enumerate(betas)]
    server.drain()
    return [server.handle(r) for r in rids]


def main(device="cuda", n_agents=200, steps=20, slot=8, grid_points=8,
         rounds=3) -> dict:
    server = ScenarioServer([sir_mechanics_family(n_agents=n_agents,
                                                  device=device)],
                            slot_size=slot)

    # -- 1. sweep ----------------------------------------------------------
    grid = np.linspace(0.01, 0.15, grid_points)
    print(f"sweep: {len(grid)} beta points, {steps} steps each")
    sweep = []
    for h in run_batch(server, grid, steps, stream_every=10):
        curve = " ".join(f"t={s}:I={int(f[1])}" for s, f in h.frames)
        sweep.append(attack_rate(h))
        print(f"  beta={h.request.params['beta']:.3f}  {curve}  "
              f"attack={sweep[-1]:.2f}")

    # -- 2. ABC calibration -----------------------------------------------
    # a target on the steep part of the response curve
    rng = np.random.default_rng(7)
    true_beta = 0.04
    [obs_handle] = run_batch(server, [true_beta], steps, seed0=100)
    target = attack_rate(obs_handle)
    print(f"\ncalibration target: attack rate {target:.2f} "
          f"(hidden beta={true_beta})")

    lo, hi = 0.005, 0.2
    candidates = rng.uniform(lo, hi, slot)
    accepted = []
    for rnd, tol in enumerate((0.15, 0.08, 0.04)[:rounds]):
        handles = run_batch(server, candidates, steps,
                            seed0=200 + rnd * slot)
        scored = [(abs(attack_rate(h) - target),
                   h.request.params["beta"]) for h in handles]
        hits = [b for d, b in scored if d <= tol]
        accepted = hits or [min(scored)[1]]
        # resample around the surviving cloud (ABC-SMC style jitter)
        width = max((hi - lo) * 0.5 ** (rnd + 1), 0.01)
        candidates = np.clip(
            rng.choice(accepted, slot) + rng.normal(0, width / 4, slot),
            lo, hi)
        print(f"  round {rnd}: tol={tol:.2f} accepted "
              f"{len(hits)}/{len(handles)} -> "
              f"beta in [{min(accepted):.3f}, {max(accepted):.3f}]")

    fit = float(np.mean(accepted))
    print(f"fitted beta = {fit:.3f} (true {true_beta})")

    st = server.stats()
    rc = st["caches"]["ensemble.runner"]
    print(f"\nserver: {st['batches']} batches, mean occupancy "
          f"{st['mean_occupancy']:.2f}, runner cache {rc['hits']}h/"
          f"{rc['misses']}m - every batch after the first reused the "
          "ensemble runner")
    return dict(sweep=sweep, target=target, fit=fit,
                batches=st["batches"], runner_cache=rc)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(device=ap.parse_args().device)
