"""Port of ``repro.sims``: every bundled sim - the 2-D ``cell_clustering``,
``epidemiology``, ``sir_mechanics``, ``cell_proliferation`` and
``oncology``, and the 3-D ``tumor_spheroid``."""
