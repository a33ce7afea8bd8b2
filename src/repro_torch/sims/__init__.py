"""Port of ``repro.sims``.  Ported: the 2-D sims ``cell_clustering``,
``epidemiology``, ``sir_mechanics``, ``cell_proliferation`` and
``oncology``.  ``tumor_spheroid`` (3-D) comes with ROADMAP A5's queue
item 4."""
