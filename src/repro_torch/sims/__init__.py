"""Port of ``repro.sims``.  Ported: ``cell_clustering``.  The other bundled
sims (``cell_proliferation``, ``epidemiology``, ``oncology``,
``sir_mechanics``, ``tumor_spheroid``) need the RNG and spawn path and
come with ROADMAP A5."""
