"""Architecture registry of the port: importing this package registers the
dense GQA configurations ported so far (exact published numbers plus their
smoke reductions).  The other eight of ``repro/configs`` wait for their
model families (ROADMAP A12)."""

from repro_torch.configs import internlm2_20b, olmo_1b  # noqa: F401
from repro_torch.configs.base import ArchConfig, ArchSpec, get, names  # noqa: F401
