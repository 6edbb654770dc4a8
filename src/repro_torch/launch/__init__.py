"""Launchers: mesh definitions, the multi-pod dry-run, train and serve
CLIs."""
from repro_torch.launch.mesh import make_production_mesh  # noqa: F401
