from . import generators  # noqa: F401
from .terrain import Terrain, TerrainCfg, flat_heightfield  # noqa: F401
