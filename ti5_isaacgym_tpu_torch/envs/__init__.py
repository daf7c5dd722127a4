from . import legged, types  # noqa: F401
from .t1_dh_stand import T1DHStandEnv  # noqa: F401
