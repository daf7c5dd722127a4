from . import (contact, dynamics, engine, engine_core, megakernel, model,  # noqa: F401
               spatial, spatial3)
from .engine import PhysicsState, SolverOpts  # noqa: F401
from .model import RobotModel, load_t1  # noqa: F401
