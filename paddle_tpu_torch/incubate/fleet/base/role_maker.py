"""fleet 1.x role makers (reference incubate/fleet/base/role_maker.py) —
re-exports the 2.0 role-maker implementations (same env contract)."""
from ....distributed.fleet.base.role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, UserDefinedRoleMaker)

MPISymetricRoleMaker = PaddleCloudRoleMaker  # MPI rendezvous subsumed
