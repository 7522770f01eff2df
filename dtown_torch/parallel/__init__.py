"""Training over torch.distributed ranks (counterpart of dtown/parallel)."""
from dtown_torch.parallel.mesh import (  # noqa: F401
    Mesh, env_axes, env_sharding, make_mesh, make_mesh_hier, replicated)
from dtown_torch.parallel.shard import (  # noqa: F401
    make_sharded_env, make_sharded_ppo)
