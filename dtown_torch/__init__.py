"""dtown_torch: the Duckietown environment engine on PyTorch and CUDA.

The port of the JAX package ``dtown`` to an NVIDIA H100: the fused RGB
rollout (state step + blob render) runs through two hand-written CUDA
kernels (csrc/), each with a plain torch version that the CPU runs.
"""
from dtown_torch.map_loader import load_map
from dtown_torch.ops.fused_env import make_fused_rollout
from dtown_torch.types import EnvConfig

__all__ = ["EnvConfig", "load_map", "make_fused_rollout"]
