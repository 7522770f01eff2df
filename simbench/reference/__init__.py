"""The plain reference that decides ``correct``: plain torch and numpy, no
kernel. It imports nothing of the program and reads what the program made
only to judge it.

- ``town.py``: the map YAML's rules (gym-duckietown's), written alone; it
  judges the program's compiled map and every spawn pose it makes.
- ``learner.py``: the NatureCNN actor-critic, the Gaussian policy, GAE, the
  PPO loss, clipping and Adam, written from their equations.
- ``frozen/``: a copy of the port's plain versions of its two CUDA kernels,
  the state step (K1) and the blob render (K2), with what feeds them (map
  compile, tables, render plan, reset), taken at commit ddda995 with the
  imports rewritten: the kernels' oracles, exact to the bit.
- ``fused.py``, ``ppo.py``: each cell's reference and its control, built
  from those; ``maps/``: the YAMLs.
"""
