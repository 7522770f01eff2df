"""The ranks that train together, over torch.distributed.

Counterpart of dtown/parallel/mesh.py. Where the reference builds a JAX
device mesh with an 'envs' axis, the port runs one process (a rank) per
card and joins them in the default process group: NCCL on the card, gloo
on the CPU. The env batch splits over the ranks in rank order, which is
the reference's row-major device order; parameters are replicated on
every rank.

Nothing here runs at import: ``make_mesh`` starts (or adopts) the group
when it is called. It reads what ``torchrun`` sets: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
without them it is a group of one on a free local port. ``spawn_ranks``
starts such processes itself, for tests and dry runs on one machine.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from dtown_torch.device import resolve_device

ENVS_AXIS = "envs"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the group: ``world`` ranks, this one ``rank``,
    its ``device``, the process ``group``, and the reference's mesh shape
    and axis names (``(world,)`` over 'envs', or ``(hosts, chips)``)."""

    world: int
    rank: int
    device: torch.device
    group: object
    shape: tuple
    axis_names: tuple

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(device="cuda", backend=None) -> Mesh:
    """Initialise (or adopt) the default process group and return this
    rank's Mesh over one 'envs' axis.

    ``device="cuda"`` puts the rank on ``cuda:LOCAL_RANK`` with NCCL;
    a device with an index (``"cuda:0"``) is taken as given;
    ``device="cpu"`` runs gloo. ``backend`` overrides the choice (gloo
    with CUDA tensors runs several ranks on one card, which NCCL
    refuses). There is no fallback from one backend to the other."""
    dev = resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
        addr = os.environ.get("MASTER_ADDR", "localhost")
        port = os.environ.get("MASTER_PORT")
        if port is None:
            if world != 1:
                raise RuntimeError("WORLD_SIZE > 1 needs MASTER_ADDR and "
                                   "MASTER_PORT (torchrun sets them)")
            port = str(free_port())
        kw = dict(device_id=dev) if dev.type == "cuda" and \
            (backend or "nccl") == "nccl" else {}
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank,
            **kw)
    world = dist.get_world_size()
    return Mesh(world, dist.get_rank(), dev, dist.group.WORLD, (world,),
                (ENVS_AXIS,))


def make_mesh_hier(n_hosts: int, device="cuda", backend=None) -> Mesh:
    """make_mesh with the reference's (hosts, chips) split of the ranks
    kept in ``shape``. The env batch still splits over every rank in rank
    order, and the reductions stay one flat all_reduce over the world: a
    mean over all ranks equals the reference's pmean over both axes (its
    ICI-then-DCN order is a schedule, not another result)."""
    mesh = make_mesh(device, backend)
    if mesh.world % n_hosts:
        raise ValueError(f"{mesh.world} ranks do not split over {n_hosts} "
                         f"hosts")
    return dataclasses.replace(mesh, shape=(n_hosts, mesh.world // n_hosts),
                               axis_names=("hosts", "chips"))


def env_axes(mesh: Mesh) -> tuple:
    """Every mesh axis, in order: the env batch splits over all of them."""
    return tuple(mesh.axis_names)


def env_sharding(mesh: Mesh, num_envs: int) -> slice:
    """This rank's slice of a global batch of ``num_envs`` envs:
    ``num_envs // world`` envs in rank order."""
    if num_envs % mesh.world:
        raise ValueError(f"num_envs={num_envs} does not divide over "
                         f"{mesh.world} ranks")
    per = num_envs // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def replicated(mesh: Mesh) -> slice:
    """The part of a replicated value (parameters, maps) a rank holds:
    all of it."""
    return slice(None)


def gather_envs(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's slice of an env-batched tensor, concatenated on
    ``dim`` in rank order (the global batch), on every rank."""
    if mesh.world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim)


def spawn_ranks(n: int, argv, timeout: float = 600.0, env=None,
                cwd=None):
    """Run ``python *argv`` as ``n`` ranks of one group on this machine
    (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR=localhost and a free
    MASTER_PORT set as torchrun would). Waits at most ``timeout`` seconds
    for all of them; when a rank fails or the time is up, every rank
    still running is killed. Returns each rank's (stdout, stderr); raises
    RuntimeError if a rank failed or timed out."""
    port = str(free_port())
    procs, files = [], []
    try:
        for r in range(n):
            e = dict(os.environ if env is None else env, RANK=str(r),
                     LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                     MASTER_ADDR="localhost", MASTER_PORT=port)
            out, err = tempfile.TemporaryFile("w+"), \
                tempfile.TemporaryFile("w+")
            files.append((out, err))
            procs.append(subprocess.Popen([sys.executable, *argv], env=e,
                                          cwd=cwd, text=True, stdout=out,
                                          stderr=err))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for out, err in files:
            out.seek(0)
            err.seek(0)
            outs.append((out.read(), err.read()))
            out.close()
            err.close()
    # the ranks that failed on their own first, then those killed after
    bad = sorted((r for r, p in enumerate(procs) if p.returncode != 0),
                 key=lambda r: procs[r].returncode < 0)
    if bad:
        raise RuntimeError("\n".join(
            f"rank {r} of {n} exited with {procs[r].returncode} (negative: "
            f"killed at the {timeout} s limit or after another rank "
            f"failed):\n{outs[r][0][-2000:]}\n{outs[r][1][-3000:]}"
            for r in bad))
    return outs
