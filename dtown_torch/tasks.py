"""Task layers over the vectorized env: the Nav task.

Counterpart of dtown/tasks.py. A Nav env carries a goal tile drawn
uniformly from its map's drivable tiles; entering it scores
NAV_GOAL_REWARD and ends the episode, and an auto-reset draws a fresh
goal. ``make_nav_vec`` is the batched step path's Nav (the vectorized
equivalent of gym_compat.DuckietownNav); the fused Nav rollout
(ops/fused_env.py ``make_fused_nav_rollout``) draws its first goals with
``draw_goal`` and redraws them inside the state kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dtown_torch import constants as C
from dtown_torch import env as env_core
from dtown_torch.device import resolve_device
from dtown_torch.types import EnvState, tree_where

GOAL_REWARD = C.NAV_GOAL_REWARD


def draw_goal(maps, map_idx, generator: torch.Generator):
    """Goal tiles (i, j), int32 [B, 2]: for env b a tile drawn uniformly
    from the drivable tiles of its map (member map_idx[b] of a stack; the
    map itself on a single map), from ``generator``, a torch.Generator on
    map_idx's device."""
    host = maps.numpy()
    grids = ([np.asarray(host.map_at(m).drivable) for m in range(host.n_maps)]
             if host.is_stack else [np.asarray(host.drivable)])
    W = grids[0].shape[1]
    flat = [np.flatnonzero(g) for g in grids]          # j * W + i
    table = np.zeros((len(flat), max(max(len(f) for f in flat), 1)),
                     np.int64)
    for m, f in enumerate(flat):
        table[m, :len(f)] = f
    dev = map_idx.device
    counts = torch.as_tensor([len(f) for f in flat], device=dev)
    mi = map_idx.long()
    n = counts[mi]
    u = torch.rand(map_idx.shape, generator=generator, device=dev,
                   dtype=torch.float64)
    k = torch.minimum((u * n).long(), torch.clamp(n - 1, min=0))
    tile = torch.as_tensor(table, device=dev)[mi, k]
    return torch.stack([tile % W, tile // W], -1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class NavState:
    """Nav state of a batch: the env states and the goal tiles (i, j),
    int32 [B, 2]."""

    env: EnvState
    goal: torch.Tensor

    def replace(self, **kw) -> "NavState":
        return dataclasses.replace(self, **kw)


def _tile_size(maps, map_idx):
    ts = maps.tile_size.to(torch.float32)
    return ts[map_idx.long()] if maps.is_stack else ts


def nav_reset(cfg, maps, generator: torch.Generator, num_envs: int,
              n_ok: int | None = None) -> NavState:
    """Fresh Nav states: env.reset, then a goal per env on its map."""
    st = env_core.reset(cfg, maps, generator, num_envs, n_ok)
    return NavState(st, draw_goal(maps, st.map_idx, generator))


def nav_step(cfg, maps, ns: NavState, action, generator=None, facts=None):
    """Env step + goal check of every env: entering the goal tile on a
    live episode adds GOAL_REWARD and ends it (plus, with
    cfg.nav_shaping_coef, the potential-based goal-distance shaping).
    The base step runs without auto-reset, so that one reset, drawn from
    ``generator``, serves the combined done (crash, horizon or goal); the
    reset envs get fresh goals. Returns (NavState, StepOutput with
    obs=None)."""
    base_cfg = dataclasses.replace(cfg, auto_reset=False)
    st, out, _ = env_core.step_physics(base_cfg, maps, ns.env, action,
                                       facts=facts)
    ts = _tile_size(maps, st.map_idx)
    tile_i = torch.floor(st.pos[:, 0] / ts).to(torch.int32)
    tile_j = torch.floor(st.pos[:, 2] / ts).to(torch.int32)
    reached = (tile_i == ns.goal[:, 0]) & (tile_j == ns.goal[:, 1]) \
        & ~out.done
    reward = out.reward + torch.where(reached, GOAL_REWARD, 0.0)
    if cfg.nav_shaping_coef:
        gx = (ns.goal[:, 0].to(torch.float32) + 0.5) * ts
        gz = (ns.goal[:, 1].to(torch.float32) + 0.5) * ts
        d_prev = torch.sqrt((gx - ns.env.pos[:, 0]) ** 2
                            + (gz - ns.env.pos[:, 2]) ** 2)
        d_next = torch.sqrt((gx - st.pos[:, 0]) ** 2
                            + (gz - st.pos[:, 2]) ** 2)
        reward = reward + cfg.nav_shaping_coef * (d_prev - d_next)
    done = out.done | reached
    goal = ns.goal
    if cfg.auto_reset:
        if generator is None:
            raise ValueError("auto_reset draws fresh states: pass the "
                             "torch.Generator of the batch")
        n_ok = None if facts is None else facts.n_ok
        fresh = env_core.reset(cfg, maps, generator, st.batch_size, n_ok)
        st = tree_where(done, fresh, st)
        goal = torch.where(done[:, None],
                           draw_goal(maps, st.map_idx, generator), goal)
    return NavState(st, goal), out.replace(reward=reward, done=done)


def goal_features(maps, ns: NavState):
    """Goal of every env in its agent's frame, f32 [B, 3]: the goal tile
    centre's offset (forward, right) and its distance."""
    st = ns.env
    ts = _tile_size(maps, st.map_idx)
    dx = (ns.goal[:, 0].to(torch.float32) + 0.5) * ts - st.pos[:, 0]
    dz = (ns.goal[:, 1].to(torch.float32) + 0.5) * ts - st.pos[:, 2]
    c = torch.cos(st.angle)
    s = torch.sin(st.angle)
    return torch.stack([dx * c - dz * s, dx * s + dz * c,
                        torch.sqrt(dx * dx + dz * dz)], -1)


def make_nav_vec(cfg, maps, num_envs: int, goal_in_obs: bool = False,
                 device="cuda"):
    """(v_reset, v_step) of the Nav task over ``num_envs`` envs on
    ``device`` (the card unless ``device="cpu"``), the vectorized
    gym_compat.DuckietownNav. v_reset(generator) -> NavState; v_step(ns,
    actions) -> (NavState, StepOutput with obs from env.render_obs_batch).
    goal_in_obs appends goal_features to state vectors (11 -> 14 columns)
    and makes camera observations the pair (frames, goal f32 [B, 3])."""
    dev = resolve_device(device)
    env_core.check_scope(cfg, maps)
    maps_d = maps.to(dev)
    facts = env_core.host_facts(cfg, maps_d)
    pack = env_core.row_pack(cfg, maps_d)
    batch = {}

    def v_reset(generator: torch.Generator) -> NavState:
        batch["generator"] = generator
        return nav_reset(cfg, maps_d, generator, num_envs, facts.n_ok)

    def v_step(ns, actions):
        gen = batch.get("generator")
        if gen is None and cfg.auto_reset:
            raise RuntimeError("call v_reset(generator) before v_step")
        ns, out = nav_step(cfg, maps_d, ns, actions, generator=gen,
                           facts=facts)
        obs = env_core.render_obs_batch(cfg, maps_d, ns.env, pack=pack)
        if goal_in_obs:
            feats = goal_features(maps_d, ns)
            obs = (torch.cat([obs, feats], -1) if cfg.obs_type == "state"
                   else (obs, feats))
        return ns, out.replace(obs=obs)

    v_step.maps, v_step.pack, v_step.facts = maps_d, pack, facts
    return v_reset, v_step
