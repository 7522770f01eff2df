"""PPO data-parallel over torch.distributed ranks (dtown_torch.parallel)
against the reference's shard_map + pmean, and on the port itself.

Against dtown: two gloo ranks each take the port's PPO loss on their own
minibatch and average the gradients with learn.ppo.pmean_grads_ (the
all_reduce the sharded learner runs before every clip + Adam step); the
reference takes its loss on the same two minibatches inside jax.shard_map
over two of the suite's eight virtual CPU devices and pmeans the
gradients. Both start from the same parameters (params_from_flax). The
averaged gradients are held to tests/test_torch_ppo_math.py's bars, then
one clip + Adam step on them to that file's 1e-7 against optax.

On the port: the parameters stay bit-identical across ranks through two
step-path iterations; make_sharded_env on a stack keeps env b of the
global batch on member b % n_maps; one fused RGB iteration runs at 2
ranks x 8 envs 32x32 (the plain K1 and K2 on the CPU); a world of one
draws and learns exactly what the unsharded learner does.

The ranks are processes running this file (``python test_torch_shard.py
<mode> <dir>``), started by parallel.mesh.spawn_ranks with a time limit.
"""
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
TIMEOUT = 300.0
KINDS = ("rgb",)


def _spawn(n, mode, tmp):
    from dtown_torch.parallel.mesh import spawn_ranks

    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]))
    return spawn_ranks(n, [os.path.abspath(__file__), mode, str(tmp)],
                       timeout=TIMEOUT, env=env)


# ---- the ranks ---------------------------------------------------------------

def _rank_grads(tmp):
    """Each rank: the port's loss on its own minibatch, the gradients
    averaged over the ranks, then one clip + Adam step."""
    import torch.distributed as dist

    from dtown_torch.learn import networks as tnet
    from dtown_torch.learn import ppo as tppo
    from dtown_torch.parallel.mesh import make_mesh

    mesh = make_mesh("cpu")
    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=True)
    out = {}
    for kind in KINDS:
        d = inp[kind]
        net = tnet.ActorCritic(tuple(d["shape"]))
        net.load_state_dict(d["params"])
        ppo = tppo.PPOConfig()
        batch = {k: v[mesh.rank] for k, v in d["batch"].items()}
        loss, _ = tppo.ppo_loss(net, batch, ppo)
        loss.backward()
        params = list(net.parameters())
        tppo.pmean_grads_(params, mesh.group)
        grads = {k: p.grad.clone() for k, p in net.named_parameters()}
        opt = tppo.make_optimizer(net, ppo)
        tppo.clip_by_global_norm_(params, ppo.max_grad_norm)
        opt.step()
        out[kind] = dict(grads=grads, params={
            k: p.detach().clone() for k, p in net.named_parameters()})
    torch.save(out, os.path.join(tmp, f"out{mesh.rank}.pt"))
    dist.destroy_process_group()


def _rank_port(tmp):
    """Each rank: two sharded step-path iterations, a sharded stack's
    first map indices and one fused RGB iteration."""
    import torch.distributed as dist

    import dtown_torch
    from dtown_torch import EnvConfig, load_map
    from dtown_torch.learn.ppo import PPOConfig
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.parallel.shard import make_sharded_env, make_sharded_ppo

    mesh = make_mesh("cpu")
    ppo = PPOConfig(rollout_len=4, epochs=1, minibatches=2)
    out = {}
    _, init, train = make_sharded_ppo(EnvConfig(obs_type="state"),
                                      load_map("small_loop"), 16, ppo, mesh)
    ts = init(0)
    out["start"] = {k: v.clone() for k, v in ts.net.state_dict().items()}
    for _ in range(2):
        ts, metrics = train(ts)
    out["step"] = ts.net.state_dict()
    out["step_metrics"] = metrics
    _, reset, _ = make_sharded_env(
        EnvConfig(obs_type="state"),
        dtown_torch.stack_maps(["small_loop", "loop_empty", "zigzag_dists"]),
        16, mesh)
    out["map_idx"] = reset(1).map_idx
    _, init, train = make_sharded_ppo(
        EnvConfig(camera_width=32, camera_height=32),
        load_map("loop_obstacles"), 16, ppo, mesh, fused=True)
    ts = init(2)
    ts, metrics = train(ts)
    out["fused"] = ts.net.state_dict()
    out["fused_metrics"] = metrics
    out["fused_blob"] = ts.env_states[0]
    torch.save(out, os.path.join(tmp, f"out{mesh.rank}.pt"))
    dist.destroy_process_group()


def _rank_world1(tmp):
    """A world of one against the unsharded learner from the same seed:
    the step path and the fused rollout, one iteration each."""
    import torch.distributed as dist

    from dtown_torch import EnvConfig, load_map
    from dtown_torch.learn.ppo import PPOConfig, make_ppo
    from dtown_torch.parallel.mesh import make_mesh
    from dtown_torch.parallel.shard import make_sharded_ppo

    mesh = make_mesh("cpu")
    ppo = PPOConfig(rollout_len=4, epochs=1, minibatches=2)
    out = {}
    for tag, fused in (("step", False), ("fused", True)):
        cfg = EnvConfig(obs_type="state")
        maps = load_map("loop_obstacles")
        _, s_init, s_train = make_sharded_ppo(cfg, maps, 8, ppo, mesh,
                                              fused=fused)
        u_init, u_train = make_ppo(cfg, maps, 8, ppo, fused=fused,
                                   device="cpu")
        ts_s, m_s = s_train(s_init(7))
        ts_u, m_u = u_train(u_init(torch.Generator().manual_seed(7)))
        out[tag] = (ts_s.net.state_dict(), ts_u.net.state_dict(),
                    {k: float(v) for k, v in m_s.items()},
                    {k: float(v) for k, v in m_u.items()})
    torch.save(out, os.path.join(tmp, "out0.pt"))
    dist.destroy_process_group()


# ---- the tests -----------------------------------------------------------------

def _reference_pmean(kind, n=64):
    """(port parameters, per-rank batches, the reference's pmean'd
    gradients in the port's layout, the obs shape)."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from dtown.learn import networks as jnet
    from dtown.learn.ppo import PPOConfig as JPPOConfig
    from dtown_torch.convert import params_from_flax
    from dtown_torch.learn import networks as tnet
    from test_torch_ppo_math import _batch, _jax_loss

    b0, b1 = _batch(kind, n, seed=10), _batch(kind, n, seed=11)
    stacked = {k: np.stack([b0[k], b1[k]]) for k in b0}
    net = jnet.ActorCritic()
    params = net.init(jax.random.PRNGKey(0), jnp.asarray(b0["obs"][:2]))
    loss_fn = _jax_loss(net, JPPOConfig())

    def per_shard(params, batch):
        g = jax.grad(loss_fn)(params, jax.tree_util.tree_map(
            lambda x: x[0], batch))
        return jax.lax.pmean(g, "envs")

    mesh = Mesh(np.array(jax.devices()[:2]), ("envs",))
    f = shard_map(per_shard, mesh=mesh, in_specs=(P(), P("envs")),
                  out_specs=P(), check_vma=False)
    grads = jax.jit(f)(params, jax.tree_util.tree_map(jnp.asarray, stacked))
    shape = b0["obs"].shape[1:]
    port = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                            tnet.ActorCritic(shape))
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                            tnet.ActorCritic(shape))
    return port, stacked, want, shape


def test_pmean_grads_match_reference(tmp_path):
    """The averaged gradients of both ranks within test_torch_ppo_math's
    bars of the reference's pmean (log_std 1e-5, the heads 1e-3, the
    bf16 layers' kernels 2% and biases 8%, in norm), equal on both ranks;
    then one clip + Adam step on them within 1e-7 of optax's on the same
    gradients, the same on both ranks."""
    import jax.numpy as jnp
    import optax

    from dtown.learn.ppo import PPOConfig as JPPOConfig

    refs, inp = {}, {}
    for kind in KINDS:
        port, stacked, want, shape = _reference_pmean(kind)
        refs[kind] = (port, want)
        inp[kind] = dict(shape=list(shape), params=port.state_dict(),
                         batch={k: torch.from_numpy(v)
                                for k, v in stacked.items()})
    torch.save(inp, tmp_path / "in.pt")
    _spawn(2, "grads", tmp_path)
    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=True)
            for r in range(2)]
    ppo = JPPOConfig()
    for kind in KINDS:
        port, want = refs[kind]
        got = outs[0][kind]
        for k in got["grads"]:
            assert torch.equal(got["grads"][k], outs[1][kind]["grads"][k])
            assert torch.equal(got["params"][k], outs[1][kind]["params"][k])
        heads = ("Dense_0.", "Dense_1.")
        for name, g in want.named_parameters():
            bar = (1e-5 if name == "log_std"
                   else 1e-3 if name.startswith(heads)
                   else 0.08 if name.endswith("bias") else 0.02)
            g = g.detach()
            err = float((got["grads"][name] - g).norm())
            assert err <= bar * float(g.norm()) + 1e-7, (kind, name, err)
        # one clip + Adam step of optax on the port's averaged gradients
        p0 = {k: jnp.asarray(v.detach().numpy())
              for k, v in port.named_parameters()}
        g = {k: jnp.asarray(v.numpy()) for k, v in got["grads"].items()}
        tx = optax.chain(optax.clip_by_global_norm(ppo.max_grad_norm),
                         optax.adam(ppo.lr))
        upd, _ = tx.update(g, tx.init(p0), p0)
        p1 = optax.apply_updates(p0, upd)
        for k, v in got["params"].items():
            np.testing.assert_allclose(
                v.numpy(), np.asarray(p1[k]), rtol=0,
                atol=1e-7 * max(1.0, float(np.abs(p0[k]).max())))


def test_sharded_port_keeps_ranks_identical(tmp_path):
    """Two ranks: parameters bit-identical after two step-path iterations
    (and changed from the start); a stack's map index follows the global
    env index; one fused RGB iteration at 2 x 8 envs 32x32 keeps the
    ranks identical with finite metrics, each rank on its own envs."""
    _spawn(2, "port", tmp_path)
    o0, o1 = [torch.load(tmp_path / f"out{r}.pt", weights_only=True)
              for r in range(2)]
    for k in o0["step"]:
        assert torch.equal(o0["start"][k], o1["start"][k]), k
        assert torch.equal(o0["step"][k], o1["step"][k]), k
    for k in o0["fused"]:
        assert torch.equal(o0["fused"][k], o1["fused"][k]), k
    assert any(not torch.equal(o0["start"][k], o0["step"][k])
               for k in o0["step"])
    for key in ("step_metrics", "fused_metrics"):
        for k, v in o0[key].items():
            assert torch.isfinite(v) and torch.equal(v, o1[key][k]), (key, k)
    idx = torch.cat([o0["map_idx"], o1["map_idx"]])
    assert torch.equal(idx, torch.arange(16, dtype=torch.int32) % 3)
    assert o0["fused_blob"].shape[1] == 8
    assert not torch.equal(o0["fused_blob"], o1["fused_blob"])


def test_world_of_one_is_the_unsharded_learner(tmp_path):
    """make_sharded_ppo over one rank draws the unsharded learner's
    parameters, spawns and noise from the same seed, and its averaged
    step is the same: parameters and metrics equal bit for bit after one
    iteration, on the step path and the fused rollout."""
    _spawn(1, "world1", tmp_path)
    out = torch.load(tmp_path / "out0.pt", weights_only=True)
    for tag, (sharded, alone, m_s, m_u) in out.items():
        for k in alone:
            assert torch.equal(sharded[k], alone[k]), (tag, k)
        assert m_s == m_u, tag


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"grads": _rank_grads, "port": _rank_port,
     "world1": _rank_world1}[sys.argv[1]](sys.argv[2])
