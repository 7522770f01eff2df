"""The PPO arithmetic of dtown_torch.learn.ppo against the reference's:
the clipped-surrogate loss and its gradients on one fixed batch (against
jax.value_and_grad of dtown.learn.ppo's loss on flax's network), GAE on a
fixed trajectory with dones, and global-norm clipping + Adam against
optax. The reference's loss and GAE are closures inside make_ppo, so the
reference side below spells out their bodies (dtown/learn/ppo.py:163-195)."""
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown.learn import networks as jnet
from dtown.learn.ppo import PPOConfig as JPPOConfig

from dtown_torch.convert import params_from_flax
from dtown_torch.learn import networks as tnet
from dtown_torch.learn import ppo as tppo


def _jax_loss(net, ppo):
    """dtown.learn.ppo's loss_fn (the fused path's, :364-390)."""
    def loss_fn(params, batch):
        mean, log_std, value = net.apply(params, batch["obs"])
        std = jnp.exp(log_std)
        logp = -0.5 * jnp.sum(
            ((batch["action"] - mean) / std) ** 2 + 2.0 * log_std
            + jnp.log(2.0 * jnp.pi), axis=-1)
        ratio = jnp.exp(logp - batch["logp"])
        adv = batch["adv"]
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        pg = -jnp.minimum(
            ratio * adv,
            jnp.clip(ratio, 1 - ppo.clip_eps, 1 + ppo.clip_eps) * adv,
        ).mean()
        v_loss = 0.5 * ((value - batch["ret"]) ** 2).mean()
        ent = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
        return pg + ppo.vf_coef * v_loss - ppo.ent_coef * ent
    return loss_fn


def _batch(kind, n=64, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "state":
        obs = rng.standard_normal((n, 11)).astype(np.float32)
    else:
        obs = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
        if kind == "pair":
            obs = (obs, rng.standard_normal((n, 3)).astype(np.float32))
    return dict(obs=obs,
                action=rng.standard_normal((n, 2)).astype(np.float32),
                logp=(rng.standard_normal(n) - 2.0).astype(np.float32),
                adv=rng.standard_normal(n).astype(np.float32) * 3.0 + 0.5,
                ret=rng.standard_normal(n).astype(np.float32))


def _to(tree, fn):
    return {k: tuple(map(fn, v)) if isinstance(v, tuple) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["rgb", "state", "pair"])
def test_loss_and_grads_match_jax(kind):
    """Loss within 1e-4 relative. Gradients, in norm: log_std within 1e-5,
    the float32 heads within 1e-3 (their input, the bf16 trunk's output,
    can differ by an ulp in places), the bf16 layers' kernels within 2% (bf16
    activations and cotangents on both sides), their biases within 8%:
    the reference sums a bf16 bias's cotangent over batch and pixels in
    bf16, where torch accumulates in f32 (on this batch the first conv's
    bias gradient reads 0.2% from the exact sum of the port's own
    cotangent, the reference's 4.6%)."""
    ppo = JPPOConfig()
    b = _batch(kind)
    jb = _to(b, jnp.asarray)
    net = jnet.ActorCritic()
    params = net.init(jax.random.PRNGKey(0),
                      jax.tree_util.tree_map(lambda a: a[:2], jb["obs"]))
    loss_j, grads_j = jax.value_and_grad(_jax_loss(net, ppo))(params, jb)
    shape = (tuple(o.shape[1:] for o in b["obs"]) if kind == "pair"
             else b["obs"].shape[1:])
    port = params_from_flax(jax.tree_util.tree_map(np.asarray, params),
                            tnet.ActorCritic(shape))
    loss, ratio = tppo.ppo_loss(port, _to(b, torch.from_numpy), ppo)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    assert ratio.shape == (64,)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, grads_j),
                            tnet.ActorCritic(shape))
    heads = ("Dense_0.", "Dense_1.") if kind != "pair" else (
        "Dense_2.", "Dense_3.")
    for (name, p), (_, g) in zip(port.named_parameters(),
                                 want.named_parameters()):
        bar = (1e-5 if name == "log_std" else 1e-3 if name.startswith(heads)
               else 0.08 if name.endswith("bias") else 0.02)
        g = g.detach()
        err = float((p.grad - g).norm())
        assert err <= bar * float(g.norm()) + 1e-7, (name, err,
                                                     float(g.norm()))


def _jax_gae(traj, last_value, ppo):
    """dtown.learn.ppo's compute_gae (:141-161)."""
    def body(carry, t):
        gae, next_value = carry
        delta = (t["reward"] * ppo.reward_scale
                 + ppo.gamma * next_value * (1.0 - t["done"]) - t["value"])
        gae = delta + ppo.gamma * ppo.gae_lambda * (1.0 - t["done"]) * gae
        return (gae, t["value"]), gae

    _, adv = jax.lax.scan(body, (jnp.zeros_like(last_value), last_value),
                          traj, reverse=True)
    return adv, adv + traj["value"]


def test_gae_matches_reference():
    """Advantages and returns on a 24-step trajectory of 16 envs with
    dones (one env done at every step, one never) within 1e-6 of the
    reference's scan."""
    rng = np.random.default_rng(1)
    T, B = 24, 16
    reward = (rng.standard_normal((T, B)) * 3.0).astype(np.float32)
    done = rng.random((T, B)) < 0.1
    done[:, 0], done[:, 1] = True, False
    reward[done] = -1000.0
    value = rng.standard_normal((T, B)).astype(np.float32)
    last = rng.standard_normal(B).astype(np.float32)
    ppo = JPPOConfig()
    adv_j, ret_j = _jax_gae(dict(reward=jnp.asarray(reward),
                                 done=jnp.asarray(done, jnp.float32),
                                 value=jnp.asarray(value)),
                            jnp.asarray(last), ppo)
    adv, ret = tppo.gae(dict(reward=torch.from_numpy(reward),
                             done=torch.from_numpy(done),
                             value=torch.from_numpy(value)),
                        torch.from_numpy(last), ppo)
    scale = max(1.0, float(np.abs(adv_j).max()))
    np.testing.assert_allclose(adv.numpy(), adv_j, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ret.numpy(), ret_j, rtol=0, atol=1e-6 * scale)


def test_clip_and_adam_match_optax():
    """Three steps of optax.chain(clip_by_global_norm(0.5), adam(1e-3))
    against clip_by_global_norm_ + torch.optim.Adam, with gradient norms
    above, below and above max_grad_norm: parameters within 1e-7 after each
    step (Adam's arithmetic in another order), the clip bit for bit."""
    rng = np.random.default_rng(2)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 3, 2, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    ppo = JPPOConfig()
    tx = optax.chain(optax.clip_by_global_norm(ppo.max_grad_norm),
                     optax.adam(ppo.lr))
    pj = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(pj)
    params = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p0[k].copy())) for k in shapes])
    opt = tppo.make_optimizer(params, ppo)
    for step, scale in enumerate((3.0, 0.01, 1.0)):
        g = {k: (rng.standard_normal(s) * scale).astype(np.float32)
             for k, s in shapes.items()}
        norm = np.sqrt(sum(float((v.astype(np.float64) ** 2).sum())
                           for v in g.values()))
        assert (norm > ppo.max_grad_norm) == (step != 1)
        clipped, _ = optax.clip_by_global_norm(ppo.max_grad_norm).update(
            jax.tree_util.tree_map(jnp.asarray, g), optax.EmptyState())
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, pj)
        pj = optax.apply_updates(pj, updates)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k].copy())
        gn = tppo.clip_by_global_norm_(list(params), ppo.max_grad_norm)
        assert abs(float(gn) - norm) <= 1e-6 * norm
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.grad.numpy(), clipped[k], rtol=0,
                                       atol=1e-7 * max(1.0, scale))
        opt.step()
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.detach().numpy(), pj[k], rtol=0,
                                       atol=1e-7 * max(1.0, np.abs(p0[k]).max()))
