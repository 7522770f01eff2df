"""dtown_torch.learn.networks against dtown.learn.networks (flax), with the
flax parameters carried across by convert.params_from_flax: the forward
pass of every trunk and observation kind, the initializers' statistics,
and one recurrent step."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dtown.learn import networks as jnet

from dtown_torch.convert import params_from_flax
from dtown_torch.learn import networks as tnet

# Outputs agree within two bf16 ulps (2^-7) of the output's scale: both
# trunks round every layer to bf16 and accumulate in f32 in another order,
# so an intermediate near a rounding boundary can land one ulp apart.
BF16_TOL = 2.0 ** -7


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_obs(obs):
    if isinstance(obs, tuple):
        return tuple(torch.from_numpy(o) for o in obs)
    return torch.from_numpy(obs)


def _obs(kind, size, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "state":
        return rng.standard_normal((8, 11)).astype(np.float32)
    img = rng.integers(0, 256, (8, size, size, 1 if kind == "gray" else 3),
                       dtype=np.uint8)
    if kind == "pair":
        return img, rng.standard_normal((8, 3)).astype(np.float32)
    return img


def _shape(obs):
    if isinstance(obs, tuple):
        return tuple(o.shape[1:] for o in obs)
    return obs.shape[1:]


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=BF16_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("trunk,kind,size", [
    ("nature", "rgb", 32), ("nature", "rgb", 64), ("nature", "gray", 32),
    ("nature", "gray", 64), ("impala", "rgb", 32), ("impala", "rgb", 64),
    ("impala", "gray", 32), ("impala", "gray", 64), ("nature", "state", 0),
    ("impala", "state", 0), ("nature", "pair", 32)])
def test_actor_critic_matches_flax(trunk, kind, size):
    """mean, log_std and value of the port's ActorCritic with flax's
    parameters. 64x64 IMPALA pools with SAME padding (0, 1), not (1, 1);
    NatureCNN's SAME pads differ between 32 and 64."""
    obs = _obs(kind, size)
    jobs = jax.tree_util.tree_map(jnp.asarray, obs)
    net = jnet.ActorCritic(trunk=trunk)
    params = net.init(jax.random.PRNGKey(0), jobs)
    mean_j, log_std_j, value_j = net.apply(params, jobs)
    port = params_from_flax(_np(params),
                            tnet.ActorCritic(_shape(obs), trunk=trunk))
    with torch.no_grad():
        mean, log_std, value = port(_torch_obs(obs))
    assert mean.shape == (8, 2) and value.shape == (8,)
    assert mean.dtype == value.dtype == torch.float32
    _close(mean, mean_j)
    _close(value, value_j)
    np.testing.assert_array_equal(log_std.detach().numpy(), log_std_j)


def _layer_stds(tree, prefix=()):
    """{path: (kernel std, fan_in)} of every kernel in a params tree."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_layer_stds(v, prefix + (k,)))
        elif k == "kernel":
            a = np.asarray(v)
            out[prefix] = (float(a.std()), int(np.prod(a.shape[:-1])))
    return out


@pytest.mark.parametrize("trunk", ["nature", "impala"])
def test_initializers_match_flax(trunk):
    """Per layer the port's kernel std matches flax's (lecun-normal: 1 /
    sqrt(fan_in), truncated at 2 sigma; the heads orthogonal 0.01 and 1.0),
    biases start at zero and log_std at -0.5."""
    obs = _obs("rgb", 64)
    params = jnet.ActorCritic(trunk=trunk).init(jax.random.PRNGKey(3),
                                                jnp.asarray(obs))
    port = tnet.ActorCritic(obs.shape[1:], trunk=trunk,
                            generator=torch.Generator().manual_seed(3))
    want = _layer_stds(params["params"])
    sd = port.state_dict()
    for path, (std_j, fan_in) in want.items():
        w = sd[".".join(path) + ".weight"].numpy()
        # sampling spread of a std over n draws is ~1/sqrt(2n); the
        # smallest kernel (the 512x2 mean head) has 1024 entries
        assert abs(w.std() - std_j) <= 0.1 * std_j, (path, w.std(), std_j)
        if path[-1] in ("Dense_0", "Dense_1") and len(path) == 1:
            continue  # orthogonal heads
        lim = 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(w).max() <= lim * (1 + 1e-6), path
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.1, path
    for name in ("Dense_0", "Dense_1"):
        w = sd[name + ".weight"].numpy()
        gain = 0.01 if name == "Dense_0" else 1.0
        np.testing.assert_allclose(w @ w.T, gain ** 2 * np.eye(w.shape[0]),
                                   rtol=0, atol=1e-6 * max(gain ** 2, 1e-3))
    for k, v in sd.items():
        if k.endswith("bias"):
            assert (v == 0).all(), k
    np.testing.assert_array_equal(sd["log_std"].numpy(), [-0.5, -0.5])


@pytest.mark.parametrize("kind,size", [("state", 0), ("rgb", 32)])
def test_rnn_step_matches_flax(kind, size):
    """One ActorCriticRNN step from a nonzero carry: flax's (c, h) carry
    and OptimizedLSTMCell gates (input kernels without bias) carried across
    as weight_ih / weight_hh / bias_hh."""
    obs = _obs(kind, size, seed=1)
    rng = np.random.default_rng(2)
    carry = tuple(rng.standard_normal((8, 64)).astype(np.float32) * 0.5
                  for _ in range(2))
    net = jnet.ActorCriticRNN(hidden=64)
    params = net.init(jax.random.PRNGKey(4), jnp.asarray(obs),
                      tuple(map(jnp.asarray, carry)))
    # non-zero hidden biases, so their place in the gates is tested
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.1 if p[-1].key == "bias" and p[-2].key.startswith(
            "h") else a, params)
    mean_j, log_std_j, value_j, (c_j, h_j) = net.apply(
        params, jnp.asarray(obs), tuple(map(jnp.asarray, carry)))
    port = params_from_flax(_np(params),
                            tnet.ActorCriticRNN(obs.shape[1:], hidden=64))
    with torch.no_grad():
        mean, log_std, value, (c, h) = port(
            torch.from_numpy(obs), tuple(map(torch.from_numpy, carry)))
    for got, want in ((mean, mean_j), (value, value_j), (c, c_j), (h, h_j)):
        _close(got, want)
    np.testing.assert_array_equal(log_std.detach().numpy(), log_std_j)
    z = port.initial_carry(5)
    assert all(t.shape == (5, 64) and not t.any() for t in z)


def test_params_from_flax_refuses_missing_and_extra_leaves():
    obs = _obs("state", 0)
    params = _np(jnet.ActorCritic().init(jax.random.PRNGKey(0),
                                         jnp.asarray(obs)))["params"]
    port = tnet.ActorCritic((11,))
    params_from_flax(params, port)          # the whole tree loads
    short = dict(params)
    del short["log_std"]
    with pytest.raises(ValueError, match="missing"):
        params_from_flax(short, port)
    extra = dict(params, Dense_9={"kernel": np.zeros((256, 1), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        params_from_flax(extra, port)
    wrong = dict(params, Dense_1={"kernel": np.zeros((256, 2), np.float32),
                                  "bias": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(wrong, port)


def test_unknown_trunk_raises():
    with pytest.raises(ValueError, match="unknown trunk"):
        tnet.ActorCritic((11,), trunk="resnet")
