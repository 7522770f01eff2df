"""The port's IMPALA-CNN actor-critic (``ActorCritic(trunk="impala")``)
against the benchmark's plain reference, simbench/reference/impala.py,
which is written from the paper (Espeholt et al. 2018, Fig. 3) and not
from the port: the same initial parameters from one generator, then the
mean, the value, the PPO loss and each leaf's gradient on seeded frames
(4 frames at 32x32 and 64x64, three seeds). The reference's float8
control (every convolution's and the dense layer's operands rounded
through float8 e4m3) must fail the same bars."""
import pytest
import torch

from dtown_torch.learn import networks, ppo
from simbench.reference import impala

HP = ppo.PPOConfig()._asdict()
# The reference repeats the program's operations in the program's order
# (bfloat16 convolutions channels-last, the bias added to the bfloat16
# product, the same padding and pools) on the same CPU kernels, so the
# trunk's bits agree (mean and value read 0). What differs is the float32
# rounding of the policy's constants (log 2 pi, the entropy's term), which
# moves the loss, a sum of terms that partly cancel, and the gradients
# through it by a few 1e-7 relative (at most 5.2e-7 over these cases): a
# relative 1e-5 on the loss and on every leaf's gradient (by its norm
# against the larger of its own and the median leaf's) is that rounding
# with room, and three orders below what float8 operands move (1.2e-2 and
# more).
TOL = 1e-5


def _setup(size, seed):
    g = torch.Generator().manual_seed(seed)
    net = networks.ActorCritic((size, size, 3), trunk="impala", generator=g)
    p = impala.init_params((size, size, 3),
                           torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    n = 4
    batch = dict(
        obs=torch.randint(0, 256, (n, size, size, 3), generator=gen,
                          dtype=torch.uint8),
        action=torch.randn((n, 2), generator=gen),
        logp=torch.randn((n,), generator=gen) - 2.0,
        adv=torch.randn((n,), generator=gen),
        ret=torch.randn((n,), generator=gen))
    return net, p, batch


def _rel(a, b, scale):
    return float((a.double() - b.double()).norm()) / max(scale, 1e-30)


def _gaps(size, seed, fp8):
    """(mean, value, loss, worst leaf gradient) relative gaps of the
    reference (with the float8 control when ``fp8``) to the port."""
    net, p, batch = _setup(size, seed)
    mean, _, value = net(batch["obs"])
    loss, _ = ppo.ppo_loss(net, batch, ppo.PPOConfig())
    loss.backward()
    r_mean, _, r_value = impala.forward(p, batch["obs"], fp8)
    r_loss = impala.loss(p, batch["obs"], batch["action"], batch["logp"],
                         batch["adv"], batch["ret"], HP, fp8)
    r_grads = dict(zip(p, torch.autograd.grad(r_loss, list(p.values()))))
    grads = dict(net.named_parameters())
    norms = {k: float(g.double().norm()) for k, g in r_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    leaf = max(_rel(grads[impala.PROGRAM_NAMES[k]].grad, g,
                    max(norms[k], med)) for k, g in r_grads.items())
    mean, value, r_mean, r_value, loss, r_loss = (
        float(x) if x.dim() == 0 else x
        for x in (t.detach() for t in (mean, value, r_mean, r_value, loss,
                                       r_loss)))
    return (_rel(mean, r_mean, float(r_mean.norm())),
            _rel(value, r_value, float(r_value.norm())),
            abs(loss - r_loss) / abs(r_loss), leaf)


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_initial_parameters_equal(size, seed):
    net, p, _ = _setup(size, seed)
    got = dict(net.named_parameters())
    assert list(got) == list(impala.PROGRAM_NAMES.values())
    for k, v in p.items():
        assert torch.equal(got[impala.PROGRAM_NAMES[k]], v), k
    if size == 64:
        # the published network at 64x64x3: 622,917 parameters
        assert sum(v.numel() for v in got.values()) == 622_917


@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_loss_and_gradients_agree(size, seed):
    gaps = _gaps(size, seed, fp8=False)
    assert max(gaps) <= TOL, gaps


@pytest.mark.parametrize("size", [32, 64])
def test_float8_control_fails(size):
    gaps = _gaps(size, 0, fp8=True)
    assert max(gaps) > TOL, gaps
