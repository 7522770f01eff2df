"""dtown_torch's throughput probe (K5, dtown_torch/probes.py) vs the JAX
package's probe kernel (scripts/bf16_probe.py::make_kernel) under
pl.pallas_call(..., interpret=True) on [8, 32, 128], 256 steps of
a = a * v + 1e-3, in float32 and bfloat16.

The port's plain version rounds every multiply and add to the working
type, as the kernel on the card does. XLA's CPU backend does not, in two
ways that the tolerances below follow from (measured on seeded inputs in
[0.5, 1)):
  * float32: it contracts each a * v + c into one FMA; the results differ
    in the last bits (max |diff| 1.4e-5 after 256 steps), within 2e-5;
  * bfloat16: with excess precision allowed (XLA's default) it drops the
    rounding to bf16 between steps; max |diff| is one bf16 step of the
    values (0.001). With --xla_allow_excess_precision=false (a fresh
    process, since the flag is read when XLA starts) the bf16 chains agree
    bit for bit.
The CUDA kernel is held against the same plain version on the card, bit
for bit, by chip_smoke.py."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from dtown_torch import probes
from dtown_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ATOL, BF16_ATOL = 2e-5, 1e-3


def _probe_module():
    spec = importlib.util.spec_from_file_location(
        "bf16_probe", os.path.join(REPO, "scripts", "bf16_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(x, dtype):
    """dtown's probe kernel in interpret mode, one grid step per row."""
    m = _probe_module()
    spec = pl.BlockSpec((1, m.S, m.L), lambda g: (g, 0, 0))
    return np.asarray(pl.pallas_call(
        m.make_kernel(dtype),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        grid=(x.shape[0],), in_specs=[spec], out_specs=spec,
        interpret=True)(x))


def _inputs():
    return np.random.default_rng(0).uniform(
        0.5, 1.0, (8, 32, 128)).astype(np.float32)


@pytest.mark.parametrize("jdtype,tdtype,atol", [
    (jnp.float32, torch.float32, F32_ATOL),
    (jnp.bfloat16, torch.bfloat16, BF16_ATOL),
])
def test_probe_matches_pallas_interpret(jdtype, tdtype, atol):
    x = _inputs()
    ref = _reference(x, jdtype)
    ours = probes.fma_chain(torch.from_numpy(x), tdtype)
    assert ours.dtype == torch.float32 and ours.shape == x.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=atol)
    assert np.isfinite(ref).all() and ref.std() > 0


def test_probe_bf16_bit_equal_without_excess_precision(tmp_path):
    out = tmp_path / "ref.npy"
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np, jax.numpy as jnp\n"
        "import test_torch_probe as t\n"
        "np.save(%r, t._reference(t._inputs(), jnp.bfloat16))\n"
        % (os.path.dirname(os.path.abspath(__file__)), str(out)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=300, cwd=REPO)
    ours = probes.fma_chain(torch.from_numpy(_inputs()), torch.bfloat16)
    np.testing.assert_array_equal(ours.numpy(), np.load(out))


def test_probe_wrapper_checks_inputs():
    x = torch.full((4, 2), 0.99)
    profiling.reset_counters()
    for dtype in (torch.float32, torch.bfloat16):
        y = probes.fma_chain(x, dtype, ops=3)
        v = x.to(dtype)
        a = v
        for _ in range(3):
            a = a * v + torch.tensor(1e-3, dtype=dtype)
        assert torch.equal(y, a.float())
    with pytest.raises(ValueError):
        probes.fma_chain(x, torch.float16)
    with pytest.raises(ValueError):
        probes.fma_chain(x.double(), torch.float32)
    with pytest.raises(ValueError):
        probes.fma_chain(torch.ones(3), torch.float32)
    # CPU tensors: no kernel
    assert profiling.counters().get("launches.fma_chain", 0) == 0
