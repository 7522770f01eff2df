"""Throughput probe: a chain of elementwise multiply-adds in float32 and in
bfloat16 (counterpart of scripts/bf16_probe.py, which asks whether the
render kernels' arithmetic would run faster in bf16).

``fma_chain(x, dtype, ops)`` runs ``ops`` steps a = a * v + 1e-3 (a starts
at v = x cast to ``dtype``) on every element and returns float32. A CUDA
tensor goes through csrc/fma_probe.cu, a CPU tensor through
``fma_chain_reference``, the plain torch loop with the same rounding.

    python -m dtown_torch.probes

times both types on the card at the reference probe's shape
[4096, 32, 128], 256 steps, and prints ms per iteration and the rate.
"""
from __future__ import annotations

import sys
import time

import torch

from dtown_torch import _build

SHAPE = (4096, 32, 128)   # the reference probe's grid x (S, L) block
OPS = 256
N_ITERS = 50


def fma_chain_reference(x, dtype, ops=OPS):
    """Plain torch version: the chain in ``dtype`` (each multiply and add
    rounded to it), returned as float32."""
    v = x.to(dtype)
    c = torch.tensor(1e-3, dtype=dtype, device=x.device)
    a = v
    for _ in range(ops):
        a = a * v + c
    return a.to(torch.float32)


_fma_chain = _build.kernel("fma_probe", "dtown_fma_chain", "PPqii",
                          "fma_chain")


def fma_chain(x, dtype, ops=OPS):
    """The multiply-add chain of float32 ``x`` in ``dtype`` (torch.float32
    or torch.bfloat16), float32 out, same shape. A CUDA tensor launches the
    kernel, a CPU tensor runs ``fma_chain_reference``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if x.dtype != torch.float32 or x.numel() % 2:
        raise ValueError(f"x must be float32 with an even number of "
                         f"elements, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fma_chain_reference(x, dtype, ops)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _fma_chain(x.data_ptr(), out.data_ptr(), x.numel(), ops,
               int(dtype == torch.bfloat16), x.device)
    return out


def run(dtype, x, n_iters=N_ITERS, ops=OPS):
    """The reference probe's loop on the card: n_iters launches, each
    feeding the next (x = chain(x) * (1 - 1e-7)), timed with CUDA events
    after a warm-up pass. Returns (ms per iteration, final x)."""
    def body(x):
        for _ in range(n_iters):
            x = fma_chain(x, dtype, ops) * (1.0 - 1e-7)
        return x

    x = body(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    x = body(x)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iters, x


def main():
    if not torch.cuda.is_available():
        print("probes: CUDA is not available", file=sys.stderr)
        return 1
    x0 = torch.full(SHAPE, 0.99, device="cuda")
    n = x0.numel()
    ms = {}
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.perf_counter()
        ms[dtype], _ = run(dtype, x0.clone())
        print(f"{str(dtype):15s}: {ms[dtype]:7.3f} ms/iter "
              f"({n * OPS * 2 / (ms[dtype] / 1e3) / 1e12:.2f} Tflop/s; "
              f"{time.perf_counter() - t0:.1f} s wall)", flush=True)
    print(f"bf16 speedup: {ms[torch.float32] / ms[torch.bfloat16]:.2f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
